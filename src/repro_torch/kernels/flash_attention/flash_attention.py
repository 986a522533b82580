"""CUDA kernel for causal / sliding-window GQA self-attention (forward),
built and bound at first use.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention``.  The source is
``csrc/flash_attention.cu`` (its header note gives the design and the
bound on an H100): one block per (64-row query tile, query head, batch
row), K/V tiles through shared memory, online softmax in fp32, the KV loop
bounded to the tiles the causal and window band reaches.  ``nvcc``
compiles it for ``sm_90a`` into a shared library under the repository's
``build/kernels/`` the first time a CUDA tensor reaches `flash_attention`
(``kernels/_nvcc.py``); the library is loaded with ``ctypes``.  Nothing is
compiled at module import.

`LAUNCHES` counts the wrapper's kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128

# wrapper launches; read by chip_smoke.py to show the main path ran here
LAUNCHES = 0
_count_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_void_p] * 2)
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def build() -> Path:
    """Compile csrc/flash_attention.cu (once per source and flags) and
    return the library's path."""
    return _nvcc.build(SOURCE, "flash_attention")


def load() -> ctypes.CDLL:
    """Build if needed and bind the C entry points (idempotent)."""
    return _nvcc.load(SOURCE, "flash_attention", _bind)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q "
                            f"{q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q (B,Sq,Nq,H) and k, v "
                         f"(B,Skv,Nkv,H), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, nq, h = q.shape
    bk, skv, nkv, hk = k.shape
    if bk != b or hk != h or nkv < 1 or nq % nkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not fit (need one B and H, "
                         f"Nq a multiple of Nkv)")
    if not (1 <= h <= MAX_HEAD_DIM and sq >= 1 and skv >= 1 and b >= 1):
        raise ValueError(f"flash_attention: need 1 <= H <= {MAX_HEAD_DIM} "
                         f"and B, Sq, Skv >= 1; got H={h}, B={b}, Sq={sq}, "
                         f"Skv={skv}")
    if b > 65535 or nq > 65535 or max(sq, skv) >= 2 ** 31:
        raise ValueError("flash_attention: B and Nq must be <= 65535 (the "
                         "grid's z and y) and Sq, Skv below 2**31")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Sq,Nq,H); k, v (B,Skv,Nkv,H), contiguous on one CUDA device,
    all float32 or all bfloat16 -> (B,Sq,Nq,H) in q's dtype.  Query row i
    sits at position i and kv row j at position j."""
    global LAUNCHES
    _check(q, k, v)
    lib = load()
    b, sq, nq, h = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, skv, nq, nkv, h,
            int(causal), int(window), int(q.dtype == torch.bfloat16),
            h ** -0.5, out.data_ptr(), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention: launch failed with CUDA error "
                           f"{err} ({msg})")
    with _count_lock:
        LAUNCHES += 1
    return out
