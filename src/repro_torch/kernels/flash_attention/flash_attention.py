"""CUDA kernels for causal / sliding-window GQA self-attention (forward),
built and bound at first use.

Replace the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention``.  The route follows the dtype:
- bfloat16 (every model path) runs on the tensor cores:
  ``csrc/flash_attention_sm90.cu``, wgmma for Q.K^T and P.V, K/V tiles in
  a cp.async ring, online softmax on the accumulator registers;
- float32 runs on the CUDA cores: ``csrc/flash_attention.cu``, fp32
  throughout (TF32 would break the fp32 tolerance of 2e-5).
Neither is a fallback for the other: a failed build or launch of either
raises.  Each source's header note gives its design and bound on an H100.
``nvcc`` compiles each for ``sm_90a`` into a shared library under the
repository's ``build/kernels/`` the first time a CUDA tensor of its dtype
reaches `flash_attention` (``kernels/_nvcc.py``); the libraries are loaded
with ``ctypes``.  Nothing is compiled at module import.

`TC_LAUNCHES` counts the tensor-core kernel's launches and `LAUNCHES` the
CUDA-core kernel's (one per call, on the route taken).
"""
from __future__ import annotations

import ctypes
import sys
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc, count_launch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"            # fp32, CUDA cores
TC_SOURCE = CSRC / "flash_attention_sm90.cu"    # bf16, tensor cores
MAX_HEAD_DIM = 128

# wrapper launches per route; read by chip_smoke.py to show the main path
# ran here
LAUNCHES = 0
TC_LAUNCHES = 0
_count_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_void_p] * 2)
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _bind_tc(lib: ctypes.CDLL) -> None:
    lib.flash_attention_tc_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_void_p] * 2)
    lib.flash_attention_tc_launch.restype = ctypes.c_int
    lib.flash_attention_tc_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_tc_error_string.restype = ctypes.c_char_p


def build() -> Path:
    """Compile csrc/flash_attention.cu (once per source and flags) and
    return the library's path."""
    return _nvcc.build(SOURCE, "flash_attention")


def build_tc() -> Path:
    """Compile csrc/flash_attention_sm90.cu likewise."""
    return _nvcc.build(TC_SOURCE, "flash_attention_sm90")


def load() -> ctypes.CDLL:
    """Build if needed and bind the CUDA-core kernel (idempotent)."""
    return _nvcc.load(SOURCE, "flash_attention", _bind)


def load_tc() -> ctypes.CDLL:
    """Build if needed and bind the tensor-core kernel (idempotent)."""
    return _nvcc.load(TC_SOURCE, "flash_attention_sm90", _bind_tc)


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
    sits at position i and kv row j at position j.  bfloat16 runs on the
    tensor cores, float32 on the CUDA cores."""
    _check(q, k, v)
    tc = q.dtype == torch.bfloat16
    lib = load_tc() if tc else load()
    launch = lib.flash_attention_tc_launch if tc else lib.flash_attention_launch
    b, sq, nq, h = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, skv, nq,
                     nkv, h, int(causal), int(window), h ** -0.5,
                     out.data_ptr(), stream)
    if err != 0:
        errstr = (lib.flash_attention_tc_error_string if tc
                  else lib.flash_attention_error_string)
        raise RuntimeError(f"flash_attention: launch failed with CUDA error "
                           f"{err} ({errstr(err).decode()})")
    count_launch(sys.modules[__name__], "TC_LAUNCHES" if tc else "LAUNCHES")
    return out
