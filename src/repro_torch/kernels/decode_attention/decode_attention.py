"""CUDA kernel for single-token decode attention, built and bound at first
use.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/
decode_attention.py::decode_attention``.  The source is
``csrc/decode_attention.cu`` (its header note gives the design and the
bound on an H100): split-KV flash-decoding, a split pass and a combine
pass, no atomics.  ``nvcc`` compiles it for ``sm_90a`` into a shared
library under the repository's ``build/kernels/`` the first time a CUDA
tensor reaches `decode_attention` (``kernels/_nvcc.py``); the library is
loaded with ``ctypes``.  Nothing is compiled at module import.

`LAUNCHES` counts the wrapper's kernel launches (one per call, which runs
the split and combine kernels on the caller's stream).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
TILE = 64            # cache slots per shared-memory tile (kTile in the source)
MAX_HEAD_DIM = 256
# split target: blocks per SM (4 was the fastest of 2, 4, 8 and 16 at the
# serving shape on an H100)
BLOCKS_PER_SM = 4
MAX_SMEM_BYTES = 227 * 1024

# wrapper launches; read by chip_smoke.py to show the main path ran here
LAUNCHES = 0
_count_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.decode_attention_smem_bytes.restype = ctypes.c_size_t
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_void_p] * 4)
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p


def build() -> Path:
    """Compile csrc/decode_attention.cu (once per source and flags) and
    return the library's path."""
    return _nvcc.build(SOURCE, "decode_attention")


def load() -> ctypes.CDLL:
    """Build if needed and bind the C entry points (idempotent)."""
    return _nvcc.load(SOURCE, "decode_attention", _bind)


def plan(b: int, nkv: int, sc: int, num_sms: int) -> Tuple[int, int]:
    """(slots per split, splits): enough splits that B*Nkv*splits is about
    BLOCKS_PER_SM blocks per SM, each split a whole number of tiles."""
    tiles = -(-sc // TILE)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * num_sms // (b * nkv))))
    chunk = -(-tiles // want) * TILE
    return chunk, -(-sc // chunk)


def _check(q, k_cache, v_cache, cache_pos, positions) -> None:
    named = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
             ("cache_pos", cache_pos), ("positions", positions))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention: {name} must be a CUDA "
                             f"tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in named[1:3]:
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {t.dtype}, q "
                            f"{q.dtype}")
    for name, t in named[3:]:
        if t.dtype != torch.int32:
            raise TypeError(f"decode_attention: {name} must be int32, got "
                            f"{t.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: need q (B,Nq,H) and k/v "
                         f"(B,Sc,Nkv,H), got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    b, nq, h = q.shape
    _, sc, nkv, hk = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b or hk != h
            or nkv < 1 or nq % nkv):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)} "
                         f"do not fit (need Nq a multiple of Nkv)")
    if tuple(cache_pos.shape) != (b, sc) or tuple(positions.shape) != (b,):
        raise ValueError(f"decode_attention: cache_pos "
                         f"{tuple(cache_pos.shape)} / positions "
                         f"{tuple(positions.shape)}, need ({b},{sc}) / "
                         f"({b},)")
    if not 1 <= h <= MAX_HEAD_DIM or sc < 1 or b < 1:
        raise ValueError(f"decode_attention: need 1 <= H <= {MAX_HEAD_DIM}, "
                         f"Sc >= 1, B >= 1; got H={h}, Sc={sc}, B={b}")
    if b * nq * h >= 2 ** 31 or sc >= 2 ** 31 // max(1, nkv * h):
        raise ValueError("decode_attention: sizes must fit a 32-bit int")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor,
                     positions: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q (B,Nq,H); k/v_cache (B,Sc,Nkv,H); cache_pos (B,Sc) int32;
    positions (B,) int32; all contiguous on one CUDA device, q/k/v of one
    dtype (float32 or bfloat16) -> (B,Nq,H) in q's dtype."""
    global LAUNCHES
    _check(q, k_cache, v_cache, cache_pos, positions)
    lib = load()
    b, nq, h = q.shape
    sc, nkv = k_cache.shape[1], k_cache.shape[2]
    smem = lib.decode_attention_smem_bytes(nq // nkv, h)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: G={nq // nkv} query heads per "
                         f"kv head at H={h} need {smem} bytes of shared "
                         f"memory, more than a block can have")
    dev = q.device
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, nsplit = plan(b, nkv, sc, num_sms)
    part_ml = torch.empty((b * nq, nsplit, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((b * nq, nsplit, h), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_pos.data_ptr(), positions.data_ptr(), b, sc, nq, nkv, h,
            int(window), chunk, int(q.dtype == torch.bfloat16), h ** -0.5,
            part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention: launch failed with CUDA "
                           f"error {err} ({msg})")
    with _count_lock:
        LAUNCHES += 1
    return out
