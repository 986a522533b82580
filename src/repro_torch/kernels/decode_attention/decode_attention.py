"""CUDA kernel for single-token decode attention, built and bound at first
use.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/
decode_attention.py::decode_attention``.  The source is
``csrc/decode_attention.cu`` (its header note gives the design and the
bound on an H100): one launch per call, a thread block cluster per (batch
row, kv head, group of up to 8 query heads) whose blocks split the cache
and merge through distributed shared memory; K/V copies in flight in a
per-warp cp.async ring; cache tiles with no valid slot never read; no
atomics.  bf16 runs its two products on the tensor cores (mma.sync), fp32
on the CUDA cores.  ``nvcc`` compiles it for ``sm_90a`` into a shared
library under the repository's ``build/kernels/`` the first time a CUDA
tensor reaches `decode_attention` (``kernels/_nvcc.py``); the library is
loaded with ``ctypes``.  Nothing is compiled at module import.

`LAUNCHES` counts the wrapper's kernel launches (one per call); of them,
`TC_LAUNCHES` ran the bf16 tensor-core route and `CORE_LAUNCHES` the fp32
CUDA-core route.
"""
from __future__ import annotations

import ctypes
import sys
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _nvcc, count_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
TILE = 64            # cache slots per block tile (kTile in the source)
HEADS = 8            # query heads per block (kHeads)
MAX_HEAD_DIM = 256
PORTABLE_CLUSTER = 8  # blocks per cluster any launch may have
MAX_CLUSTER = 16      # with the non-portable opt-in (kMaxCluster)
# split target: blocks per SM, and the copy ring's depth (both the fastest
# at the serving shapes on an H100: tools/plan_sweep.py)
BLOCKS_PER_SM = 2
STAGES = 2
MAX_SMEM_BYTES = 227 * 1024

# wrapper launches, all and per route; read by chip_smoke.py to show the
# main path ran here
LAUNCHES = 0
TC_LAUNCHES = 0
CORE_LAUNCHES = 0
_count_lock = threading.Lock()
_num_sms: Dict[int, int] = {}


def _bind(lib: ctypes.CDLL) -> None:
    lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_smem_bytes.restype = ctypes.c_size_t
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_void_p] * 2)
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


def plan(b: int, nkv: int, g: int, sc: int,
         num_sms: int) -> Tuple[int, int, int]:
    """(splits, tiles per split, ring stages).  The splits of one (batch
    row, kv head, head group) form one cluster, so at most
    PORTABLE_CLUSTER, or MAX_CLUSTER when even that many per group leave
    SMs idle (a long row of a small batch); enough of them that all blocks
    are about BLOCKS_PER_SM per SM, rounded to a count that divides the
    tiles where one is near.  Split i
    takes the 64-slot tiles i, i + splits, ...; each warp's copy ring
    holds STAGES quarters, fewer when it has fewer."""
    tiles = -(-sc // TILE)
    groups = b * nkv * -(-g // HEADS)
    cap = (MAX_CLUSTER if groups * PORTABLE_CLUSTER < num_sms
           else PORTABLE_CLUSTER)
    want = max(1, min(cap, tiles, -(-BLOCKS_PER_SM * num_sms // groups)))
    # a split count that divides the tiles, where one lies within 2x of
    # the target: every block of a cluster then walks as many tiles, and
    # the cluster waits for no straggler
    even = [n for n in range(1, min(cap, tiles) + 1)
            if tiles % n == 0 and want <= 2 * n and n <= 2 * want]
    nsplit = min(even, key=lambda n: (abs(n - want), -n)) if even else want
    per = -(-tiles // nsplit)
    stages = min(per, STAGES)
    return nsplit, per, stages


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _num_sms.get(idx)
    if n is None:
        n = _num_sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


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
    if b * nkv > 65535 or -(-(nq // nkv) // HEADS) > 65535:
        raise ValueError("decode_attention: B*Nkv and the head groups must "
                         "be <= 65535 (the grid's z and y)")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor,
                     positions: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q (B,Nq,H); k/v_cache (B,Sc,Nkv,H); cache_pos (B,Sc) int32;
    positions (B,) int32; all contiguous on one CUDA device, q/k/v of one
    dtype (float32 or bfloat16) -> (B,Nq,H) in q's dtype."""
    _check(q, k_cache, v_cache, cache_pos, positions)
    lib = load()
    b, nq, h = q.shape
    sc, nkv = k_cache.shape[1], k_cache.shape[2]
    tc = q.dtype == torch.bfloat16
    nsplit, _, stages = plan(b, nkv, nq // nkv, sc, _sm_count(q.device))
    smem = lib.decode_attention_smem_bytes(h, int(tc), stages)
    while smem > MAX_SMEM_BYTES and stages > 1:      # fp32 at large H
        stages -= 1
        smem = lib.decode_attention_smem_bytes(h, int(tc), stages)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: H={h} with a {stages}-stage "
                         f"ring needs {smem} bytes of shared memory, more "
                         f"than a block can have")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_pos.data_ptr(), positions.data_ptr(), b, sc, nq, nkv, h,
            int(window), nsplit, stages, int(tc), h ** -0.5, out.data_ptr(),
            stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention: launch failed with CUDA "
                           f"error {err} ({msg})")
    count_launch(sys.modules[__name__], "LAUNCHES",
                 "TC_LAUNCHES" if tc else "CORE_LAUNCHES")
    return out
