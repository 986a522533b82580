"""CUDA kernel for the fused KMeans assignment, built and bound at first use.

Replaces the Pallas TPU kernel ``repro/kernels/kmeans/kmeans.py::
kmeans_assign``.  The source is ``csrc/kmeans.cu`` (its header note gives
the design and the bound on an H100): one launch per call, which assigns
the points, accumulates each block's partial sums and reduces the
partials in a fixed order, with no floating-point atomics.  ``nvcc``
compiles it for ``sm_90a`` into a shared library with a plain C interface
under the repository's ``build/kernels/`` the first time a CUDA tensor
reaches `kmeans_assign` (``kernels/_nvcc.py``); the library is loaded
with ``ctypes``.  Nothing is compiled or imported at module import, so
the CPU tests import this module freely.

`LAUNCHES` counts the wrapper's kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans.cu"
TILE = 256           # threads per block = points per tile (kThreads)
WARPS = 8            # warps per block (kWarps)
SMEM_FLOATS = 56 * 1024          # a block's shared memory (kSmemFloats)
FIXED_FLOATS = 8 * TILE + WARPS  # its merge buffers and warp sums
# the persistent grid, all resident: one block per SM, two where the
# 256-point tiles give each two and two blocks' shared memory fit an SM
BLOCKS_PER_SM = 2    # at most
TWO_PER_SM_FLOATS = 28 * 1024
MIN_CHUNK = 64       # centroids per K-chunk, at least

# wrapper launches; read by chip_smoke.py to show the main path ran here
LAUNCHES = 0
_count_lock = threading.Lock()
_num_sms: Dict[int, int] = {}
# two zeroed barrier counters per (device, stream): launches on one stream
# never overlap, and each leaves them at 0
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _bind(lib: ctypes.CDLL) -> None:
    lib.kmeans_assign_workspace_floats.argtypes = [ctypes.c_int] * 6
    lib.kmeans_assign_workspace_floats.restype = ctypes.c_longlong
    lib.kmeans_assign_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 6)
    lib.kmeans_assign_launch.restype = ctypes.c_int
    lib.kmeans_error_string.argtypes = [ctypes.c_int]
    lib.kmeans_error_string.restype = ctypes.c_char_p


def plan(n: int, k: int, d: int,
         num_sms: int) -> Tuple[int, int, int, int, int, int, int]:
    """(mode, sub, rows, nkc, kchunk, rstep, grid) of one launch (kmeans.cu).

    sub: WARPS when the 256-point rows cannot give every SM one (the rows
    are then 32 points and the warps split the chunk), else 1.  grid: one
    block per SM (two where sub is 1 and two blocks fit an SM's shared
    memory), no more than the work items.  rows: the rows of a tile, one
    point of each per thread; 2 at D 4 or 8 with sub 1 where the tiles of
    two rows leave the busiest block at most ~1/10 more points than tiles
    of one, else 1.  mode 0 (block partials) where K*(D+1) fits a block's
    shared memory beside the centroids and the partials (one per warp when
    sub is 1): K is not split.  Else mode 1 (by points): K in nkc chunks
    of kchunk centroids that fit shared memory, and more chunks when the
    tiles alone cannot fill the grid; the grid is then a multiple of nkc,
    so a block keeps one chunk; the final scan takes rstep of a block's
    centroids per pass."""
    target = num_sms
    sub = WARPS if -(-n // TILE) < target else 1
    tp = TILE // sub
    vlen = k * (d + 1) + 1
    smem = k * (d + 1) + FIXED_FLOATS + (WARPS if sub == 1 else 1) * vlen
    if smem <= SMEM_FLOATS:
        if sub == 1 and smem <= TWO_PER_SM_FLOATS:
            target = BLOCKS_PER_SM * num_sms
        rows = 1
        if sub == 1 and d in (4, 8):
            busiest = [-(-(-(-n // (r * tp))) // target) * r * tp
                       for r in (1, 2)]
            rows = 2 if 10 * busiest[1] <= 11 * busiest[0] else 1
        tiles = -(-n // (rows * tp))
        return 0, sub, rows, 1, k, 0, max(1, min(target, tiles))
    tiles = -(-n // tp)
    cap = (SMEM_FLOATS - FIXED_FLOATS) // (d + 1)   # centroids a chunk holds
    nkc = max(-(-k // cap),
              min(max(1, target // max(tiles, 1)), -(-k // MIN_CHUNK)))
    kchunk = -(-k // nkc)
    nkc = -(-k // kchunk)                           # no empty chunk
    grid = max(1, min(target, tiles * nkc))
    if nkc <= grid:
        grid -= grid % nkc
    kr = -(-k // grid)
    rstep = max(1, min(kr, SMEM_FLOATS // (WARPS * (d + 1))))
    return 1, sub, 1, nkc, kchunk, rstep, grid


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _num_sms.get(idx)
    if n is None:
        n = _num_sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def _counter(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _counters.get(key)
    if t is None:
        t = _counters[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return t


def build() -> Path:
    """Compile csrc/kmeans.cu (once per source and flags) and return the
    library's path (kernels/_nvcc.py)."""
    return _nvcc.build(SOURCE, "kmeans")


def load() -> ctypes.CDLL:
    """Build if needed and bind the C entry points (idempotent)."""
    return _nvcc.load(SOURCE, "kmeans", _bind)


def _check(points: torch.Tensor, centroids: torch.Tensor) -> None:
    for name, t in (("points", points), ("centroids", centroids)):
        if t.device.type != "cuda":
            raise ValueError(f"kmeans_assign: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"kmeans_assign: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"kmeans_assign: {name} must be a contiguous "
                             f"2-D tensor, got shape {tuple(t.shape)}")
    if centroids.device != points.device:
        raise ValueError(f"kmeans_assign: centroids on {centroids.device}, "
                         f"points on {points.device}")
    if centroids.dtype != points.dtype:
        raise TypeError(f"kmeans_assign: centroids are {centroids.dtype}, "
                        f"points {points.dtype}")
    if points.shape[1] != centroids.shape[1]:
        raise ValueError(f"kmeans_assign: points D={points.shape[1]} but "
                         f"centroids D={centroids.shape[1]}")
    if centroids.shape[0] < 1 or not 1 <= points.shape[1] <= 4096:
        raise ValueError(f"kmeans_assign: need K >= 1 and 1 <= D <= 4096, "
                         f"got K={centroids.shape[0]}, D={points.shape[1]}")
    if points.shape[0] >= 2 ** 31:
        raise ValueError("kmeans_assign: N must fit in a 32-bit int")


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor):
    """points (N,D), centroids (K,D) on one CUDA device, both float32 or
    both bfloat16 -> (sums (K,D), counts (K,), sse ()) in float32."""
    global LAUNCHES
    _check(points, centroids)
    lib = load()
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    mode, sub, rows, nkc, kchunk, rstep, grid = plan(n, k, d,
                                                     _sm_count(dev))
    ws = torch.empty(lib.kmeans_assign_workspace_floats(n, k, d, mode, nkc,
                                                        grid),
                     dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    sse = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kmeans_assign_launch(
            points.data_ptr(), centroids.data_ptr(), n, k, d,
            int(points.dtype == torch.bfloat16), mode, sub, rows, nkc,
            kchunk, rstep, grid, ws.data_ptr(),
            _counter(dev, stream).data_ptr(),
            sums.data_ptr(), counts.data_ptr(), sse.data_ptr(), stream)
    if err != 0:
        msg = lib.kmeans_error_string(err).decode()
        raise RuntimeError(f"kmeans_assign: launch failed with CUDA error "
                           f"{err} ({msg})")
    with _count_lock:
        LAUNCHES += 1
    return sums, counts, sse
