"""CUDA kernel for the fused KMeans assignment, built and bound at first use.

Replaces the Pallas TPU kernel ``repro/kernels/kmeans/kmeans.py::
kmeans_assign``.  The source is ``csrc/kmeans.cu`` (its header note gives
the design and the bound on an H100).  ``nvcc`` compiles it for
``sm_90a`` into a shared library with a plain C interface under the
repository's ``build/kernels/`` the first time a CUDA tensor reaches
`kmeans_assign` (``kernels/_nvcc.py``); the library is loaded with
``ctypes``.  Nothing is compiled or imported at module import, so the CPU
tests import this module freely.

`LAUNCHES` counts the wrapper's kernel launches (one per call, which runs
the assign, accumulate and finalize kernels on the caller's stream).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans.cu"

# wrapper launches; read by chip_smoke.py to show the main path ran here
LAUNCHES = 0
_count_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    lib.kmeans_assign_workspace_bytes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.kmeans_assign_workspace_bytes.restype = ctypes.c_size_t
    lib.kmeans_assign_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.kmeans_assign_launch.restype = ctypes.c_int
    lib.kmeans_error_string.argtypes = [ctypes.c_int]
    lib.kmeans_error_string.restype = ctypes.c_char_p


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
    ws = torch.empty(lib.kmeans_assign_workspace_bytes(n, k, d),
                     dtype=torch.uint8, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    sse = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kmeans_assign_launch(
            points.data_ptr(), centroids.data_ptr(), n, k, d,
            int(points.dtype == torch.bfloat16), ws.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), sse.data_ptr(), stream)
    if err != 0:
        msg = lib.kmeans_error_string(err).decode()
        raise RuntimeError(f"kmeans_assign: launch failed with CUDA error "
                           f"{err} ({msg})")
    with _count_lock:
        LAUNCHES += 1
    return sums, counts, sse
