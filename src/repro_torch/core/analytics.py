"""KMeans on Pilot-Data Memory — the paper's §4.3 validation workload.

Each iteration is one map_reduce over the points DU:
  map(points_partition, centroids) -> (partial_sums (K,D), counts (K), sse)
  reduce = elementwise add
The centroids update on the driver (paper: 'the centroids vector changes
each iteration'), while the points DU stays wherever its tier keeps it —
file tier re-reads every iteration (paper's file backend), device tier
keeps points in HBM across iterations (paper's Spark backend, the 212x).

The assignment map is the compute hot-spot; `assign_partial` dispatches
to repro_torch.kernels.kmeans: the hand-written CUDA kernel for a tensor
on the card, its plain PyTorch version for a tensor on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.data import DataUnit
from repro_torch.core.device import to_device
from repro_torch.core.manager import ComputeDataManager
from repro_torch.core.mapreduce import map_reduce
from repro_torch.core.pilot import PilotCompute
from repro_torch.kernels.kmeans.ops import kmeans_assign_op

# the paper's three scenarios: (points, clusters) with constant points*k
PAPER_SCENARIOS = {
    "i": (1_000_000, 50),
    "ii": (100_000, 500),
    "iii": (10_000, 5_000),
}


def assign_partial(points: torch.Tensor, centroids: torch.Tensor):
    """Map phase: nearest-centroid assignment + partial centroid sums.

    points (N,D), centroids (K,D) -> (sums (K,D), counts (K,), sse ()).
    Uses the |x-c|^2 = |x|^2 - 2 x.c + |c|^2 form, computed by the fused
    kmeans_assign kernel (dispatched on the points' device).  The
    centroids follow the points onto their device (a (K,D) copy).
    """
    return kmeans_assign_op(points, centroids.to(points.device))


def _reduce(a, b):
    return tuple(u + v for u, v in zip(a, b))


@dataclasses.dataclass
class KMeansResult:
    centroids: np.ndarray
    sse_history: list
    iter_seconds: list
    total_seconds: float
    tier: str


def kmeans(du: DataUnit, k: int, iters: int = 5,
           manager: Optional[ComputeDataManager] = None,
           pilot: Optional[PilotCompute] = None,
           map_fn: Callable = assign_partial,
           seed: int = 0, prefetch_depth: Optional[int] = None,
           pipeline: bool = True) -> KMeansResult:
    """Lloyd's algorithm over a (possibly tiered) points DataUnit.

    prefetch_depth/pipeline tune the pipelined map_reduce engine (None =
    adaptive depth from measured stage/compute times); use pipeline=False
    for the sequential i+1-prefetch baseline."""
    d = int(np.asarray(du.partition(0)).shape[1])
    # the centroids go to the device of the DU's device tier once per
    # iteration (one small copy), not once per partition
    dev = getattr(du.backends.get("device"), "device", None)
    rng = np.random.default_rng(seed)
    centroids = rng.normal(size=(k, d)).astype(np.float32)
    sse_hist, iter_secs = [], []
    t_start = time.time()
    for _ in range(iters):
        t0 = time.time()
        cent_dev = (torch.from_numpy(centroids) if dev is None
                    else to_device(centroids, dev))
        sums, counts, sse = map_reduce(du, map_fn, _reduce, manager=manager,
                                       pilot=pilot, extra_args=(cent_dev,),
                                       prefetch_depth=prefetch_depth,
                                       pipeline=pipeline)
        sums, counts, sse = (t.cpu().numpy() for t in (sums, counts, sse))
        nonempty = counts > 0
        centroids = centroids.copy()
        centroids[nonempty] = sums[nonempty] / counts[nonempty, None]
        sse_hist.append(float(sse))
        iter_secs.append(time.time() - t0)
    return KMeansResult(centroids=centroids, sse_history=sse_hist,
                        iter_seconds=iter_secs,
                        total_seconds=time.time() - t_start, tier=du.tier)


def make_blobs(n: int, k: int, d: int = 8, seed: int = 0,
               spread: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic clustered data (the experiments' input generator)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return pts.astype(np.float32), labels
