"""Dispatch for the KMeans assignment: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (kmeans.py), a CPU tensor runs the plain PyTorch
version (ref.py).  ``impl="cuda"`` on a CPU tensor raises.  There is no
fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kmeans.kmeans import kmeans_assign
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref

IMPLS = ("auto", "cuda", "ref")


def kmeans_assign_op(points: torch.Tensor, centroids: torch.Tensor,
                     impl: str = "auto"):
    """points (N,D), centroids (K,D) -> (sums (K,D), counts (K,), sse ()).

    impl: auto | cuda | ref"""
    if impl not in IMPLS:
        raise ValueError(f"kmeans_assign_op: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    if impl == "auto":
        kind = points.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"kmeans_assign_op: no implementation for "
                             f"device {points.device}")
        impl = "cuda" if kind == "cuda" else "ref"
    if impl == "ref":
        return kmeans_assign_ref(points, centroids)
    return kmeans_assign(points, centroids)
