"""Dispatch for the KMeans assignment: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (kmeans.py), a CPU tensor runs the plain PyTorch
version (ref.py).  ``impl="cuda"`` on a CPU tensor raises.  There is no
fallback from a failed build or launch to the plain version.  A fake or
meta tensor (a plan: ``launch.dryrun``) gets empty outputs of the
kernel's shapes, and the kernel's FLOPs and bytes are charged to the
active ``roofline.op_cost.OpCost`` as one op.  The op is forward-only: it
raises on an argument that requires grad while grad mode is on
(``kernels.refuse_autograd``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import is_abstract, refuse_autograd
from repro_torch.kernels.kmeans.kmeans import kmeans_assign
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref
from repro_torch.roofline.analysis import kmeans_cost
from repro_torch.roofline.op_cost import record_kernel

IMPLS = ("auto", "cuda", "ref")


def _planned(points, centroids):
    """Empty outputs, and the kernel's work charged to the counter."""
    n, d = points.shape
    k = centroids.shape[0]
    flops, nbytes, _ = kmeans_cost(n, k, d, points.element_size())
    record_kernel("kmeans_assign", flops, nbytes)
    f32 = dict(dtype=torch.float32)
    return (points.new_empty((k, d), **f32), points.new_empty((k,), **f32),
            points.new_empty((), **f32))


def kmeans_assign_op(points: torch.Tensor, centroids: torch.Tensor,
                     impl: str = "auto"):
    """points (N,D), centroids (K,D) -> (sums (K,D), counts (K,), sse ()).

    impl: auto | cuda | ref"""
    refuse_autograd("kmeans_assign_op", points, centroids)
    if impl not in IMPLS:
        raise ValueError(f"kmeans_assign_op: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    if impl == "auto":
        kind = points.device.type
        if kind == "cuda":
            impl = "cuda"
        elif is_abstract(points):
            return _planned(points, centroids)
        elif kind == "cpu":
            impl = "ref"
        else:
            raise ValueError(f"kmeans_assign_op: no implementation for "
                             f"device {points.device}")
    if impl == "ref":
        return kmeans_assign_ref(points, centroids)
    return kmeans_assign(points, centroids)
