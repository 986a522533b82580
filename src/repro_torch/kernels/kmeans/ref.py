"""Plain PyTorch version of the KMeans assignment/partial-sum kernel.

Transcribed from repro/kernels/kmeans/ref.py: the matmul form of the
squared distance, first-index argmin, fp32 accumulation.  It is what
``ops.kmeans_assign_op`` runs for a tensor on the CPU, and what the CUDA
kernel is held against on the card.
"""
from __future__ import annotations

import torch


def kmeans_assign_ref(points: torch.Tensor, centroids: torch.Tensor):
    """points (N,D), centroids (K,D) -> (sums (K,D), counts (K,), sse ()).

    Matmul form of squared distance; fp32 accumulation.
    """
    x = points.to(torch.float32)
    c = centroids.to(torch.float32)
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)[None, :]
    d2 = x2 - 2.0 * (x @ c.T) + c2
    idx = torch.argmin(d2, dim=1)
    one_hot = torch.nn.functional.one_hot(idx, c.shape[0]).to(torch.float32)
    sums = one_hot.T @ x
    counts = one_hot.sum(dim=0)
    sse = torch.sum(torch.take_along_dim(d2, idx[:, None], dim=1))
    return sums, counts, sse
