"""Gradient compression for the low-bandwidth (inter-pod) reduction.

The port of ``repro/optim/compression.py``.  Error-feedback int8
allreduce (1-bit-Adam / EF-SGD family): each pod quantizes (grad +
residual) to blockwise int8 (``optim.quant``), exchanges the int8 payload
and its fp32 scales with an ``all_gather_into_tensor`` over the ``pod``
axis's group (8x fewer wire bytes than an fp32 ring all-reduce at pod
count 2), dequantizes and averages locally, and keeps the quantization
error as the residual for the next step — unbiased in the long run,
bounded staleness.

Where the JAX package runs this in ``shard_map``, manual over the pod
axis only, the port runs it on each rank over the mesh's ``pod`` group;
the leaves are the rank's plain tensors (its gradients, already reduced
over the data axis).  As in the JAX package, no train step calls it
(``TrainConfig.grad_compression`` is read nowhere).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.quant import dequantize, quantize


def _compress_leaf(g: torch.Tensor, residual: torch.Tensor, group,
                   block: int = 256):
    gf = g.float() + residual
    q = quantize(gf, block)
    new_residual = gf - dequantize(q)
    p = dist.get_world_size(group)
    # exchange int8 payload + scales across the pod axis, gathered end to
    # end along the block dim: (P * nb, blk) and (P * nb, 1)
    nb = q.data.shape[0]
    data_all = q.data.new_empty((p * nb,) + tuple(q.data.shape[1:]))
    scale_all = q.scale.new_empty((p * nb,) + tuple(q.scale.shape[1:]))
    dist.all_gather_into_tensor(data_all, q.data, group=group)
    dist.all_gather_into_tensor(scale_all, q.scale, group=group)
    summed = torch.sum((data_all.float() * scale_all).reshape(
        (p,) + tuple(q.data.shape)), dim=0) / p
    n = 1
    for s in q.shape:
        n *= s
    mean_g = summed.reshape(-1)[:n].reshape(q.shape)
    return mean_g.to(g.dtype), new_residual


def compressed_pod_mean(grads, residuals, mesh, axis: str = "pod",
                        block: int = 256):
    """Tree-wise EF-int8 mean over `axis`. grads already reduced over data
    (per-pod view); residuals: same-shape fp32 tree (carried in TrainState).
    Returns (mean_grads, new_residuals)."""
    if axis not in mesh.mesh_dim_names:
        return grads, residuals
    group = mesh.get_group(axis)
    out = [_compress_leaf(g, r, group, block) for g, r in
           zip(tree_leaves(grads), tree_leaves(residuals))]
    return (tree_unflatten(grads, [g for g, _ in out]),
            tree_unflatten(residuals, [r for _, r in out]))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
