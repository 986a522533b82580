"""Pipeline parallelism: GPipe-style microbatch pipeline over a "pipe" axis.

The port of ``repro/parallel/pipeline.py``.  Each rank of the mesh's
``pipe`` axis is one stage and holds L/P layers (its slice of the stacked
layer params); activations move stage to stage.  The schedule is the JAX
package's: M + P - 1 ticks for M microbatches (fill + steady state +
drain); at tick t stage 0 injects microbatch t, stage s works while
s <= t < s + M, and the last stage records microbatch t - (P - 1).  The
bubble fraction (P-1)/(M+P-1) is reported by ``bubble_fraction`` so
configs can pick M.

Where the JAX package shifts activations with ``jax.lax.ppermute`` inside
``shard_map``, each rank here sends its output to the next stage and
receives the previous stage's in one ``batch_isend_irecv`` (a ring, so no
rank waits on a send before its receive is posted); at the end the last
stage's outputs are broadcast over the pipe group, as the reference's
masked ``psum`` replicates them.  A stage skips ``layer_fn`` on the ticks
outside its window, whose results the reference computes and discards.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_map


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def pipeline_forward(layer_fn: Callable, stage_params, x_micro: torch.Tensor,
                     mesh, axis: str = "pipe") -> torch.Tensor:
    """Run a microbatched pipeline forward on every rank of `mesh`.

    layer_fn(params_slice, x) -> x : applies ONE STAGE (its layer block).
    stage_params: tree whose leaves have leading dim = num_stages (whole
    tensors, or DTensors sharded on that dim over `axis`); each rank
    takes its own stage's slice.
    x_micro: (M, mb, ...) microbatched input, the same on every rank.
    Returns (M, mb, ...) outputs (as produced by the last stage), on every
    rank.
    """
    from torch.distributed.tensor import DTensor
    group = mesh.get_group(axis)
    p = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    m = x_micro.shape[0]
    params = tree_map(lambda t: t.to_local()[0] if isinstance(t, DTensor)
                      else t[sid], stage_params)
    nxt = dist.get_global_rank(group, (sid + 1) % p)
    prv = dist.get_global_rank(group, (sid - 1) % p)
    buf = torch.zeros_like(x_micro[0])               # current activation
    outs = torch.zeros_like(x_micro)
    for t in range(m + p - 1):
        if sid <= t < sid + m:       # valid window: s <= t < s + m
            y = layer_fn(params, x_micro[t] if sid == 0 else buf)
        else:
            y = buf
        if sid == p - 1 and t >= p - 1:  # the last stage records
            outs[t - (p - 1)] = y
        if p > 1:                        # shift to the next stage
            nbuf = torch.empty_like(buf)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, group=group),
                    dist.P2POp(dist.irecv, nbuf, prv, group=group)]):
                req.wait()
            buf = nbuf
        else:
            buf = y
    dist.broadcast(outs, src=dist.get_global_rank(group, p - 1), group=group)
    return outs
