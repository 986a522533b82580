"""Mixture-of-Experts FFN: token-choice top-k routing with GShard-style
*group-local* capacity dispatch (groups = batch rows), scatter/gather based
so the (tokens, experts, capacity) dispatch tensor never materializes.

The port of ``repro/models/moe.py``.  It supports Mixtral (8 experts top-2,
softmax router with the Switch aux loss) and DeepSeek-V3's MoE FFN (routed
plus shared experts, sigmoid router with the aux-free bias, which moves
the selection only, and ``router_scale``).  What differs from the JAX
package:

- the sharding constraints become the collectives they imply
  (``parallel.sharding``): under a sharding_context whose rules put
  ``expert`` on the ``model`` axis, a rank holds E/M experts and
  dispatches only to them; where the axis does not divide the experts,
  the rules put ``expert_mlp`` on it and a rank runs every expert on its
  columns of the expert FFN (`expert_plan`).  The routing stays whole
  on every ``model`` rank (the tokens are whole there, and top-k needs
  every expert's score): the ``router`` leaf and ``router_bias`` are
  whole.  The dispatch input and the combine weights enter through
  ``copy_to_model`` (each rank sees only its experts' part of their
  gradient; the router's own input does not, its gradient is whole on
  every rank), and the partial sums of the routed and the shared
  experts are all-reduced once.  Where the rules also put ``expert`` on
  a batch axis (EP-2D: ``("model", "data")``), the data ranks hold
  different tokens and different experts: the dispatch buffer goes to
  the experts' holders by ``all_to_all`` over that axis and the expert
  outputs come back the same way.  The one batch-wide quantity the
  loss is not linear in, the Switch aux loss's dispatch fractions, goes
  through ``parallel.sharding.batch_mean`` (the global batch's mean
  under a sharded step; in serving, where each data group runs under its
  ``model`` sub-mesh, the group's own rows: no collective crosses data
  groups there);
- top-k takes the experts in a stable descending sort, so that equal
  scores keep the lower expert first, as ``jax.lax.top_k`` does
  (``torch.topk`` promises no order among ties);
- the run start of ``_positions_in_expert`` is a ``torch.cummax``, where
  the JAX package uses an associative max-scan;
- the expert indices are int64, the index type of torch's scatter and
  gather.

The expert products are batched matrix products (cuBLAS on the card): the
JAX package computes them with ``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import ParamSpec, linear, swiglu
from repro_torch.parallel.sharding import (MODEL_AXIS, all_to_all,
                                           axis_group, axis_sizes,
                                           batch_mean, copy_to_model,
                                           current_context, enter_model,
                                           leave_model, model_group,
                                           resolve_pspec, split_grad)


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    e = cfg.moe
    ne, ns, f = e.num_experts, e.num_shared_experts, e.expert_d_ff
    specs = {
        "router": ParamSpec((d, ne), ("embed", "expert"), "scaled",
                            dtype=torch.float32),
        "w_gate": ParamSpec((ne, d, f), ("expert", "expert_embed",
                                         "expert_mlp"), "scaled"),
        "w_up": ParamSpec((ne, d, f), ("expert", "expert_embed",
                                       "expert_mlp"), "scaled"),
        "w_down": ParamSpec((ne, f, d), ("expert", "expert_mlp",
                                         "expert_embed"), "scaled"),
    }
    if e.router_aux_free:
        specs["router_bias"] = ParamSpec((ne,), ("expert",), "zeros",
                                         dtype=torch.float32)
    if ns:
        specs["shared_gate"] = ParamSpec((d, ns * f), ("embed", "mlp"),
                                         "scaled")
        specs["shared_up"] = ParamSpec((d, ns * f), ("embed", "mlp"),
                                       "scaled")
        specs["shared_down"] = ParamSpec((ns * f, d), ("mlp", "embed"),
                                         "scaled")
    return specs


def _top_k(scores: torch.Tensor, k: int):
    """The k largest along the last axis, largest first, the lower index
    first among equal scores (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, x: torch.Tensor, e: MoEConfig, seq=None):
    """x: (B, S, D) -> weights (B,S,K) fp32, idx (B,S,K) int64, aux ().
    Under sequence parallelism (`seq`) `x` is the gathered sequence, and
    every rank's aux alike: its gradient counts once over the ranks."""
    # the router product in the activation dtype, softmax/sigmoid in fp32
    logits = linear(x, params["router"]).float()
    if e.router_aux_free:
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"][None, None, :]
        _, idx = _top_k(sel, e.top_k)
        w = torch.gather(scores, -1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        w = w * e.router_scale
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = _top_k(probs, e.top_k)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss (per group, then averaged), over
        # the whole batch: under a sharded step each rank holds a slice,
        # and `batch_mean` gives the global dispatch fractions; aux is
        # then linear in `me`, so the ranks' mean of their aux is the
        # global batch's
        me = (probs if seq is None else split_grad(probs, seq)).mean(
            dim=(0, 1))                                            # (E,)
        fe = batch_mean(F.one_hot(idx[..., 0], e.num_experts).float()
                        .mean(dim=(0, 1)))
        aux = e.num_experts * torch.sum(me * fe)
    return w, idx, aux


def _positions_in_expert(flat: torch.Tensor) -> torch.Tensor:
    """flat: (G, T) expert ids -> occurrence rank of each id at each slot.

    Stable-sort the ids; within the sorted order an id's occurrences are a
    contiguous run, so rank = index - run_start, where run_start carries
    forward by a running max.  Ranks scatter back through the sort
    permutation."""
    g, t = flat.shape
    order = torch.sort(flat, dim=1, stable=True).indices
    sorted_e = torch.gather(flat, 1, order)
    iota = torch.arange(t, device=flat.device).expand(g, t)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=1).values
    pos = torch.empty_like(flat)
    return pos.scatter_(1, order, (iota - run_start).to(flat.dtype))


@dataclasses.dataclass(frozen=True)
class ExpertPlan:
    """The experts a rank dispatches to: chunks ``first + j * stride`` for
    j < `count` of `n_local` experts each, in that order; `group`, where
    they are held along a batch axis (its rank j holds chunk j), or None;
    `over_model`, whether the model axis splits them."""
    n_local: int
    first: int
    stride: int
    count: int
    group: object
    over_model: bool

    @property
    def n(self) -> int:
        return self.count * self.n_local

    def local(self, ids: torch.Tensor) -> torch.Tensor:
        """Each expert id's slot among the rank's (-1 for another's),
        computed on the ids' device."""
        rel = torch.div(ids, self.n_local, rounding_mode="floor") - self.first
        j = torch.div(rel, self.stride, rounding_mode="floor")
        mine = (rel >= 0) & (rel % self.stride == 0) & (j < self.count)
        return torch.where(mine, j * self.n_local + ids % self.n_local, -1)


def expert_plan(n_local: int, num_experts: int):
    """The `ExpertPlan` of a rank holding `n_local` of `num_experts`
    experts under the current sharding context, or None where it holds
    them all.

    The rules' axes for ``expert`` deal the experts in chunks of
    `n_local`, in the mesh's order of those axes
    (``sharding.mesh_ordered``): a rank holds chunk sum(coordinate *
    stride).  Where they
    are only ``model``, a rank dispatches to its own chunk.  Where they
    hold a batch axis too (EP-2D), the ranks along that axis hold
    different tokens: a rank dispatches to the chunks of every rank of
    that axis that shares its other coordinates, in the axis' rank order
    (the layout `all_to_all` over the axis' group deals out).  A rank
    holding only its ``model`` shard of such a leaf dispatches as under
    ``model`` alone; serving runs each data group under its ``model``
    sub-mesh (``sharding.model_mesh``), where no batch axis is left."""
    if n_local == num_experts:
        return None
    ctx = current_context()
    if ctx is None or ctx.mesh is None:
        raise ValueError(f"{n_local} of {num_experts} experts outside a "
                         f"sharding context")
    mesh = ctx.mesh
    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    spec = resolve_pspec(("expert",), (num_experts,), mesh, ctx.rules)
    entry = spec[0] if spec else None
    axes = sorted((entry,) if isinstance(entry, str) else entry or (),
                  key=names.index)
    if math.prod(sizes[a] for a in axes) != num_experts // n_local:
        axes = [a for a in axes if a == MODEL_AXIS]
    if math.prod(sizes[a] for a in axes) != num_experts // n_local:
        raise ValueError(f"{n_local} of {num_experts} experts is no shard "
                         f"of the rules' {spec} on the mesh {sizes}")
    exchange = [a for a in axes if a != MODEL_AXIS]
    if len(exchange) > 1:
        raise NotImplementedError(f"experts over the batch axes {exchange}:"
                                  f" one at most")
    coord = dict(zip(names, mesh.get_coordinate()))
    first, strides = 0, {}
    for a in reversed(axes):
        strides[a] = math.prod(sizes[b] for b in axes[axes.index(a) + 1:])
        if a not in exchange:
            first += coord[a] * strides[a]
    if not exchange:
        return ExpertPlan(n_local, first, 1, 1, None, MODEL_AXIS in axes)
    return ExpertPlan(n_local, first, strides[exchange[0]],
                      sizes[exchange[0]], axis_group(exchange[0]),
                      MODEL_AXIS in axes)


def token_groups(n: int, k: int, num_experts: int) -> int:
    """The number of equal groups `moe_ffn` merges `n` tokens into where
    a row's own tokens would leave the capacity buffer mostly empty
    (``s * k < num_experts``): the largest divisor of `n` that gives
    groups of at least ``2 * num_experts / k`` tokens, or 1."""
    tpg = max(1, 2 * num_experts // k)          # tokens per group
    g = max(1, n // tpg)
    while n % g:
        g -= 1
    return g


def groups_nest(cfg: ModelConfig, batch: int, d: int) -> bool:
    """Whether `moe_ffn` over each of `d` equal slices of `batch` rows, as
    a data group of a split serving batch runs it, gives the numbers of
    the whole batch's call: true where every token group the whole batch
    forms lies inside one slice.  Rows merge into groups only at lengths
    ``s * k < num_experts``; at each, the whole batch's group count must
    divide by `d` (the slice's own groups are then the same ones, and so
    is their capacity).  True without MoE."""
    e = getattr(cfg, "moe", None)
    if e is None or d == 1:
        return True
    return all(token_groups(batch * s, e.top_k, e.num_experts) % d == 0
               for s in range(1, -(-e.num_experts // e.top_k)))


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            seq=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux_loss ()).  On the rank's local
    leaves under a sharding context (module doc, `expert_plan`).  Under
    sequence parallelism (`seq`) `x` is the gathered sequence, routed
    whole on every rank, and the output the rank's slice of the sum
    (``sharding.leave_model``)."""
    e = cfg.moe
    b0, s0, d = x.shape
    k, ne = e.top_k, e.num_experts

    w, idx, aux = _route(params, x, e, seq)

    plan = expert_plan(params["w_gate"].shape[-3], ne)
    group = None if plan is None else plan.group
    mg = model_group()
    routed_split = mg is not None and (
        (plan is not None and plan.over_model)
        or params["w_gate"].shape[-1] < e.expert_d_ff)
    shared_split = (mg is not None and e.num_shared_experts > 0 and
                    params["shared_gate"].shape[-1]
                    < e.num_shared_experts * e.expert_d_ff)
    x_split = enter_model(x, routed_split or shared_split, seq)
    if routed_split and seq is None:
        w = copy_to_model(w)

    # decode-time regrouping: with s*k << num_experts the per-row capacity
    # buffer is mostly empty, so rows merge into fewer, fuller groups
    # (about 2*ne dispatched slots per group) before capacity assignment
    b, s = b0, s0
    xr = x_split if routed_split else x
    if s0 * k < ne and b0 > 1:
        g = token_groups(b0 * s0, k, ne)
        b, s = g, b0 * s0 // g
        xr = xr.reshape(b, s, d)
        w = w.reshape(b, s, k)
        idx = idx.reshape(b, s, k)
    cap = max(1, int(e.capacity_factor * s * k / ne))

    # group-local position in expert; tokens past capacity, and tokens of
    # experts the rank does not dispatch to, go to the overflow slot
    # n*cap, which is dropped (n: the experts it dispatches to)
    flat = idx.reshape(b, s * k)
    pos = _positions_in_expert(flat)
    keep = pos < cap
    n = ne
    if plan is not None:
        n = plan.n
        flat = plan.local(flat)
        keep = keep & (flat >= 0)
    dst = torch.where(keep, flat * cap + pos, n * cap)
    wr = w.reshape(b, s * k).to(xr.dtype)

    # scatter each token's k copies into (B, n*C+1, D); a kept slot gets
    # exactly one token, so the sum is exact
    xe = xr.repeat_interleave(k, dim=1)                    # (B, S*K, D)
    buf = xr.new_zeros((b, n * cap + 1, d))
    buf.scatter_add_(1, dst[..., None].expand(-1, -1, d), xe)
    # experts lead for the batched products: (n, B*C, D)
    buf = buf[:, :-1].reshape(b, n, cap, d).transpose(0, 1).reshape(
        n, b * cap, d)
    if group is not None:
        # to the experts' holders: (G, n/G, B*C, D) -> (n/G, G*B*C, D)
        gs = group.size
        buf = all_to_all(buf, group.group).reshape(
            gs, n // gs, b * cap, d).transpose(0, 1).reshape(
            n // gs, gs * b * cap, d)

    # expert computation (SwiGLU), one batched product per matrix
    gt = torch.bmm(buf, params["w_gate"].to(xr.dtype))
    up = torch.bmm(buf, params["w_up"].to(xr.dtype))
    # silu in place on the fp32 copy: at a Mixtral prefill wave gt is 3 GB.
    # An fp32 gt is not copied, and stays as it is: remat="dots" keeps
    # the product itself for the backward pass
    g32 = gt.float()
    h = F.silu(g32, inplace=g32 is not gt).to(xr.dtype) * up
    y = torch.bmm(h, params["w_down"].to(xr.dtype))        # (n', B*C, D)
    if group is not None:
        gs = group.size
        y = all_to_all(y.reshape(n // gs, gs, b * cap, d).transpose(0, 1)
                       .reshape(n, b * cap, d), group.group)
    y = y.reshape(n, b, cap, d).transpose(0, 1).reshape(b, n * cap, d)

    # gather back and combine with the router weights
    dstc = torch.clamp(dst, max=n * cap - 1)
    gathered = torch.gather(y, 1, dstc[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0)
    combined = (gathered * wr[..., None]).reshape(b, s, k, d).sum(dim=2)
    parts = [(combined.reshape(b0, s0, d), routed_split)]
    if e.num_shared_experts:
        parts.append((swiglu(x_split if shared_split else x,
                             params["shared_gate"], params["shared_up"],
                             params["shared_down"]), shared_split))
    # the whole outputs in order, then the partial ones summed over the
    # model ranks in one all-reduce (or reduce-scatter)
    whole = [t for t, split in parts if not split]
    partial = [t for t, split in parts if split]
    out = leave_model(sum(whole[1:], whole[0]), False, seq) if whole else None
    if partial:
        summed = leave_model(sum(partial[1:], partial[0]), True, seq)
        out = summed if out is None else out + summed
    return out, aux


def router_load(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-expert token counts (for aux-free bias updates / telemetry)."""
    e = cfg.moe
    _, idx, _ = _route(params, x, e)
    return torch.bincount(idx.reshape(-1), minlength=e.num_experts)
