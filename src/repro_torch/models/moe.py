"""Mixture-of-Experts FFN: token-choice top-k routing with GShard-style
*group-local* capacity dispatch (groups = batch rows), scatter/gather based
so the (tokens, experts, capacity) dispatch tensor never materializes.

The port of ``repro/models/moe.py``.  It supports Mixtral (8 experts top-2,
softmax router with the Switch aux loss) and DeepSeek-V3's MoE FFN (routed
plus shared experts, sigmoid router with the aux-free bias, which moves
the selection only, and ``router_scale``).  What differs from the JAX
package:

- the sharding constraints are gone: the MoE FFN runs whole on every
  ``model`` rank (the sharded step gathers its params whole, the
  serving engine keeps them whole; expert parallelism over the axis is
  not ported), so its output is whole and adds no collective; the one
  batch-wide quantity the loss is not linear in, the Switch aux loss's
  dispatch fractions, goes through ``parallel.sharding.batch_mean`` (the
  global batch's mean under a sharded step);
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

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import ParamSpec, linear, swiglu
from repro_torch.parallel.sharding import batch_mean


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


def _route(params, x: torch.Tensor, e: MoEConfig):
    """x: (B, S, D) -> weights (B,S,K) fp32, idx (B,S,K) int64, aux ()."""
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
        me = probs.mean(dim=(0, 1))                                # (E,)
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


def moe_ffn(params, x: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux_loss ())."""
    e = cfg.moe
    b0, s0, d = x.shape
    k, ne = e.top_k, e.num_experts

    w, idx, aux = _route(params, x, e)

    # decode-time regrouping: with s*k << num_experts the per-row capacity
    # buffer is mostly empty, so rows merge into fewer, fuller groups
    # (about 2*ne dispatched slots per group) before capacity assignment
    b, s = b0, s0
    if s0 * k < ne and b0 > 1:
        tpg = max(1, 2 * ne // k)               # tokens per group
        g = max(1, (b0 * s0) // tpg)
        while (b0 * s0) % g:
            g -= 1
        b, s = g, b0 * s0 // g
        x = x.reshape(b, s, d)
        w = w.reshape(b, s, k)
        idx = idx.reshape(b, s, k)
    cap = max(1, int(e.capacity_factor * s * k / ne))

    # group-local position in expert; tokens past capacity go to the
    # overflow slot ne*cap, which is dropped
    flat = idx.reshape(b, s * k)
    pos = _positions_in_expert(flat)
    keep = pos < cap
    dst = torch.where(keep, flat * cap + pos, ne * cap)
    wr = w.reshape(b, s * k).to(x.dtype)

    # scatter each token's k copies into (B, E*C+1, D); a kept slot gets
    # exactly one token, so the sum is exact
    xe = x.repeat_interleave(k, dim=1)                     # (B, S*K, D)
    buf = x.new_zeros((b, ne * cap + 1, d))
    buf.scatter_add_(1, dst[..., None].expand(-1, -1, d), xe)
    # experts lead for the batched products: (E, B*C, D)
    buf = buf[:, :-1].reshape(b, ne, cap, d).transpose(0, 1).reshape(
        ne, b * cap, d)

    # expert computation (SwiGLU), one batched product per matrix
    gt = torch.bmm(buf, params["w_gate"].to(x.dtype))
    up = torch.bmm(buf, params["w_up"].to(x.dtype))
    # silu in place on the fp32 copy: at a Mixtral prefill wave gt is 3 GB.
    # An fp32 gt is not copied, and stays as it is: remat="dots" keeps
    # the product itself for the backward pass
    g32 = gt.float()
    h = F.silu(g32, inplace=g32 is not gt).to(x.dtype) * up
    y = torch.bmm(h, params["w_down"].to(x.dtype))         # (E, B*C, D)
    y = y.reshape(ne, b, cap, d).transpose(0, 1).reshape(b, ne * cap, d)

    # gather back and combine with the router weights
    dstc = torch.clamp(dst, max=ne * cap - 1)
    gathered = torch.gather(y, 1, dstc[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0)
    combined = (gathered * wr[..., None]).reshape(b, s, k, d).sum(dim=2)
    combined = combined.reshape(b0, s0, d)
    x = x.reshape(b0, s0, d)

    if e.num_shared_experts:
        combined = combined + swiglu(x, params["shared_gate"],
                                     params["shared_up"],
                                     params["shared_down"])
    return combined, aux


def router_load(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-expert token counts (for aux-free bias updates / telemetry)."""
    e = cfg.moe
    _, idx, _ = _route(params, x, e)
    return torch.bincount(idx.reshape(-1), minlength=e.num_experts)
