"""AdamW with a configurable state dtype.

The port of ``repro/optim/adamw.py``.  State dtypes: float32 (default),
bfloat16, or int8 (blockwise-quantized m, log-domain v, 8-bit-Adam style).
All math runs in fp32 regardless of storage dtype, with the JAX package's
arithmetic: a global-norm clip, the bias corrections from ``count``, and
weight decay on every leaf with ``ndim >= 2``, which includes the stacked
``(L, d)`` norm weights of a layer stack (a quirk of the reference, kept).

`adamw_update` runs under ``torch.no_grad()`` and updates in place: each
parameter leaf, and the fp32 and bf16 moments, are written where they lie
(int8 moments are requantized into new QTensors), so a step needs no
second copy of the state.  The results are the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.quant import (LogQTensor, QTensor, dequantize,
                                     dequantize_log, quantize, quantize_log)

STATE_DTYPES = ("float32", "bfloat16", "int8")


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor       # int32 0-d, steps taken


def _is_q(x) -> bool:
    return isinstance(x, (QTensor, LogQTensor))


def _store(x: torch.Tensor, dtype: str, second_moment: bool = False):
    if dtype == "int8":
        # m: signed symmetric int8; v: log-domain uint8 (v spans many orders
        # of magnitude inside one block -- linear int8 zeroes small entries
        # and explodes 1/sqrt(v); log-domain bounds the multiplicative error)
        return quantize_log(x) if second_moment else quantize(x)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


def _load(x) -> torch.Tensor:
    """The moment in fp32: a new tensor, but for an fp32 moment, which is
    returned itself (and so updated in place by the caller)."""
    if isinstance(x, LogQTensor):
        return dequantize_log(x)
    if isinstance(x, QTensor):
        return dequantize(x)
    return x.float()


def adamw_init(params, state_dtype: str = "float32") -> OptState:
    if state_dtype not in STATE_DTYPES:
        raise ValueError(f"adamw_init: state_dtype must be one of "
                         f"{STATE_DTYPES}, got {state_dtype!r}")
    zero = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return OptState(
        m=tree_map(lambda p: _store(zero(p), state_dtype), params),
        v=tree_map(lambda p: _store(zero(p), state_dtype, True), params),
        count=torch.zeros((), dtype=torch.int32, device=device))


def _moment(old, new: torch.Tensor, dtype: str, second_moment: bool):
    """`new` (fp32) stored as the state's `dtype`, into `old` where it is a
    dense tensor."""
    if dtype == "int8":
        return _store(new, dtype, second_moment)
    if new is not old:
        old.copy_(new)
    return old


class StepScalars(NamedTuple):
    """What every leaf's update of one step shares."""
    count: torch.Tensor       # the steps taken after this one
    c1: torch.Tensor          # the bias corrections
    c2: torch.Tensor
    scale: torch.Tensor       # the global-norm clip
    gnorm: torch.Tensor
    lr: torch.Tensor


def step_scalars(count: torch.Tensor, flat_g, lr: torch.Tensor,
                 cfg: TrainConfig,
                 gnorm: torch.Tensor | None = None) -> StepScalars:
    """The step's `StepScalars` from the state's `count` and the gradient
    leaves `flat_g` (their norm, where `gnorm` is not given)."""
    count = count + 1
    c1 = 1.0 - cfg.beta1 ** count.float()
    c2 = 1.0 - cfg.beta2 ** count.float()
    # global-norm clip (fp32)
    if cfg.grad_clip:
        if gnorm is None:
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in flat_g))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=count.device)
        scale = torch.ones((), dtype=torch.float32, device=count.device)
    return StepScalars(count, c1, c2, scale, gnorm, lr)


@torch.no_grad()
def adamw_leaf(g: torch.Tensor, m_q, v_q, p: torch.Tensor, k: StepScalars,
               cfg: TrainConfig, state_dtype: str, decay: bool):
    """One leaf's AdamW update: `p` written in place, weight-decayed where
    `decay`; -> its new (m, v) in the state's dtype (the fp32 and bf16
    moments written in place too)."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * k.scale
    m = _load(m_q).mul_(b1).add_(g * (1 - b1))
    v = _load(v_q).mul_(b2).add_(g.square().mul_(1 - b2))
    new = (_moment(m_q, m, state_dtype, False),
           _moment(v_q, v, state_dtype, True))
    del g
    step = (m / k.c1).div_((v / k.c2).sqrt_().add_(1e-8))
    if cfg.weight_decay and decay:
        step = step.add_(cfg.weight_decay * p.float())
    p.copy_(p.float().sub_(k.lr * step))
    return new


@torch.no_grad()
def adamw_update(grads, opt_state: OptState, params, lr: torch.Tensor,
                 cfg: TrainConfig, state_dtype: str = "float32",
                 gnorm: torch.Tensor | None = None):
    """One AdamW step.  `grads` and `params` are trees of one structure,
    `lr` an fp32 0-d tensor (``warmup_cosine``).  `gnorm` is the global
    gradient norm where the caller holds only shards of the leaves (a
    sharded step), else it is computed here.  Returns (params, OptState,
    grad_norm): the same param tensors, updated in place."""
    flat_g = tree_leaves(grads)
    flat_p = tree_leaves(params)
    flat_m = tree_leaves(opt_state.m, is_leaf=_is_q)
    flat_v = tree_leaves(opt_state.v, is_leaf=_is_q)
    if not len(flat_g) == len(flat_p) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: grads, params and the state's "
                         "moments must be trees of one structure")
    k = step_scalars(opt_state.count, flat_g, lr, cfg, gnorm)
    new_m, new_v = [], []
    for g, m_q, v_q, p in zip(flat_g, flat_m, flat_v, flat_p):
        # no decay on norms/biases
        m, v = adamw_leaf(g, m_q, v_q, p, k, cfg, state_dtype, p.ndim >= 2)
        new_m.append(m)
        new_v.append(v)
    return params, OptState(tree_unflatten(params, new_m),
                            tree_unflatten(params, new_v), k.count), k.gnorm
