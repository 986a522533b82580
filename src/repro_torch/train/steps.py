"""Train / prefill / decode step builders.

The port of ``repro/train/steps.py``.  ``make_train_step`` returns a
function over a TrainState (a named tuple of trees of tensors): autograd
takes the place of ``jax.value_and_grad``, and microbatching (gradient
accumulation) is a loop whose fp32 buffers sum each microbatch's
gradients, so activation memory scales with the microbatch, not the
global batch.  The step donates its state, as the JAX package's jitted
step does with ``donate_argnums``: AdamW writes the params and moments in
place.  Each part of a step runs in a ``torch.profiler.record_function``
range ("forward", "backward", "optimizer"), which a profiler trace splits
the step's time by.

``batch_specs`` and ``cache_specs`` are not ported: they exist to build a
mesh's shardings, which the port does not have yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.common import (cross_entropy_loss, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.optim.schedules import warmup_cosine

MOE_AUX_COEF = 0.01
MTP_COEF = 0.3


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def compute_loss(model: Model, params, batch, tcfg: TrainConfig):
    """-> (total loss, metrics {"loss", "aux", ["mtp_loss"],
    "total_loss"}), fp32 0-d tensors."""
    out = model.train_forward(params, batch)
    labels = batch["labels"]
    loss = cross_entropy_loss(out["logits"], labels, z_loss=tcfg.z_loss)
    total = loss + MOE_AUX_COEF * out["aux"]
    metrics = {"loss": loss, "aux": out["aux"]}
    if "mtp_logits" in out:
        # the MTP head predicts token t+2: labels rolled by one, the last
        # position (which would wrap to the first label) masked out
        mtp_labels = torch.roll(labels, -1, dims=1)
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
        mtp = cross_entropy_loss(out["mtp_logits"], mtp_labels, mask=mask)
        total = total + MTP_COEF * mtp
        metrics["mtp_loss"] = mtp
    metrics["total_loss"] = total
    return total, metrics


def loss_and_grads(model: Model, params, batch, tcfg: TrainConfig):
    """-> (metrics, grads): `compute_loss` and the gradient of its total
    with respect to every param leaf (a tree shaped as `params`; zeros for
    a leaf the loss does not reach, as ``jax.grad`` gives).  Grad mode is
    enabled here: it is thread-local, and a step may run on a pilot's
    worker thread."""
    with torch.enable_grad():
        tp = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tp)
        with record_function("forward"):
            total, metrics = compute_loss(model, tp, batch, tcfg)
        with record_function("backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_unflatten(params, grads)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(model: Model, pcfg: ParallelConfig, tcfg: TrainConfig):
    def train_step(state: TrainState, batch):
        if pcfg.microbatches > 1:
            n = pcfg.microbatches
            # fp32 sums, as the JAX package's scan carries them: a bf16
            # leaf's grads are not summed in bf16
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(state.params)]
            m_acc = None
            for i in range(n):
                mb = {k: t.reshape((n, t.shape[0] // n) + t.shape[1:])[i]
                      for k, t in batch.items()}
                metrics, grads = loss_and_grads(model, state.params, mb,
                                                tcfg)
                for a, g in zip(g_acc, tree_leaves(grads)):
                    a.add_(g.float())
                del grads
                m_acc = metrics if m_acc is None else {
                    k: m_acc[k] + metrics[k] for k in m_acc}
            grads = tree_unflatten(state.params, [a / n for a in g_acc])
            metrics = {k: v / n for k, v in m_acc.items()}
        else:
            metrics, grads = loss_and_grads(model, state.params, batch, tcfg)

        with record_function("optimizer"):
            lr = warmup_cosine(state.opt_state.count, tcfg)
            new_params, new_opt, gnorm = adamw_update(
                grads, state.opt_state, state.params, lr, tcfg,
                state_dtype=pcfg.opt_state_dtype)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(new_params, new_opt), metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator,
                     pcfg: ParallelConfig,
                     device: DeviceLike = None) -> TrainState:
    """Params drawn from `generator` (which lives on `device`) and zero
    AdamW moments of ``pcfg.opt_state_dtype``."""
    params = model.init(generator, device=resolve_device(device))
    return TrainState(params, adamw_init(params, pcfg.opt_state_dtype))


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens, positions):
        return model.decode(params, cache, tokens, positions)
    return decode_step
