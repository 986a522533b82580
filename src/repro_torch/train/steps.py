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

``make_sharded_train_step`` is the port of the JAX package's
``jax.jit(step, in_shardings=(state, batch), donate_argnums=(0,))``
(``launch/dryrun.py``): the state lives as DTensors placed by the
logical-axis rules (``param_pspecs``; the AdamW moments take the params'
placements), each data rank takes its slice of the global batch by
``batch_specs``, and a step gathers each param over the batch axes only
(its ``model`` shard stays: tensor-parallel activations,
``models/transformer.py``), runs the same ``loss_and_grads`` on the
rank's slice and its ``model`` shard, reduce-scatters the fp32 gradients
over the batch axes back to the params' placements (their mean over
those axes) and runs AdamW on the local shards.  ``batch_specs`` and
``cache_specs`` give the meta-device shapes and PartitionSpecs of a
batch and a decode cache at a ``ShapeConfig``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import (ModelConfig, ParallelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.common import (cross_entropy_loss, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.models.model import Model
from repro_torch.models.ssm import (paired_columns, paired_split,
                                   unpaired_columns)
from repro_torch.models.transformer import seq_whole, tp_layouts
from repro_torch.optim.adamw import (OptState, adamw_init, adamw_leaf,
                                     adamw_update, step_scalars)
from repro_torch.optim.quant import (LogQTensor, QTensor, block_layout,
                                     fit_blocks, quantize, quantize_log)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel.sharding import (AxisRules, NamedSharding,
                                           batch_dims, from_local,
                                           local_index, local_slice,
                                           mesh_device, named_sharding,
                                           owned, placements, resolve_pspec,
                                           seq_group, shard_shape,
                                           shard_tensor, sharding_context)

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
    vocab = model.cfg.vocab_size
    loss = cross_entropy_loss(out["logits"], labels, z_loss=tcfg.z_loss,
                              vocab_size=vocab)
    total = loss + MOE_AUX_COEF * out["aux"]
    metrics = {"loss": loss, "aux": out["aux"]}
    if "mtp_logits" in out:
        # the MTP head predicts token t+2: labels rolled by one, the last
        # position (which would wrap to the first label) masked out
        mtp_labels = torch.roll(labels, -1, dims=1)
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
        mtp = cross_entropy_loss(out["mtp_logits"], mtp_labels, mask=mask,
                                 vocab_size=vocab)
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


def _accumulate(model: Model, params, batch, pcfg: ParallelConfig,
                tcfg: TrainConfig):
    """(metrics, grads) of `batch` in `pcfg.microbatches` parts: each
    part's gradients summed in fp32 buffers (as the JAX package's scan
    carries them: a bf16 leaf's grads are not summed in bf16), then the
    sums and the metrics divided by the count."""
    n = pcfg.microbatches
    if n == 1:
        return loss_and_grads(model, params, batch, tcfg)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    m_acc = None
    for i in range(n):
        mb = {k: t.reshape((n, t.shape[0] // n) + t.shape[1:])[i]
              for k, t in batch.items()}
        metrics, grads = loss_and_grads(model, params, mb, tcfg)
        for a, g in zip(g_acc, tree_leaves(grads)):
            a.add_(g.float())
        del grads
        m_acc = metrics if m_acc is None else {
            k: m_acc[k] + metrics[k] for k in m_acc}
    return ({k: v / n for k, v in m_acc.items()},
            tree_unflatten(params, [a / n for a in g_acc]))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(model: Model, pcfg: ParallelConfig, tcfg: TrainConfig):
    def train_step(state: TrainState, batch):
        metrics, grads = _accumulate(model, state.params, batch, pcfg, tcfg)
        with record_function("optimizer"):
            lr = warmup_cosine(state.opt_state.count, tcfg)
            new_params, new_opt, gnorm = adamw_update(
                grads, state.opt_state, state.params, lr, tcfg,
                state_dtype=pcfg.opt_state_dtype)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(new_params, new_opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def train_state_shardings(model: Model, mesh,
                          rules: Optional[AxisRules] = None,
                          opt_state_dtype: str = "float32") -> TrainState:
    """A TrainState-shaped tree of NamedSharding: each param's, from the
    rules, and the same for its AdamW moments; None for the step count
    (a plain tensor on every rank).  An int8 moment is a QTensor (m) or
    LogQTensor (v) of NamedShardings, its blocks laid out by
    ``quant.block_layout`` (their ``shape`` the layout's)."""
    rules = rules or AxisRules()
    sh = tree_map(lambda s: named_sharding(s.logical, s.shape, mesh, rules),
                  model.specs)
    if opt_state_dtype != "int8":
        return TrainState(sh, OptState(sh, sh, None))
    pairs = [(spec.shape, block_layout(spec.shape, mesh, ns.placements))
             for spec, ns in zip(tree_leaves(model.specs), tree_leaves(sh))]
    at = lambda lay, shape: NamedSharding(mesh, lay.placements, shape)
    m = [QTensor(at(lay, lay.data_shape), at(lay, lay.scale_shape), shape)
         for shape, lay in pairs]
    v = [LogQTensor(at(lay, lay.data_shape), at(lay, lay.scale_shape),
                    at(lay, lay.scale_shape), shape) for shape, lay in pairs]
    return TrainState(sh, OptState(tree_unflatten(model.specs, m),
                                   tree_unflatten(model.specs, v), None))


def shard_train_state(state: TrainState, shardings: TrainState) -> TrainState:
    """A whole TrainState (every rank holding the same one) as DTensors
    on `shardings`; each rank keeps its own slice, so nothing is sent (an
    int8 moment's blocks laid out first, ``quant.fit_blocks``)."""
    def place(x, sh):
        if sh is None:
            return x
        if sh.shape is not None:
            x = fit_blocks(x, sh.shape)
        return shard_tensor(x, sh.mesh, sh.placements)
    return tree_unflatten(state, [
        place(x, sh)
        for x, sh in zip(tree_leaves(state), tree_leaves(shardings))])


def init_sharded_train_state(model: Model, generator: torch.Generator,
                             pcfg: ParallelConfig, mesh,
                             rules: Optional[AxisRules] = None) -> TrainState:
    """What ``shard_train_state(init_train_state(...), shardings)`` gives,
    made shard by shard: each rank draws only its blocks of each param
    (``common.draw_leaf`` from the seeds ``init_train_state`` draws from
    `generator`) and zero moments of its shards' shapes, so a state no
    card holds whole can be set up.  No collective."""
    from repro_torch.models.common import draw_leaf, leaf_seed
    shardings = train_state_shardings(model, mesh, rules,
                                      pcfg.opt_state_dtype)
    dev = mesh_device(mesh)
    specs = tree_leaves(model.specs)
    places = [sh.placements for sh in tree_leaves(shardings.params)]
    local = [draw_leaf(spec, leaf_seed(generator), dev,
                       index=local_index(spec.shape, mesh, place))
             for spec, place in zip(specs, places)]
    wrap = lambda ts: tree_unflatten(model.specs, [
        from_local(t, mesh, place, spec.shape)
        for t, place, spec in zip(ts, places, specs)])
    if pcfg.opt_state_dtype == "int8":
        q = lambda tree: tree_map(lambda sh: zero_moment(sh, dev), tree,
                                  is_leaf=_is_q)
        return TrainState(wrap(local), OptState(
            q(shardings.opt_state.m), q(shardings.opt_state.v),
            torch.zeros((), dtype=torch.int32, device=dev)))
    opt = adamw_init(local, pcfg.opt_state_dtype)
    return TrainState(wrap(local), OptState(wrap(opt.m), wrap(opt.v),
                                            opt.count))


def _is_q(x) -> bool:
    return isinstance(x, (QTensor, LogQTensor))


def zero_moment(q_sh, device):
    """One rank's int8 moment of zero, as ``quantize``/``quantize_log``
    give it, on `q_sh` (a QTensor or LogQTensor of NamedShardings,
    `train_state_shardings`)."""
    shs = q_sh.tree_flatten()[0]
    local = [shard_shape(sh.shape, sh.mesh, sh.placements) for sh in shs]
    zero = torch.zeros(math.prod(local[0]), dtype=torch.float32,
                       device=device)
    q = (quantize if isinstance(q_sh, QTensor) else quantize_log)(zero)
    return type(q_sh).tree_unflatten(q_sh.shape, [
        from_local(t.reshape(shape), sh.mesh, sh.placements, sh.shape)
        for t, shape, sh in zip(q.tree_flatten()[0], local, shs)])


def gather_state(state):
    """The tree with every DTensor leaf gathered whole (a collective)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, state)


def make_sharded_train_step(model: Model, pcfg: ParallelConfig,
                            tcfg: TrainConfig, mesh,
                            rules: Optional[AxisRules] = None):
    """The train step over `mesh`: `step(state, batch)` takes a state of
    DTensors (``shard_train_state``) and the *global* batch (the same on
    every rank), and returns the state (updated in place, as
    ``make_train_step``'s) and metrics that every rank holds alike.

    Ranks that differ only in their ``model`` coordinate take the same
    batch slice and split its work: each runs the model on its leaves of
    ``transformer.tp_layouts`` (a "shard" leaf gathered over the batch
    axes only, a "whole" one, MoE's router, gathered whole, the SSM's
    ``w_in`` gathered whole and cut to the rank's channels, and a
    "held" one, an expert leaf whose ``expert`` dim the rules shard over
    a batch axis too (EP-2D), not gathered on that dim: the rank's
    experts take every data rank's tokens through ``moe``'s
    all-to-all), inside a ``sharding_context`` that issues the
    tensor-parallel collectives and takes batch-wide means over the
    global batch (``sharding.batch_mean``).  A "shard" leaf's gradient
    is the rank's shard and is reduce-scattered over the batch axes
    only; a "whole" leaf's is whole and alike on every ``model`` rank; a
    cut ``w_in``'s is put back in its columns of a zero leaf and summed
    over the ``model`` ranks too; a "held" leaf's arrives summed over
    every data rank's tokens by the all-to-all's backward, so it is the
    rank's shard on the batch axes that shard its experts (scaled by the
    same 1/ranks as the others) and partial on the rest.  The global
    gradient norm sums each leaf's squares over only the mesh dims that
    shard it, so a replicated leaf counts once.  At one rank, and over a
    ``model`` axis of 1, the step computes what ``make_train_step``
    computes, bit for bit.

    Where the rules put ``seq`` on the ``model`` axis at the batch's
    length (``sharding.seq_group``), the model runs sequence-parallel
    (``models/transformer.py``): the ranks of the ``model`` axis hold
    different slices of the residual, so a leaf whole on them (its
    ``model`` placement replicated, or a "whole" one), but for the
    encoder's, which runs on whole frames (``transformer.seq_whole``),
    has a partial gradient on each, summed over them.  The batch is cut
    over the batch axes only: the logits are the whole sequence's
    (``transformer.lm_logits``).

    int8 AdamW state (``pcfg.opt_state_dtype``) is the unsharded step's,
    block for block: its blocks run over the flattened whole leaf, laid
    out by ``quant.block_layout`` (`train_state_shardings`) and updated
    by `int8_adamw`; no rank holds the whole state of a leaf the rules
    cut.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    rules = rules or AxisRules()
    int8 = pcfg.opt_state_dtype == "int8"
    bdims = batch_dims(mesh, rules)
    n_batch = math.prod(mesh.size(m) for m in bdims)
    groups = {m: mesh.get_group(m) for m in range(mesh.ndim)
              if mesh.size(m) > 1}
    cfg = model.cfg
    names = list(mesh.mesh_dim_names)
    mdim = names.index("model") if "model" in names else None

    def held(spec) -> bool:
        """An expert leaf whose ``expert`` dim a batch axis shards."""
        if "expert" not in spec.logical:
            return False
        edim = spec.logical.index("expert")
        place = named_sharding(spec.logical, spec.shape, mesh,
                               rules).placements
        return any(place[m] == Shard(edim) for m in bdims)

    # per leaf: "whole", "shard", "held" or "cut" (a paired leaf the
    # rules split)
    kinds = ["cut" if lay == "paired" and paired_split(spec, mesh, rules)
             else "whole" if lay in ("whole", "paired")
             else "held" if held(spec) else "shard"
             for lay, spec in zip(tree_leaves(tp_layouts(model.specs, cfg)),
                                  tree_leaves(model.specs))]
    edims = [s.logical.index("expert") if k == "held" else None
             for s, k in zip(tree_leaves(model.specs), kinds)]
    # the leaves whole on the model ranks that read sequence slices
    whole_on_model = [
        not whole and mdim is not None and (kind == "whole" or (
            kind == "shard" and not isinstance(named_sharding(
                spec.logical, spec.shape, mesh, rules).placements[mdim],
                Shard)))
        for kind, whole, spec in zip(kinds, seq_whole(model.specs),
                                     tree_leaves(model.specs))]

    def kept(pl, m, edim) -> bool:
        """Whether the rank keeps its shard on mesh dim `m`: the model
        dim's, and a held leaf's expert dim's."""
        return m == mdim or (edim is not None and pl == Shard(edim))

    def model_leaf(p, kind, edim):
        """The rank's leaf of the DTensor `p` for the model (a
        collective)."""
        if kind in ("shard", "held"):
            keep = [pl if kept(pl, m, edim) else Replicate()
                    for m, pl in enumerate(p.placements)]
            return p.redistribute(mesh, keep).to_local()
        whole = p.full_tensor()
        if kind == "cut":
            return paired_columns(whole, mesh.size(mdim),
                                  mesh.get_local_rank("model"))
        return whole

    def grad_src(p, kind, edim, g, partial_on_model):
        """(the rank's gradient, its placements: partial sums over the
        batch dims but a held leaf's expert dims and, for a cut leaf or
        one `partial_on_model`, the model dim)."""
        if kind == "cut":
            g = unpaired_columns(g, p.shape[-1], mesh.size(mdim),
                                 mesh.get_local_rank("model"))
        on_model = {"cut": Partial(), "whole": Replicate()}.get(
            kind, None if mdim is None else p.placements[mdim])
        if partial_on_model:
            on_model = Partial()
        src = [p.placements[m] if m in bdims and kept(p.placements[m], m,
                                                       edim)
               else Partial() if m in bdims else on_model if m == mdim
               else Replicate() for m in range(mesh.ndim)]
        return g, src

    def local_batch(batch):
        """The rank's slice of each of the global batch's microbatches,
        laid end to end (so that `_accumulate`'s i-th part is the rank's
        slice of the global i-th microbatch, as under the JAX package's
        sharded scan)."""
        n = pcfg.microbatches
        b, s = batch["tokens"].shape
        shape = ShapeConfig("train", s + cfg.vision_tokens, b // n, "train")
        _, ps = batch_specs(cfg, shape, mesh, AxisRules(
            tuple(r for r in rules.rules if r[0] == "batch")))
        out = {}
        for k, t in batch.items():
            place = placements(ps[k], mesh)
            parts = [local_slice(mb, mesh, place)
                     for mb in t.reshape((n, b // n) + t.shape[1:])]
            out[k] = parts[0] if n == 1 else torch.cat(parts)
        return out

    def train_step(state: TrainState, batch):
        with torch.no_grad(), record_function("gather"):
            params = tree_unflatten(state.params, [
                model_leaf(p, k, e) for p, k, e in zip(
                    tree_leaves(state.params), kinds, edims)])
        # backward on this thread (not autograd's device thread): the
        # checkpointed layers' recomputation then sees the context too
        with sharding_context(mesh, rules), \
                torch.autograd.set_multithreading_enabled(False):
            sp = seq_group(batch["tokens"].shape[1]
                           + cfg.vision_tokens) is not None
            metrics, grads = _accumulate(model, params, local_batch(batch),
                                         pcfg, tcfg)
        del params
        shards = tree_leaves(state.params)
        grads = tree_leaves(grads)
        with torch.no_grad(), record_function("reduce"):
            local = []
            for i, p in enumerate(shards):
                g = grads[i].float()
                grads[i] = None            # one fp32 leaf at a time
                if n_batch > 1:
                    g = g / n_batch
                g, src = grad_src(p, kinds[i], edims[i], g,
                                  sp and whole_on_model[i])
                local.append(from_partial(g, mesh, src, p.placements))
                del g
            keys = sorted(metrics)
            mvec = torch.stack([metrics[k] for k in keys])
            for m in bdims:
                if m in groups:
                    dist.all_reduce(mvec, group=groups[m])
            if n_batch > 1:
                mvec = mvec / n_batch
            metrics = dict(zip(keys, mvec.unbind()))
            gnorm = None
            if tcfg.grad_clip:
                sq = torch.stack([g.square().sum() for g in local])
                for m, group in groups.items():
                    # decided on the host: a placement is no device value
                    flags = [isinstance(p.placements[m], Shard)
                             for p in shards]
                    if any(flags):
                        mask = torch.tensor(flags, device=sq.device)
                        part = torch.where(mask, sq, 0.0)
                        dist.all_reduce(part, group=group)
                        sq = torch.where(mask, part, sq)
                gnorm = torch.sqrt(sum(sq.unbind()))
        with record_function("optimizer"):
            lr = warmup_cosine(state.opt_state.count, tcfg)
            loc = lambda tree: tree_map(lambda t: t.to_local(), tree)
            if int8:
                count, gnorm = int8_adamw(local, state, lr, tcfg, gnorm)
            else:
                _, new_opt, gnorm = adamw_update(
                    tree_unflatten(state.params, local),
                    OptState(loc(state.opt_state.m), loc(state.opt_state.v),
                             state.opt_state.count),
                    loc(state.params), lr, tcfg,
                    state_dtype=pcfg.opt_state_dtype, gnorm=gnorm)
                count = new_opt.count
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(state.params, OptState(
            state.opt_state.m, state.opt_state.v, count)), metrics

    return train_step


@torch.no_grad()
def int8_adamw(grads: list, state: TrainState, lr: torch.Tensor,
               tcfg: TrainConfig, gnorm: Optional[torch.Tensor] = None):
    """AdamW on a sharded state's int8 moments (`train_state_shardings`):
    `grads` the rank's gradient shard of each param leaf (its placements'),
    `gnorm` their global norm.  Each param shard and each moment's blocks
    are written in place, with the numbers ``adamw_update`` gives the
    whole state (``quant.block_layout``: a rank whose shard is whole
    blocks updates them; another updates its chunk of the leaf's blocks
    from the leaf's gathered gradient and values, and the ranks' chunks
    of the updated values are gathered) -> (count, grad norm)."""
    k = step_scalars(state.opt_state.count, grads, lr, tcfg, gnorm)
    shards = tree_leaves(state.params)
    ms = tree_leaves(state.opt_state.m, is_leaf=_is_q)
    vs = tree_leaves(state.opt_state.v, is_leaf=_is_q)
    for g, p, m_q, v_q in zip(grads, shards, ms, vs):
        mesh = p.device_mesh
        lay = block_layout(p.shape, mesh, p.placements)
        held = [[t.to_local() for t in q.tree_flatten()[0]]
                for q in (m_q, v_q)]
        flat = [[t.reshape(-1, t.shape[-1]) for t in ts] for ts in held]
        as_q = lambda q, ts, shape: type(q).tree_unflatten(shape, ts)
        decay = len(p.shape) >= 2          # no decay on norms/biases
        if lay.cut is not None:
            # the rank's blocks: its shard, or the leaf's moved to `cut`
            moved = tuple(lay.cut) != tuple(p.placements)
            g_in = (from_local(g, mesh, p.placements, p.shape).redistribute(
                mesh, lay.cut).to_local() if moved else g)
            p_in = (p.redistribute(mesh, lay.cut).to_local() if moved
                    else p.to_local())
            shape = tuple(p_in.shape)
            new = adamw_leaf(g_in, as_q(m_q, flat[0], shape),
                             as_q(v_q, flat[1], shape), p_in, k, tcfg,
                             "int8", decay)
            if moved:
                p.to_local().copy_(from_local(p_in, mesh, lay.cut, p.shape)
                                   .redistribute(mesh, p.placements)
                                   .to_local())
        else:
            # the rank's chunk of the leaf's blocks, from the leaf's
            # whole gradient and values
            rows = local_index(lay.data_shape, mesh, lay.placements)[0]
            cut = lambda t: torch.nn.functional.pad(t.reshape(-1), (
                0, math.prod(lay.data_shape) - t.numel())).view(
                lay.data_shape)[rows].reshape(-1)
            chunk = cut(p.full_tensor()).clone()
            n = chunk.numel()
            new = adamw_leaf(
                cut(from_local(g, mesh, p.placements, p.shape).full_tensor()),
                as_q(m_q, flat[0], (n,)), as_q(v_q, flat[1], (n,)), chunk, k,
                tcfg, "int8", decay)
            whole = from_local(chunk.reshape(-1, lay.data_shape[-1]), mesh,
                               lay.placements, lay.data_shape).full_tensor()
            p.to_local().copy_(local_slice(
                whole.reshape(-1)[:p.numel()].reshape(p.shape), mesh,
                p.placements))
        for ts, q in zip(held, new):
            for t, fresh in zip(ts, q.tree_flatten()[0]):
                t.copy_(fresh.reshape(t.shape))
    return k.count, k.gnorm


def from_partial(g: torch.Tensor, mesh, src: list, dst) -> torch.Tensor:
    """This rank's shard, under placements `dst`, of the sum over the
    ``Partial`` mesh dims of `src` of every rank's whole `g` (a reduce-
    scatter where `dst` shards a summed dim, an all-reduce where it
    replicates it; a local slice on the replicated dims)."""
    from torch.distributed.tensor import DTensor
    return owned(DTensor.from_local(g, mesh, src, run_check=False)
                 .redistribute(mesh, list(dst)).to_local())


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


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors) + logical axes, per (arch x shape)
# ---------------------------------------------------------------------------

def batch_logical(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    """name -> ((shape), (logical axes), dtype) for the input batch."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {
            "tokens": ((b, 1), ("batch", None), torch.int32),
            "positions": ((b,), ("batch",), torch.int32),
        }
    st = s - cfg.vision_tokens
    out = {"tokens": ((b, st), ("batch", "seq"), torch.int32)}
    if shape.kind == "train":
        out["labels"] = ((b, st), ("batch", "seq"), torch.int32)
    if cfg.vision_tokens:
        out["patch_embeds"] = ((b, cfg.vision_tokens, cfg.vision_embed_dim),
                               ("batch", None, None), torch.bfloat16)
    if cfg.encoder_layers:
        out["frames"] = ((b, cfg.encoder_seq_len, cfg.d_model),
                         ("batch", None, "act_embed"), torch.bfloat16)
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: AxisRules):
    """(meta-tensor tree, PartitionSpec tree) for the batch."""
    logical = batch_logical(cfg, shape)
    meta = {k: torch.empty(sh, dtype=dt, device="meta")
            for k, (sh, lg, dt) in logical.items()}
    pspecs = {k: resolve_pspec(lg, sh, mesh, rules)
              for k, (sh, lg, dt) in logical.items()}
    return meta, pspecs


def _cache_leaf_dtype(path) -> torch.dtype:
    """Cache dtype by leaf name: pos -> int32, ssm state -> fp32, else bf16."""
    if path and path[-1] == "pos":
        return torch.int32
    if path and path[-1] == "ssm":
        return torch.float32
    return torch.bfloat16


def cache_specs(model: Model, shape: ShapeConfig, mesh, rules: AxisRules,
                spec=None):
    """(meta-tensor tree, PartitionSpec tree) for the decode cache at this
    shape (or of `spec`, a ``model.cache_spec`` tree).  A leaf of
    ``model.cache_spec`` is a ((shape), (logical axes)) pair; its path's
    last key names its dtype."""
    def is_leaf(x):
        return (isinstance(x, tuple) and len(x) == 2
                and isinstance(x[0], tuple)
                and all(isinstance(i, int) for i in x[0]))

    def walk(tree, path, fn):
        if is_leaf(tree):
            return fn(path, tree)
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,), fn) for k, v in tree.items()}
        return type(tree)(walk(v, path + (i,), fn)
                          for i, v in enumerate(tree))

    if spec is None:
        spec = model.cache_spec(shape.global_batch, shape.seq_len)
    meta = walk(spec, (), lambda path, leaf: torch.empty(
        leaf[0], dtype=_cache_leaf_dtype(path), device="meta"))
    ps = walk(spec, (), lambda path, leaf: resolve_pspec(
        leaf[1], leaf[0], mesh, rules))
    return meta, ps
