"""Parameter-spec machinery + shared layer math (norms, RoPE, FFN).

The port of ``repro/models/common.py``.  Models are plain functions on
tensors: ``*_specs(cfg)`` returns a nested dict of ParamSpec (shape +
logical axes + initializer + dtype); ``init_params`` materializes it on a
device from an explicit ``torch.Generator``; ``abstract_params`` gives
meta-device tensors of the same shapes and dtypes (the JAX package's
``ShapeDtypeStruct`` tree) and ``param_pspecs`` the PartitionSpec of each
leaf on a mesh.  The math keeps the JAX package's casts: fp32 inside the
norm, RoPE and the activation, then back to the activation dtype.
Under a sharding_context whose ``model`` axis is more than one rank the
models run on each rank's ``model`` shard of the params, Megatron-style
(``parallel.sharding``'s `copy_to_model` and `reduce_from_model`): a
block whose weights are split there (the local width below the config's)
enters through `copy_to_model` and leaves through `reduce_from_model`,
as `dense_ffn` with ``split``; a block whose weights are whole on every
rank (heads that do not divide the axis) computes the whole
output and issues no collective.  Where the rules put ``seq`` on that
axis (sequence parallelism, ``models/transformer.py``) a block takes the
gathered sequence and gives the rank's sequence slice of its output
(``sharding.enter_model``/``leave_model``).  ``cross_entropy_loss`` is the training
loss: an fp32 log-sum-exp with the optional z-loss and mask, over the
rank's slice of the vocabulary where the logits are vocab-parallel.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import (enter_model, gather_over_model,
                                           leave_model, max_over_model,
                                           model_group, reduce_from_model)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled | mamba_a | mamba_dt
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamSpec: shape {self.shape} and logical "
                             f"axes {self.logical} differ in rank")


def tree_node(tree):
    """(children, rebuild) of a tree node, or None for a leaf: a dict (its
    keys in sorted order, the order ``jax.tree_util`` walks a dict in), a
    named tuple (its fields in order), a tuple or list (each kept as its
    own type), or an object with ``tree_flatten``/``tree_unflatten`` (a
    pytree node class, as ``optim.quant.QTensor``)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda ch: dict(zip(keys, ch))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree), lambda ch: type(tree)(*ch)
    if isinstance(tree, (tuple, list)):
        return list(tree), type(tree)
    if hasattr(tree, "tree_flatten"):
        children, aux = tree.tree_flatten()
        return list(children), lambda ch: type(tree).tree_unflatten(aux, ch)
    return None


def tree_map(fn, tree, is_leaf=None):
    """Apply `fn` to every leaf of a tree (see `tree_node`); `is_leaf(x)` true
    stops the walk at x and hands it to `fn` whole."""
    node = None if is_leaf is not None and is_leaf(tree) else tree_node(tree)
    if node is None:
        return fn(tree)
    children, rebuild = node
    return rebuild([tree_map(fn, c, is_leaf) for c in children])


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of a tree in `tree_map`'s order."""
    node = None if is_leaf is not None and is_leaf(tree) else tree_node(tree)
    if node is None:
        return [tree]
    return [x for c in node[0] for x in tree_leaves(c, is_leaf)]


def tree_unflatten(like, leaves):
    """A tree shaped as `like` whose leaves, in `tree_leaves` order, are
    `leaves`."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def stack_specs(tree, num: int, logical: str = "layers"):
    """Prepend a stacked (layer) dimension to every spec in the tree."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(num,) + s.shape, logical=(logical,) + s.logical), tree)


DRAW_ELEMENTS = 1 << 28       # fp32 elements per draw of a random leaf (1 GiB)
_MASK64 = (1 << 64) - 1


def leaf_seed(generator: torch.Generator) -> int:
    """One draw from `generator`: the seed a leaf's blocks are drawn from
    (`draw_leaf`)."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device).item())


def _block_seed(seed: int, block: int) -> int:
    """The seed of block `block` of a leaf seeded `seed` (splitmix64)."""
    z = (seed + (block + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def block_dims(spec: ParamSpec) -> int:
    """How many leading dims of a leaf index its blocks, each drawn from a
    generator of its own: the layer dim of a stacked leaf and the expert
    dim after it (an expert's matrix of one layer is one block)."""
    n = 1 if spec.logical[:1] in (("layers",), ("stack",)) else 0
    if spec.logical[n:n + 1] == ("expert",) and len(spec.shape) > n + 1:
        n += 1
    return n


def _draw_block(spec: ParamSpec, shape, seed: int,
                device: torch.device) -> torch.Tensor:
    """One block of a random leaf: drawn in fp32 in slices of at most
    DRAW_ELEMENTS, each scaled (or transformed) and cast into the block
    (a whole-leaf fp32 draw of one stacked expert leaf at Mixtral's widths
    would take twice the leaf's bf16 bytes twice)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty(shape, dtype=spec.dtype, device=device)
    flat = out.view(-1)
    scale = spec.scale
    if spec.init == "scaled":  # 1/sqrt(fan_in), fan_in as the JAX package
        fan_in = (spec.shape[0] if len(spec.shape) >= 2
                  else max(spec.shape[-1], 1))
        scale = 1.0 / np.sqrt(max(fan_in, 1))     # 0: a stack of no layers
    for a in range(0, flat.numel(), DRAW_ELEMENTS):
        n = min(DRAW_ELEMENTS, flat.numel() - a)
        if spec.init == "mamba_dt":
            # dt bias: inverse softplus of uniform in [1e-3, 1e-1]
            u = torch.rand(n, generator=gen, dtype=torch.float32,
                           device=device) * (1e-1 - 1e-3) + 1e-3
            flat[a:a + n] = u + torch.log(-torch.expm1(-u))
        else:
            x = torch.randn(n, generator=gen, dtype=torch.float32,
                            device=device)
            flat[a:a + n] = x.mul_(scale)
    return out


def draw_leaf(spec: ParamSpec, seed: int, device: torch.device,
              index=None, cut=None) -> torch.Tensor:
    """The leaf of `spec` drawn from `seed`, or only its part `index` (one
    slice a dim, as ``parallel.sharding.local_index`` cuts a rank's
    shard), with `cut` applied to each block after that (the SSM's paired
    columns).  A random leaf is drawn block by block (`block_dims`), each
    block from its own generator seeded from `seed` and its index, so a
    rank draws only the blocks its part holds and gets the values the
    whole draw has there."""
    shape = tuple(spec.shape)
    index = tuple(slice(*sl.indices(n)[:2]) for sl, n in zip(
        index or (slice(None),) * len(shape), shape))
    cut = cut or (lambda t: t)
    if spec.init in ("zeros", "ones", "mamba_a"):
        local = tuple(sl.stop - sl.start for sl in index)
        if spec.init == "mamba_a":
            # A_log: log of 1..N broadcast over d_inner (shape (..., d, N))
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)[index[-1]]
            out = torch.log(a.expand(local).contiguous()).to(spec.dtype)
        else:
            fill = torch.zeros if spec.init == "zeros" else torch.ones
            out = fill(local, dtype=spec.dtype, device=device)
        return cut(out)
    if spec.init not in ("normal", "scaled", "mamba_dt"):
        raise ValueError(f"unknown init {spec.init!r}")
    nb = block_dims(spec)
    strides = [int(np.prod(shape[d + 1:nb])) for d in range(nb)]
    out = None
    blocks = itertools.product(*(range(sl.start, sl.stop)
                                 for sl in index[:nb]))
    for i, blk in enumerate(blocks):
        b = sum(j * st for j, st in zip(blk, strides))
        piece = cut(_draw_block(spec, shape[nb:], _block_seed(seed, b),
                                device)[index[nb:]])
        if out is None:
            lead = tuple(sl.stop - sl.start for sl in index[:nb])
            if not lead:
                return piece
            out = torch.empty(lead + tuple(piece.shape), dtype=piece.dtype,
                              device=device)
        out.view((-1,) + tuple(piece.shape))[i] = piece
        del piece
    if out is None:                       # a stack of no layers
        return cut(torch.empty(tuple(sl.stop - sl.start for sl in index),
                               dtype=spec.dtype, device=device))
    return out


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    return draw_leaf(spec, leaf_seed(generator), device)


def init_params(spec_tree, generator: torch.Generator,
                device: torch.device) -> Dict[str, Any]:
    """Materialize a ParamSpec tree on `device`: each leaf, in sorted-key
    order, from a seed drawn from `generator` (which must live on
    `device`), block by block (`draw_leaf`)."""
    return tree_map(lambda s: _init_leaf(s, generator, device), spec_tree)


def iter_init(spec_tree, generator: torch.Generator, device: torch.device):
    """The leaves of `init_params` one at a time, drawn in its order: a
    generator that keeps no leaf it has yielded."""
    for spec in tree_leaves(spec_tree):
        yield _init_leaf(spec, generator, device)


def abstract_params(spec_tree):
    """The spec tree as meta-device tensors: shapes and dtypes, no data."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def param_pspecs(spec_tree, mesh, rules):
    """The PartitionSpec of each leaf on `mesh` under `rules`."""
    from repro_torch.parallel.sharding import resolve_pspec
    return tree_map(lambda s: resolve_pspec(s.logical, s.shape, mesh, rules),
                    spec_tree)


# ---------------------------------------------------------------------------
# Shared math
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs        # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype: fp32 activations against bf16 weights compute
    in fp32, as jnp's type promotion does; a no-op cast when they agree."""
    return x @ w.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = linear(x, w_gate)
    u = linear(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return linear(h, w_down)


def dense_ffn(x: torch.Tensor, ffn_params, act: str = "swiglu",
              split: bool = False, seq=None):
    """Dense FFN: 3-matrix SwiGLU or 2-matrix GELU (starcoder2/whisper).
    With `split`, the params are the rank's ``mlp`` shard: column-parallel
    ``w_gate``/``w_up``, row-parallel ``w_down``, its partial sums added
    over the ``model`` ranks.  Under sequence parallelism (`seq`, a
    ``sharding.seq_group``) `x` is the gathered sequence and the output
    the rank's slice of the sum (``sharding.leave_model``)."""
    x = enter_model(x, split, seq)
    if act == "swiglu":
        y = swiglu(x, ffn_params["w_gate"], ffn_params["w_up"],
                   ffn_params["w_down"])
    else:
        u = linear(x, ffn_params["w_up"])
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
        y = linear(h, ffn_params["w_down"])
    return leave_model(y, split, seq)


def vocab_offset(n_local: int, vocab_size: int) -> int:
    """The global index of the first of `n_local` vocabulary entries: 0
    for the whole vocabulary, the rank's slice start for a vocab-parallel
    slice (equal slices in ``model`` rank order)."""
    if n_local == vocab_size:
        return 0
    mg = model_group()
    if mg is None or n_local * mg.size != vocab_size:
        raise ValueError(f"{n_local} entries are no slice of a "
                         f"{vocab_size}-entry vocabulary over the model "
                         f"axis")
    return mg.rank * n_local


def vocab_argmax(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """argmax over the last dim of whole or vocab-parallel logits; ties go
    to the lowest global index, as ``torch.argmax`` breaks them on whole
    logits."""
    lo = vocab_offset(logits.shape[-1], vocab_size)
    if logits.shape[-1] == vocab_size:
        return torch.argmax(logits, dim=-1)
    val, idx = torch.max(logits.float(), dim=-1)        # first local max
    best = max_over_model(val)
    # the lowest global index among the ranks that hold the max
    cand = torch.where(val == best, idx + lo, vocab_size)
    return -max_over_model(-cand)


def gather_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Whole logits from whole or vocab-parallel ones."""
    vocab_offset(logits.shape[-1], vocab_size)
    if logits.shape[-1] == vocab_size:
        return logits
    return gather_over_model(logits, dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 0.0,
                       vocab_size: Optional[int] = None) -> torch.Tensor:
    """logits (B,S,V) [bf16 ok], labels (B,S) int -> the mean token NLL
    (over `mask`'s weight where given), an fp32 log-sum-exp; `z_loss`
    adds z_loss * lse**2 per token.  Logits with fewer than `vocab_size`
    entries are the rank's vocab-parallel slice: the log-sum-exp then
    takes its max and its sum of exponentials over the ``model`` ranks,
    and the gold logit comes from the rank that holds it."""
    logits = logits.float()
    if vocab_size is None or logits.shape[-1] == vocab_size:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        lo = vocab_offset(logits.shape[-1], vocab_size)
        m = max_over_model(logits.detach().amax(dim=-1))
        sumexp = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1))
        lse = torch.log(sumexp) + m
        local = labels.long() - lo
        mine = (local >= 0) & (local < logits.shape[-1])
        gold = torch.gather(logits, -1,
                            torch.where(mine, local, 0)[..., None])[..., 0]
        gold = reduce_from_model(torch.where(mine, gold, 0.0))
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = float(np.prod(labels.shape))
    return nll.sum() / denom
