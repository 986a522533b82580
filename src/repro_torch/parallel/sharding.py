"""Logical-axis sharding rules (t5x-style) with divisibility-aware fallback.

The port of ``repro/parallel/sharding.py``.  Every parameter / activation
declares *logical* axis names; a rule table maps them to mesh axes.
``resolve_pspec`` drops mesh axes that do not divide the dimension (e.g.
kv_heads=8 over a 16-way "model" axis) and never assigns the same mesh
axis to two dims of one tensor — later dims fall back to the next
alternative rule.  It is pure Python over ``{axis: size}``: it takes a
``torch.distributed`` ``DeviceMesh`` or the device-less mesh of
``launch.mesh.make_abstract_mesh`` (anything with ``mesh_dim_names`` and
``shape``), and returns the port's own ``PartitionSpec``.

What is new in the port: a ``PartitionSpec`` becomes DTensor placements
through ``placements`` (one ``Shard``/``Replicate`` per mesh dimension),
and ``shard_tensor``/``local_slice`` cut a whole tensor (or a host array)
into the calling rank's shard of those placements with no collective.
A tuple entry such as ``("pod", "data")`` on tensor dim 0 shards that dim
over both mesh dimensions, the first named outermost: JAX's
``P(("pod", "data"))``, which is DTensor's order when the axes come in
the mesh's own order (the only order the port accepts).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
# Each logical axis may have several alternatives, tried in order.
Rule = Tuple[str, MeshAxes]


DEFAULT_RULES: Tuple[Rule, ...] = (
    # --- activations ---
    ("batch", ("pod", "data")),
    ("seq", None),                  # query sequence (train/prefill)
    ("kv_seq", "model"),            # decode KV-cache sequence (flash-decoding style)
    ("long_seq", ("data", "model")),  # 500k decode cache, batch=1
    ("act_embed", None),
    ("act_heads", "model"),
    ("act_kv_heads", "model"),
    ("act_head_dim", None),
    ("act_mlp", "model"),
    ("act_vocab", "model"),
    ("act_expert", "model"),
    ("act_ssm_inner", "model"),
    ("moe_group", ("pod", "data")),   # MoE dispatch-buffer group dim (scatter side)
    ("moe_group2", ("pod", "data")),  # ...compute side (EP-2D overrides to None)
    ("act_expert2", "model"),         # ...compute side (EP-2D: ("model","data"))
    ("moe_cap", None),                # MoE capacity dim

    # --- params ---
    ("vocab", "model"),
    ("embed", "data"),              # FSDP: shard params' d_model dim over data
    ("heads", "model"),
    ("kv_heads", "model"),          # falls back (replicate) when kv < |model|
    ("head_dim", None),
    ("mlp", "model"),
    ("expert", "model"),
    ("expert_embed", "data"),
    ("expert_mlp", "model"),        # used when "expert" could not take the axis
    ("ssm_inner", "model"),
    ("ssm_state", None),
    ("dt_rank", None),
    ("conv_k", None),
    ("mla_rank", None),
    ("layers", None),
    ("stack", None),
)


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over all of them, outermost
    first); trailing ``None`` entries are dropped, as JAX's ``P`` is
    built by ``resolve_pspec``."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives: a mesh and one placement per mesh dim (a
    leaf, not a node, of the port's trees); `shape`, where given, the
    global shape it is placed at when that is not the shape of the whole
    tensor handed to it (a blockwise state's blocks,
    ``optim.quant.block_layout``)."""
    mesh: object
    placements: tuple
    shape: Optional[Tuple[int, ...]] = None


def _as_tuple(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size} of a DeviceMesh or an abstract mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class AxisRules:
    """Ordered logical->mesh mapping. Later entries with the same logical name
    act as fallback alternatives."""

    def __init__(self, rules: Sequence[Rule] = DEFAULT_RULES):
        self.rules: Tuple[Rule, ...] = tuple(rules)

    def alternatives(self, logical: str) -> Tuple[MeshAxes, ...]:
        alts = tuple(axes for name, axes in self.rules if name == logical)
        return alts if alts else (None,)

    def override(self, *new_rules: Rule) -> "AxisRules":
        """New rules take priority (prepended)."""
        return AxisRules(tuple(new_rules) + self.rules)

    def replacing(self, logical: str, axes: MeshAxes) -> "AxisRules":
        kept = tuple(r for r in self.rules if r[0] != logical)
        return AxisRules(((logical, axes),) + kept)


_ctx = threading.local()


class sharding_context:
    """Install (mesh, rules) for with_logical_constraint inside model code."""

    def __init__(self, mesh, rules: Optional[AxisRules] = None):
        self.mesh = mesh
        self.rules = rules or AxisRules()

    def __enter__(self):
        self._prev = getattr(_ctx, "cur", None)
        _ctx.cur = self
        return self

    def __exit__(self, *exc):
        _ctx.cur = self._prev


def current_context() -> Optional["sharding_context"]:
    return getattr(_ctx, "cur", None)


def resolve_pspec(
    logical_dims: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: AxisRules,
) -> PartitionSpec:
    """Build a PartitionSpec, honoring divisibility and no-axis-reuse."""
    assert len(logical_dims) == len(shape), (logical_dims, shape)
    used: set = set()
    out = []
    sizes = axis_sizes(mesh)
    for logical, dim in zip(logical_dims, shape):
        chosen: MeshAxes = None
        if logical is not None:
            for alt in rules.alternatives(logical):
                axes = tuple(a for a in _as_tuple(alt)
                             if a in sizes and a not in used)
                if not axes:
                    continue
                total = int(np.prod([sizes[a] for a in axes]))
                if dim % total == 0:
                    chosen = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
                    break
                # try a prefix of the axis tuple (e.g. ("data","model")->("data",))
                for k in range(len(axes) - 1, 0, -1):
                    sub = axes[:k]
                    total = int(np.prod([sizes[a] for a in sub]))
                    if dim % total == 0:
                        chosen = sub if len(sub) > 1 else sub[0]
                        used.update(sub)
                        break
                if chosen is not None:
                    break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def placements(pspec: Sequence[MeshAxes], mesh) -> list:
    """The DTensor placements of `pspec` on `mesh`: one per mesh dim,
    ``Shard(d)`` where tensor dim d is split over that mesh axis, else
    ``Replicate()``.  The axes of one tuple entry must come in the mesh's
    order (outermost first), the only nesting DTensor's ``Shard`` has
    (`mesh_ordered` puts them so)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        dims = [names.index(a) for a in _as_tuple(entry)]
        if dims != sorted(dims):
            raise NotImplementedError(
                f"placements: {entry!r} on tensor dim {d} nests mesh axes "
                f"out of the mesh's order {tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return out


def mesh_ordered(pspec: PartitionSpec, mesh) -> PartitionSpec:
    """`pspec` with each tuple entry's axes in the mesh's order: the same
    shards, dealt to the ranks in that order.  EP-2D's ``("model",
    "data")`` on a ``("data", "model")`` mesh gives rank (d, m) chunk
    d*M + m, where JAX's ``P(("model", "data"))`` gives it chunk m*D + d;
    ``models/moe.py`` reads which experts a rank holds the port's way."""
    names = list(mesh.mesh_dim_names)
    return PartitionSpec(*(
        tuple(sorted(entry, key=names.index))
        if isinstance(entry, tuple) else entry for entry in pspec))


def named_sharding(
    logical_dims: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: AxisRules,
) -> NamedSharding:
    spec = mesh_ordered(resolve_pspec(logical_dims, shape, mesh, rules),
                        mesh)
    return NamedSharding(mesh, tuple(placements(spec, mesh)))


def with_logical_constraint(x: torch.Tensor, *logical_dims: Optional[str]):
    """Sharding-constrain an intermediate by logical axis names.

    A no-op outside a sharding_context and on a plain tensor; a DTensor
    is redistributed to the resolved placements.  The models call none:
    they run on each rank's local ``model`` shard of the params
    (Megatron-style), and where the reference constrains an activation
    the port issues the collective that constraint implies
    (`copy_to_model`, `reduce_from_model`):

    - q/k/v to ``act_heads``/``act_kv_heads`` (reference
      ``attention.py:93-95``): column-parallel ``wq``/``wk``/``wv`` give
      the rank's local heads;
    - ``act_mlp`` (``common.py:116, 127``): column-parallel
      ``w_gate``/``w_up``, then row-parallel ``w_down``;
    - ``xz`` to ``act_ssm_inner`` (``ssm.py:128``): column-parallel
      ``w_in``; conv, ``A``, ``D`` and the scan on the local channels; the
      row-parallel ``w_x``'s (dt, B, C) all-reduced before ``w_dt``;
    - the residual to ``act_embed`` (``transformer.py:171, 180``): the
      row-parallel outputs (``wo``, ``w_down``, ``w_out``) all-reduced;
    - embed and logits to ``act_vocab`` (``transformer.py:351, 358,
      376``): the vocab-parallel embedding, logits and cross-entropy
      (``models/common.py``), and `vocab_argmax` for greedy decode;
    - MLA's q, k and v to ``act_heads`` (``attention.py:219-221``):
      column-parallel ``wq_b``/``wk_b``/``wv_b`` on the whole latents
      (``q_lat``, ``c_kv`` and the shared ``k_rope`` enter through
      `copy_to_model`), the row-parallel ``wo`` all-reduced;
    - MoE's dispatch buffer to ``act_expert`` and ``act_expert2``
      (``moe.py:155-160``): a rank dispatches only to the experts it
      holds (``expert`` on ``model``) or runs every expert on its
      ``expert_mlp`` columns; where the rules also put ``expert`` on a
      batch axis (EP-2D) the buffer goes to the experts' holders and
      back by `all_to_all` over that axis; the routed and shared
      experts' partial sums are all-reduced once;
    - the residual to ``("batch", "seq", "act_embed")`` where the rules
      put ``seq`` on ``model`` (`seq_group`): the residual is the rank's
      sequence slice, gathered into each block (`gather_seq`) and
      reduce-scattered out of it (`scatter_seq`), Megatron-SP's pair in
      place of `copy_to_model`/`reduce_from_model` (`enter_model`,
      `leave_model`).
    """
    from torch.distributed.tensor import DTensor
    ctx = current_context()
    if ctx is None or ctx.mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_pspec(logical_dims, x.shape, ctx.mesh, ctx.rules)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


# ---------------------------------------------------------------------------
# tensor parallelism over the "model" axis (Megatron's f and g)
# ---------------------------------------------------------------------------

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The calling rank's ``model`` axis: its process group, size and
    coordinate."""
    group: object
    size: int
    rank: int


def axis_group(axis: str) -> Optional[ModelGroup]:
    """Mesh axis `axis` of the current sharding_context's mesh (its
    process group, size and the rank's coordinate), or None where no
    collective is due: outside a context, on a mesh without the axis or
    with one of size 1, or on a device-less mesh."""
    ctx = current_context()
    mesh = None if ctx is None else ctx.mesh
    if (mesh is None or not hasattr(mesh, "get_group")
            or axis not in (mesh.mesh_dim_names or ())):
        return None
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if size == 1:
        return None
    return ModelGroup(mesh.get_group(axis), size, mesh.get_local_rank(axis))


def model_group() -> Optional[ModelGroup]:
    """The ``model`` axis of the current context (`axis_group`)."""
    return axis_group(MODEL_AXIS)


def model_placements(logical_dims: Sequence[Optional[str]],
                     shape: Sequence[int], mesh, rules: AxisRules) -> list:
    """The placements of a leaf (`logical_dims`, `shape`) on `mesh` under
    `rules` with only its ``model`` shard kept: how a rank holds it in the
    tensor-parallel models (whole over the batch axes)."""
    from torch.distributed.tensor import Replicate
    place = placements(mesh_ordered(resolve_pspec(logical_dims, shape, mesh,
                                                  rules), mesh), mesh)
    return [p if name == MODEL_AXIS else Replicate()
            for name, p in zip(mesh.mesh_dim_names, place)]


def model_local_shape(logical_dims: Sequence[Optional[str]],
                      shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of the calling rank's ``model`` shard of a leaf under the
    current sharding_context's mesh and rules (`model_placements`); the
    whole shape where `model_group` is None."""
    from torch.distributed.tensor import Shard
    mg = model_group()
    out = list(shape)
    if mg is not None:
        ctx = current_context()
        for p in model_placements(logical_dims, shape, ctx.mesh, ctx.rules):
            if isinstance(p, Shard):
                out[p.dim] //= mg.size
    return tuple(out)


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward: the input
    of a column-parallel product (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a
    row-parallel product (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """`x` entering a column-parallel product (or a replicated weight
    whose users on each rank see only part of its gradient): the
    gradient is summed over the ``model`` ranks.  `x` itself where
    `model_group` is None."""
    mg = model_group()
    return x if mg is None else _CopyToModel.apply(x, mg.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ``model`` ranks of a row-parallel product's
    partial `x`; `x` itself where `model_group` is None."""
    mg = model_group()
    return x if mg is None else _ReduceFromModel.apply(x, mg.group)


# ---------------------------------------------------------------------------
# sequence parallelism over the "model" axis (the rule ("seq", "model"))
# ---------------------------------------------------------------------------

def seq_group(seq_len: int) -> Optional[ModelGroup]:
    """The ``model`` axis (`model_group`) where the current context runs
    sequence-parallel at `seq_len`: its rules resolve a residual
    ``("batch", "seq", "act_embed")`` of that length with ``model`` on the
    sequence (the batch and width taken as dividing every axis); else
    None: the default rules leave ``seq`` whole, a length the axis does
    not divide is dropped (decode's S=1 among them), and so is a model
    axis of 1."""
    mg = model_group()
    if mg is None:
        return None
    ctx = current_context()
    n = ctx.mesh.size()
    spec = resolve_pspec(("batch", "seq", "act_embed"), (n, seq_len, n),
                         ctx.mesh, ctx.rules)
    return mg if len(spec) > 1 and MODEL_AXIS in _as_tuple(spec[1]) else None


def _gather_seq(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The ranks' dim-1 slices of `x` laid end to end, in rank order."""
    import torch.distributed as dist
    xt = x.movedim(1, 0).contiguous()
    out = xt.new_empty((mg.size * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=mg.group)
    return out.movedim(0, 1).contiguous()


def _scatter_seq(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The rank's dim-1 slice of the sum over the ranks of `x`."""
    import torch.distributed as dist
    xt = x.movedim(1, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // mg.size,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=mg.group)
    return out.movedim(0, 1).contiguous()


class _GatherSeq(torch.autograd.Function):
    """All-gather over the sequence forward, reduce-scatter of the
    gradient backward: a residual slice entering a block (Megatron-SP's
    g)."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _gather_seq(x, mg)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_seq(grad, ctx.mg), None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter over the sequence forward, all-gather of the
    gradient backward: a split block's partial sums leaving for the
    residual (Megatron-SP's g-bar)."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _scatter_seq(x, mg)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad, ctx.mg), None


class _SplitGrad(torch.autograd.Function):
    """Identity forward; the gradient divided by the ranks backward."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


def gather_seq(x: torch.Tensor, seq: Optional[ModelGroup]) -> torch.Tensor:
    """The whole sequence (dim 1) from the ranks' slices `x`; its gradient
    is summed over the ranks and cut back to the slice, so what consumes
    the whole sequence gives each rank's part of it.  `x` itself where
    `seq` (`seq_group`) is None."""
    return x if seq is None else _GatherSeq.apply(x, seq)


def scatter_seq(x: torch.Tensor, seq: Optional[ModelGroup]) -> torch.Tensor:
    """The rank's sequence slice of the sum over the ranks of `x`; `x`
    itself where `seq` is None."""
    return x if seq is None else _ScatterSeq.apply(x, seq)


def seq_slice(x: torch.Tensor, seq: ModelGroup) -> torch.Tensor:
    """The rank's sequence slice of `x`, alike on every rank (no
    collective: its gradient is the slice's, zero elsewhere)."""
    n = x.shape[1] // seq.size
    return x[:, seq.rank * n:(seq.rank + 1) * n]


def split_grad(x: torch.Tensor, seq: ModelGroup) -> torch.Tensor:
    """`x`, computed alike on every rank from the gathered sequence, whose
    gradient then counts once over the ranks' summed parts."""
    return _SplitGrad.apply(x, seq.size)


def enter_model(x: torch.Tensor, split: bool,
                seq: Optional[ModelGroup]) -> torch.Tensor:
    """A block's input: `copy_to_model` where the block is split over the
    ``model`` axis (Megatron's f).  Under sequence parallelism (`seq`)
    `x` is the gathered sequence (`gather_seq`), whose backward already
    sums the ranks' parts: nothing is added."""
    return copy_to_model(x) if split and seq is None else x


def leave_model(y: torch.Tensor, split: bool,
                seq: Optional[ModelGroup]) -> torch.Tensor:
    """A block's output on its way to the residual: a split block's
    partial sums added over the ``model`` ranks (`reduce_from_model`),
    or, under sequence parallelism, reduce-scattered over the sequence
    (`scatter_seq`); a block whole on every rank gives its output, or
    under sequence parallelism the rank's slice of it (`seq_slice`)."""
    if seq is not None:
        return scatter_seq(y, seq) if split else seq_slice(y, seq)
    return reduce_from_model(y) if split else y


class _AllToAll(torch.autograd.Function):
    """`all_to_all`: its backward is the reverse exchange, the same
    exchange of equal chunks on the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of `x` cut into as many equal chunks as `group` has ranks,
    chunk j sent to group rank j; chunk j of the result is what rank j
    sent this rank (differentiable: the gradient goes back the same
    way)."""
    return _AllToAll.apply(x, group)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the ``model`` ranks (no gradient)."""
    import torch.distributed as dist
    mg = model_group()
    return x if mg is None else _all_reduce(x.detach(), mg.group,
                                            dist.ReduceOp.MAX)


def gather_over_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ``model`` ranks' `x` concatenated along `dim` in rank order
    (no gradient)."""
    import torch.distributed as dist
    mg = model_group()
    if mg is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mg.size)]
    dist.all_gather(parts, x.contiguous(), group=mg.group)
    return torch.cat(parts, dim=dim)


def batch_dims(mesh, rules: AxisRules) -> list:
    """The mesh dims the "batch" rule can shard over: the ranks along them
    hold different slices of a batch (or, where the batch did not divide,
    the same one)."""
    named = {a for alt in rules.alternatives("batch") for a in _as_tuple(alt)}
    return [m for m, a in enumerate(mesh.mesh_dim_names) if a in named]


def batch_group(mesh, rules: AxisRules) -> Optional[ModelGroup]:
    """The calling rank's group over `mesh`'s batch dims of more than one
    rank (`batch_dims`): its process group, its size D and the rank's
    coordinate over those dims, which is also its place in the group's
    order; None where D is 1.  Several such dims (``pod`` and ``data``)
    become one flattened group, made collectively: every rank of `mesh`
    calls this."""
    names = [mesh.mesh_dim_names[m] for m in batch_dims(mesh, rules)
             if mesh.size(m) > 1]
    if not names:
        return None
    sub = mesh[names[0]] if len(names) == 1 else mesh[tuple(names)]._flatten()
    return ModelGroup(sub.get_group(), sub.size(), sub.get_local_rank())


def model_mesh(mesh, rules: AxisRules):
    """`mesh` without its batch dims (`batch_dims`): the sub-mesh of the
    other dims, over which a data group's model collectives run, or None
    where no other dim is left."""
    skip = batch_dims(mesh, rules)
    keep = tuple(a for m, a in enumerate(mesh.mesh_dim_names)
                 if m not in skip)
    if not keep:
        return None
    return mesh[keep[0] if len(keep) == 1 else keep]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch-axis ranks of `x`, a mean over this rank's
    slice of the batch: the global batch's mean when the slices are equal
    (the JAX package takes such a mean over the whole sharded batch).
    Not differentiable (for a quantity with no gradient).  `x` itself
    outside a sharding_context over a DeviceMesh, or when the batch axes
    are 1."""
    import torch.distributed as dist
    ctx = current_context()
    mesh = None if ctx is None else ctx.mesh
    if mesh is None or not hasattr(mesh, "get_group"):
        return x
    dims = [m for m in batch_dims(mesh, ctx.rules) if mesh.size(m) > 1]
    if not dims:
        return x
    x = x.detach().clone()
    for m in dims:
        dist.all_reduce(x, group=mesh.get_group(m))
    return x / math.prod(mesh.size(m) for m in dims)


def logical_sharding(logical_dims, shape) -> Optional[NamedSharding]:
    ctx = current_context()
    if ctx is None or ctx.mesh is None:
        return None
    return named_sharding(logical_dims, shape, ctx.mesh, ctx.rules)


# ---------------------------------------------------------------------------
# a rank's shard, cut locally
# ---------------------------------------------------------------------------

def local_index(shape: Sequence[int], mesh, place: Sequence) -> tuple:
    """The calling rank's shard of a tensor of `shape` under `place`, as
    one slice a dim: each mesh dim that shards tensor dim d cuts it into
    equal chunks, in mesh-dim order, and keeps the chunk at the rank's
    coordinate."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("local_slice: the calling rank is not in the mesh")
    index = [slice(None)] * len(shape)
    lengths = list(shape)
    for m, p in enumerate(place):
        if not isinstance(p, Shard):
            continue
        d, n = p.dim, mesh.size(m)
        if lengths[d] % n:
            raise ValueError(f"local_slice: dim {d} of {tuple(shape)} "
                             f"does not split {n} ways")
        lengths[d] //= n
        start = (index[d].start or 0) + coord[m] * lengths[d]
        index[d] = slice(start, start + lengths[d])
    return tuple(index)


def shard_shape(shape: Sequence[int], mesh, place: Sequence) -> tuple:
    """The shape of the calling rank's shard (`local_index`)."""
    return tuple(len(range(*sl.indices(n)))
                 for sl, n in zip(local_index(shape, mesh, place), shape))


def local_slice(x, mesh, place: Sequence):
    """The calling rank's shard of the whole `x` (a tensor or a numpy
    array, a view where the indexing allows) under `place`
    (`local_index`).  No collective."""
    return x[local_index(x.shape, mesh, place)]


def mesh_device(mesh) -> torch.device:
    """The calling rank's device of `mesh`'s type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def from_local(local: torch.Tensor, mesh, place: Sequence,
               shape: Sequence[int]):
    """The DTensor of global `shape` whose shard on this rank is `local`
    (no collective, no check)."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, list(place), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def owned(t: torch.Tensor) -> torch.Tensor:
    """`t`, copied where it is a view into a larger storage (a shard cut
    out of a whole tensor would keep the whole alive)."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone()
    return t


def shard_tensor(x: torch.Tensor, mesh, place: Sequence):
    """A DTensor of the whole `x` placed by `place`, built from the rank's
    own slice of `x` (moved to the mesh's device; `x` itself where the
    slice is all of it and already there): every rank holds the whole
    `x`, so nothing is sent."""
    local = local_slice(x, mesh, place).to(mesh_device(mesh))
    return from_local(owned(local.contiguous()), mesh, place, x.shape)
