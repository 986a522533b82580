"""Per-rank cost of one step, counted op by op as the step runs once on
fake tensors.

The port of ``repro/roofline/hlo_cost.py``.  PyTorch has no HLO: the
step runs eagerly, so this module counts the aten ops it dispatches (a
``TorchDispatchMode``; under ``FakeTensorMode`` the ops compute shapes
only, so a plan of a model no card holds costs host seconds):

  flops            ``torch.utils.flop_counter``'s formulas (matmuls,
                   convolutions, attention)
  hbm_bytes        every op's input and output bytes: eager ops are
                   unfused, so each one reads and writes HBM; views,
                   ``detach``, allocations and waits are free, as the
                   reference's ``_ZERO_COST`` ops are
  collective bytes the c10d ops the step issues, each op's buffer
                   times the reference's ring factor (``_traffic_factor``)
                   on the size of its group, by the reference's kinds;
                   the buffer is the full one the factor is defined on
                   (a reduce-scatter's input: the reference's HLO walk
                   applies it to the scattered result)

The reference multiplies while-loop bodies by their trip counts; a
Python loop issues every trip's ops, so that has no counterpart here.

The port's kernels are counted as one op each, with the kernel's own
FLOPs and bytes (``roofline.analysis.*_cost``): on a fake tensor each
``kernels/*/ops.py`` dispatcher returns an empty output of the kernel's
shape and calls ``record_kernel`` (its plain version would charge, say, a
materialised fp32 score matrix the card never allocates).

DTensor ops are left to DTensor (``NotImplemented``), which runs them as
ops on the local shards, counted here; ops that DTensor's sharding
propagation runs under its own fake mode are not counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

_ZERO_COST = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten.empty_like.default, aten._unsafe_view.default,
    aten.lift_fresh.default, aten._local_scalar_dense.default,
    aten.detach.default, aten.alias.default, aten.set_.source_Storage,
    aten.resize_.default, torch.ops.prim.device.default,
    torch.ops._c10d_functional.wait_tensor.default,
}

# c10d op -> (the reference's kind, the argument that is the full buffer
# the ring factor applies to; "out" for the op's output); another c10d op
# counts under its own name at (g-1)/g of its first argument
_COLLECTIVES = {
    # _c10d_functional: DTensor's redistributes, functional collectives
    "all_gather_into_tensor": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_to_all_single": ("all-to-all", 0),
    # c10d: torch.distributed's own calls
    "allreduce_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_opcode_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_count: int = 0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add_op(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        self.by_opcode_bytes[name] = self.by_opcode_bytes.get(name, 0.0) \
            + nbytes


# Per-device traffic multiplier relative to the op's full buffer, for
# ring implementations over a group of size g (copied from the reference):
#   all-reduce: 2*(g-1)/g x (reduce-scatter + all-gather)
#   all-gather: (g-1)/g of the full output
#   reduce-scatter: (g-1)/g of the full input
#   all-to-all: (g-1)/g of the buffer
#   collective-permute: 1x
def _traffic_factor(kind: str, group: int) -> float:
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (group - 1) / group
    if kind == "collective-permute":
        return 1.0
    return (group - 1) / group


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group_size(args) -> int:
    """The size of the process group a c10d op runs over."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    return _resolve_process_group(args[-1]).size()   # functional: the name


class OpCost(TorchDispatchMode):
    """Counts the ops dispatched inside it into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._outer = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        if self._outer is None:      # not the re-entry of a decomposition
            self._outer = (active_fake_mode(),)
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if (func.namespace == "aten"
                and func._overloadpacket not in flop_registry
                and not torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CPU")):
            # an op with no kernel of its own reaches here under
            # inference_mode (matmul, einsum): counted as the ops it runs,
            # as any device runs it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if (func in _ZERO_COST or func.is_view
                or active_fake_mode() is not self._outer[0]):
            return out
        name = func._overloadpacket.__name__
        ins = [args] + [v for k, v in kwargs.items() if k != "out"]
        nbytes = _nbytes(ins) + _nbytes(out)
        if func.namespace in ("c10d", "_c10d_functional"):
            kind, which = _COLLECTIVES.get(name, (name, 0))
            buf = _nbytes(out if which == "out" else args[which])
            traffic = buf * _traffic_factor(kind, _group_size(args))
            c = self.cost
            c.coll_bytes += traffic
            c.coll_count += 1
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + traffic
            c.add_op(kind, 0.0, nbytes)
            return out
        formula = flop_registry.get(func._overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0.0
        self.cost.add_op(name, flops, nbytes)
        return out


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Charge one call of the port's kernel `name` to every active
    ``OpCost`` (a kernel dispatcher calls it for a planned call)."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, OpCost):
            mode.cost.add_op(name, flops, nbytes)
            mode.cost.kernel_calls[name] = \
                mode.cost.kernel_calls.get(name, 0) + 1
