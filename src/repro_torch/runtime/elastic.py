"""Elastic mesh management: shrink/grow the device mesh, reshard state.

The port of ``repro/runtime/elastic.py``.  At 1000+ node scale the
question is never *if* a slice disappears but how cheaply the job
re-forms.  The paper's pilot model answers structurally (allocation is a
placeholder, re-acquirable); this module supplies the mechanical half:
given survivors, build the largest well-formed (data, model) mesh,
recompute every placement through the same AxisRules table, and put host
state into the new placement (``reshard_state``; a checkpoint does the
same through ``CheckpointManager.restore(shardings=)``).  Model-parallel
degree is preserved when possible and reduced only when survivors <
model_parallel.

``build_mesh`` takes either the surviving ranks of the default process
group and returns a ``torch.distributed`` ``DeviceMesh`` over them (every
rank of the group calls it, the leavers too: creating the mesh's groups
is collective), or, in a single process, torch devices, and returns a
``DeviceGrid`` (a numpy object array of ``torch.device`` with its axis
names), which needs no process group.

The grow/shrink half of that loop belongs to the elasticity layer
(``repro_torch.core.autoscaler``): an ``ElasticController`` built with a
``session=`` holds a manual (non-monitoring) ``Autoscaler`` and delegates
``grow``/``shrink`` to its ``scale_out``/``scale_in`` — scale-in runs the
full drain protocol (quiesce, serving handoff, partition evacuation)
before the grid re-forms over the survivors — mirroring how
``runtime/fault_tolerance.py`` delegates detect/replace to the
supervisor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.parallel.sharding import (AxisRules, named_sharding,
                                           shard_tensor)


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_devices: int


@dataclasses.dataclass
class DeviceGrid:
    """The devices of a plan, laid out on its axes (``devices[i, j]`` is
    a ``torch.device``)."""
    devices: np.ndarray
    axes: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)


def plan_mesh(num_devices: int, model_parallel: int,
              axes: Tuple[str, ...] = ("data", "model")) -> MeshPlan:
    """Largest (data, model) grid over the survivors."""
    mp = min(model_parallel, num_devices)
    while num_devices % mp and mp > 1:
        mp -= 1
    dp = num_devices // mp
    used = dp * mp
    return MeshPlan(shape=(dp, mp), axes=axes,
                    dropped_devices=num_devices - used)


def build_mesh(devices: Sequence, plan: MeshPlan):
    """The plan over the first devices: ranks (ints) of the default
    process group give a DeviceMesh, torch devices a DeviceGrid."""
    used = int(np.prod(plan.shape))
    devices = list(devices)[:used]
    if all(isinstance(d, int) for d in devices):
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.launch.mesh import mesh_device_type
        ranks = torch.tensor(devices, dtype=torch.int64).reshape(plan.shape)
        return DeviceMesh(mesh_device_type(), ranks,
                          mesh_dim_names=tuple(plan.axes))
    arr = np.empty(used, dtype=object)
    arr[:] = devices
    return DeviceGrid(arr.reshape(plan.shape), tuple(plan.axes))


def reshard_state(host_state, spec_tree, mesh, rules: AxisRules):
    """host arrays + logical specs -> DTensors on the new mesh (each rank
    keeping its own slice of the host array)."""
    def put(spec, leaf):
        sh = named_sharding(spec.logical, spec.shape, mesh, rules)
        return shard_tensor(torch.from_numpy(np.array(leaf)), mesh,
                            sh.placements)
    return tree_unflatten(spec_tree, [
        put(spec, leaf) for spec, leaf in
        zip(tree_leaves(spec_tree), tree_leaves(host_state))])


class ElasticController:
    """Track live devices; rebuild the mesh on membership change.

    Built bare (``ElasticController(mp)``) it is the pure mesh-math
    controller: ``form`` over ranks gives a DeviceMesh, over devices a
    DeviceGrid; ``rules`` are the table the state is resharded by.
    Built with ``session=``, it additionally owns a manual
    ``repro_torch.core.autoscaler.Autoscaler`` (no monitor thread —
    membership changes are the caller's verbs here) and gains
    ``grow``/``shrink``: fleet changes go through the autoscaler's
    provision/drain protocol, then the grid re-forms over the live
    pilots' devices."""

    def __init__(self, model_parallel: int, rules: Optional[AxisRules] = None,
                 *, session=None, min_pilots: int = 1, max_pilots: int = 8,
                 **autoscaler_kwargs):
        self.model_parallel = model_parallel
        self.rules = rules or AxisRules()
        self.generation = 0
        self.mesh = None
        self.events: List[dict] = []
        self.session = session
        self.autoscaler = None
        if session is not None:
            from repro_torch.core.autoscaler import Autoscaler
            self.autoscaler = Autoscaler(session, min_pilots=min_pilots,
                                         max_pilots=max_pilots,
                                         **autoscaler_kwargs)

    def form(self, devices: Sequence):
        plan = plan_mesh(len(devices), self.model_parallel)
        self.mesh = build_mesh(devices, plan)
        self.generation += 1
        self.events.append({"generation": self.generation,
                            "devices": len(devices), "shape": plan.shape,
                            "dropped": plan.dropped_devices})
        return self.mesh

    def on_failure(self, surviving):
        return self.form(surviving)

    def on_join(self, devices):
        return self.form(devices)

    # -- session-backed elasticity (delegates to the autoscaler) ---------
    def _session_devices(self) -> List:
        """The live fleet's devices, deduped in provision order (pilots
        share a card on an oversubscribed backend)."""
        from repro_torch.core.pilot import State
        seen, devs = set(), []
        for p in self.session.pilots:
            if p.state is not State.RUNNING:
                continue
            for d in p.devices:
                if d not in seen:
                    seen.add(d)
                    devs.append(d)
        return devs

    def grow(self, n: int = 1) -> DeviceGrid:
        """Scale the fleet out by up to `n` pilots and re-form the grid
        over the enlarged fleet's devices."""
        if self.autoscaler is None:
            raise RuntimeError("ElasticController.grow needs session=")
        self.autoscaler.scale_out(n, reason="elastic.grow")
        return self.form(self._session_devices())

    def shrink(self, pilot=None) -> DeviceGrid:
        """Drain one pilot out of the fleet (full scale-in protocol:
        quiesce, evacuate partitions, release) and re-form the grid over
        the survivors."""
        if self.autoscaler is None:
            raise RuntimeError("ElasticController.shrink needs session=")
        self.autoscaler.scale_in(pilot, reason="elastic.shrink")
        return self.form(self._session_devices())

    def close(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.close()
