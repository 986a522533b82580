"""Elastic mesh management: shrink/grow the device grid on membership change.

The port of ``repro/runtime/elastic.py``.  At 1000+ node scale the
question is never *if* a slice disappears but how cheaply the job
re-forms.  The paper's pilot model answers structurally (allocation is a
placeholder, re-acquirable); this module supplies the mechanical half:
given survivors, build the largest well-formed (data, model) grid.
Model-parallel degree is preserved when possible and reduced only when
survivors < model_parallel.

What differs from the JAX package: ``build_mesh`` returns a ``DeviceGrid``
(a numpy object array of ``torch.device`` with its axis names), not a
``jax.sharding.Mesh`` and not a ``torch.distributed`` DeviceMesh, which
would need a process group; ``reshard_state`` (logical param specs
resolved onto a mesh through the sharding rules) waits for the port's
``parallel/sharding.py``.

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


def build_mesh(devices: Sequence, plan: MeshPlan) -> DeviceGrid:
    used = int(np.prod(plan.shape))
    arr = np.empty(used, dtype=object)
    arr[:] = list(devices)[:used]
    return DeviceGrid(arr.reshape(plan.shape), tuple(plan.axes))


class ElasticController:
    """Track live devices; rebuild the device grid on membership change.

    Built bare (``ElasticController(mp)``) it is the pure grid-math
    controller.  Built with ``session=``, it additionally owns a manual
    ``repro_torch.core.autoscaler.Autoscaler`` (no monitor thread —
    membership changes are the caller's verbs here) and gains
    ``grow``/``shrink``: fleet changes go through the autoscaler's
    provision/drain protocol, then the grid re-forms over the live
    pilots' devices."""

    def __init__(self, model_parallel: int, *, session=None,
                 min_pilots: int = 1, max_pilots: int = 8,
                 **autoscaler_kwargs):
        self.model_parallel = model_parallel
        self.generation = 0
        self.mesh: Optional[DeviceGrid] = None
        self.events: List[dict] = []
        self.session = session
        self.autoscaler = None
        if session is not None:
            from repro_torch.core.autoscaler import Autoscaler
            self.autoscaler = Autoscaler(session, min_pilots=min_pilots,
                                         max_pilots=max_pilots,
                                         **autoscaler_kwargs)

    def form(self, devices: Sequence) -> DeviceGrid:
        plan = plan_mesh(len(devices), self.model_parallel)
        self.mesh = build_mesh(devices, plan)
        self.generation += 1
        self.events.append({"generation": self.generation,
                            "devices": len(devices), "shape": plan.shape,
                            "dropped": plan.dropped_devices})
        return self.mesh

    def on_failure(self, surviving) -> DeviceGrid:
        return self.form(surviving)

    def on_join(self, devices) -> DeviceGrid:
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
