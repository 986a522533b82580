"""Backend adaptors: the paper's YARN/Mesos/SAGA adaptor layer.

Each adaptor knows how to *provision* a PilotCompute on its substrate.
The paper's point is that the Pilot-API stays identical across them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.pilot import PilotCompute, PilotComputeDescription

_REGISTRY: Dict[str, "ComputeBackend"] = {}


class ComputeBackend:
    name: str = "base"

    def provision(self, desc: PilotComputeDescription) -> PilotCompute:
        raise NotImplementedError

    @staticmethod
    def attach_managed_memory(pilot: PilotCompute,
                              desc: PilotComputeDescription,
                              device=None) -> PilotCompute:
        """Provision the pilot's retained memory from the description's
        `memory`/`durability` blocks (one TierManager: memory_gb ->
        device budget, host_memory_gb -> host budget, checkpoint_dir/gb
        -> the durable spill tier shared per directory).  No-op without a
        memory ask.  Shared by every adaptor so all substrates
        participate identically in multi-pilot Pilot-Data."""
        from repro_torch.core.tiering import tier_manager_for_pilot
        tm = tier_manager_for_pilot(desc, device=device)
        if tm is not None:
            pilot.attach_tier_manager(tm)
        return pilot

    @staticmethod
    def attach_worker_pool(pilot: PilotCompute,
                           desc: PilotComputeDescription) -> PilotCompute:
        """Provision the pilot's resident task-engine worker pool from
        the description's `task_workers` / `dispatch_queue_depth` knobs
        (raptor-style function-as-task executors pinned to this pilot and
        its TierManager).  Threads start lazily on first submit_tasks, so
        an unused pool costs nothing.  Shared by every adaptor, like
        attach_managed_memory."""
        from repro_torch.core.taskengine import WorkerPool
        pilot.worker_pool = WorkerPool(
            pilot,
            workers=getattr(desc, "task_workers", 2),
            queue_depth=getattr(desc, "dispatch_queue_depth", 1024))
        return pilot

    def health(self, pilot: PilotCompute) -> dict:
        """One liveness sample for the failure detector (supervisor.py).

        The contract every adaptor must honor: ``alive`` is the
        substrate's own verdict (terminal pilot state == not alive),
        ``last_heartbeat`` is a *monotonic* stamp advancing while the
        pilot's worker loop runs, and ``busy`` distinguishes a pilot
        stuck inside one long CU (straggler — suspect, never
        phi-confirm dead) from one whose loop went silent.  Adaptors
        with real remote agents override this with their own probe."""
        from repro_torch.core.pilot import State
        state = pilot.state
        pool = pilot.worker_pool
        return {
            "pilot": pilot.id,
            "state": getattr(state, "value", str(state)),
            "alive": state == State.RUNNING,
            "last_heartbeat": pilot.last_heartbeat,
            "heartbeat_age_s": pilot.heartbeat_age(),
            "busy": pilot.utilization > 0,
            "queued": pilot._queue.qsize(),
            # load telemetry for the autoscaler (same probe the failure
            # detector reads, so a stalled adaptor can't look idle)
            "utilization": pilot.utilization,
            "pool_depth": pool.queue.depth if pool is not None else 0,
            "task_workers": getattr(pilot.desc, "task_workers", 0),
        }

    def capacity(self) -> Optional[int]:
        """How many MORE pilots this adaptor can provision right now, or
        None for unknown/unbounded.  The autoscaler consults this before
        scale-out so it never asks a full substrate for a node."""
        return None

    def release(self, pilot: PilotCompute) -> None:
        pilot.cancel()


def register_backend(backend: ComputeBackend):
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> ComputeBackend:
    if name not in _REGISTRY:
        # late import side-effect registration
        from repro_torch.core.backends import inprocess, simulated  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
