"""Pilot-level fault tolerance: heartbeat, re-provision, restore, resume.

The port of ``repro/runtime/fault_tolerance.py``, over the port's
CheckpointManager and PilotSupervisor.  The runner saves with
``blocking=False`` right after a step that updates the state in place
(the port's train step donates it: AdamW writes params and moments in
place); that is safe because ``CheckpointManager.save`` snapshots every
leaf to host memory before it returns, and only the disk write runs in
the background.

The paper's pilot model makes recovery structural: system-level allocation
(the pilot) and application progress (checkpoints in Pilot-Data's persistent
tier) are decoupled, so losing a pilot never loses work past the last
checkpoint. The ResilientRunner drives that loop:

  run step CUs on the active pilot
  -> pilot FAILED (heartbeat)  -> re-provision (same or degraded size)
  -> restore latest checkpoint onto the new pilot's device
  -> resume at the restored step

The detect/replace half of that loop is the supervision
layer's (repro_torch.core.supervisor): the runner holds a detect-only
``PilotSupervisor`` (auto_respawn=False — the RUNNER owns when to
re-provision, because it must restore checkpointed state before
resuming) and delegates the release+re-provision step to
``supervisor.replace_pilot``, so the same quarantine bookkeeping,
respawn telemetry, and failure-detector math back both the step-loop
recovery here and the self-healing ``PilotSession(supervise=True)``
path.  The public surface (``run``, ``recoveries`` of RecoveryEvent) is
unchanged.

On a multi-node deployment the same logic runs in the launcher process
of each node group (with torch.distributed); the simulated backend
exercises every path deterministically on one host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.manager import ComputeDataManager, PilotComputeService
from repro_torch.core.pilot import (ComputeUnitDescription, PilotCompute,
                              PilotComputeDescription, State)
from repro_torch.core.supervisor import PilotSupervisor


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    old_pilot: str
    new_pilot: str
    restored_step: int
    downtime_s: float


class ResilientRunner:
    """Drives a step function through pilots with checkpoint/restart."""

    def __init__(self, service: PilotComputeService,
                 pilot_desc: PilotComputeDescription,
                 ckpt: CheckpointManager,
                 checkpoint_every: int = 10,
                 max_recoveries: int = 3):
        self.service = service
        self.manager = ComputeDataManager(service)
        self.pilot_desc = pilot_desc
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.max_recoveries = max_recoveries
        self.pilot: Optional[PilotCompute] = None
        self.recoveries: list[RecoveryEvent] = []
        # detect/quarantine-only supervisor: the runner decides WHEN to
        # replace (it must restore state first), the supervisor supplies
        # the replace primitive + quarantine bookkeeping.  No monitor
        # thread is started — the step loop itself is the failure probe.
        self.supervisor = PilotSupervisor(
            compute=service, manager=self.manager, auto_respawn=False,
            max_respawns=max_recoveries)

    def _ensure_pilot(self) -> PilotCompute:
        if self.pilot is None or self.pilot.state != State.RUNNING:
            self.pilot = self.service.submit_pilot(self.pilot_desc)
        return self.pilot

    def _replace_pilot(self, dead: PilotCompute) -> PilotCompute:
        """Release the corpse and re-provision through the supervision
        layer (quarantine-during-replacement + respawn telemetry), with a
        direct re-provision fallback if the supervisor already handled
        this pilot id."""
        new = self.supervisor.replace_pilot(dead, desc=self.pilot_desc)
        if new is None:
            new = self.service.submit_pilot(self.pilot_desc)
        self.pilot = new
        return new

    def run(self, state, step_fn: Callable, num_steps: int,
            batch_fn: Callable[[int], Any],
            restore_fn: Optional[Callable] = None,
            start_step: int = 0):
        """step_fn(state, batch) -> (state, metrics); batch_fn(i) -> batch.

        restore_fn(like_state) -> (state, step): rebuild device state from the
        checkpoint (injected so the runner stays model-agnostic; the default
        reuses ``state`` as the structure template with no resharding).

        With no checkpoint to restore from, the starting state is saved
        first (at `start_step`): a pilot lost before the first periodic
        checkpoint then resumes from the start, not from the state the
        lost steps had already advanced (the JAX package's runner replays
        those steps on the advanced state).
        """
        step = start_step
        recoveries = 0
        metrics_log = []
        if restore_fn is None and self.ckpt.latest_step() is None:
            self.ckpt.save(start_step, state, blocking=True)
        while step < num_steps:
            pilot = self._ensure_pilot()
            try:
                batch = batch_fn(step)
                desc = ComputeUnitDescription(
                    fn=step_fn, args=(state, batch), name=f"train-step-{step}")
                cu = self.manager.submit(desc)
                state, metrics = cu.future.result(timeout=600)
                metrics_log.append(metrics)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state, blocking=False)
            except Exception:  # noqa: BLE001 - pilot/CU failure path
                recoveries += 1
                if recoveries > self.max_recoveries:
                    raise
                t0 = time.monotonic()
                old_id = pilot.id if pilot else "?"
                new_pilot = self._replace_pilot(pilot)
                if restore_fn is not None:
                    state, restored = restore_fn(state)
                else:
                    self.ckpt.wait()
                    latest = self.ckpt.latest_step()
                    if latest is not None:
                        state, restored = self.ckpt.restore(state)
                    else:
                        restored = start_step
                self.recoveries.append(RecoveryEvent(
                    step=step, old_pilot=old_id, new_pilot=new_pilot.id,
                    restored_step=restored,
                    downtime_s=time.monotonic() - t0))
                step = restored
        self.ckpt.wait()
        return state, metrics_log
