"""Simulated-cluster backend: provisioning latency, faults, stragglers.

The port of ``repro/core/backends/simulated.py``.  What differs from the
JAX package: a pilot leases torch devices the way the in-process adaptor
does (``inprocess._pool``: every card of the description's device type,
or the one host device; pilots oversubscribe a card) instead of building
a ``jax.sharding.Mesh``, and its managed memory sits on ``devices[0]``.
The description's device is resolved at construction (cuda, or a raise
without CUDA); the CPU is used only where the description asks for it.

Plays two roles:
1. The paper's Fig. 6 startup-overhead study: each simulated substrate
   (slurm / yarn / spark / cloud) carries a provisioning-latency model taken
   from the paper's observations (YARN two-stage AM+container allocation is
   the slowest; HPC pilot agent startup next; warm Spark cluster fastest).
2. A fault/straggler harness for the runtime layer: CUs can be delayed
   (straggler) or failed (node loss) by an injected policy, which the
   fault-tolerance tests drive deterministically.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

from repro_torch.core.backends.base import ComputeBackend, register_backend
from repro_torch.core.backends.inprocess import _pool
from repro_torch.core.device import resolve_device
from repro_torch.core.pilot import (ComputeUnit, PilotCompute,
                                    PilotComputeDescription, State)

# provisioning latency models (seconds): (fixed, per_device) — scaled down
# 100x from the paper's observed seconds so test suites stay fast; the
# *ratios* between substrates are what Fig. 6 compares.
SUBSTRATES: Dict[str, tuple] = {
    "slurm": (0.20, 0.002),      # HPC scheduler + pilot agent bootstrap
    "yarn": (0.45, 0.004),       # AM container + worker containers (2-stage)
    "mesos": (0.30, 0.003),
    "spark": (0.35, 0.003),      # driver + executors on HPC (Pilot-Hadoop)
    "cloud": (0.60, 0.006),      # VM boot dominates
}


@dataclasses.dataclass
class FaultPolicy:
    fail_cu_ids: frozenset = frozenset()       # CU ids to fail once
    straggle_cu_ids: frozenset = frozenset()   # CU ids to delay
    straggle_seconds: float = 0.5
    fail_devices_at: Optional[int] = None      # fail pilot after N CUs
    lose_memory: bool = False                  # node loss wipes the pilot's
    #                                            volatile tiers (device/host)
    #                                            — only checkpoint survives


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault.  `at_s` is relative to the target pilot's own
    start; actions:

      * ``kill``  — the pilot's node dies: state -> FAILED, and (with
        ``lose_memory``) its volatile tiers are wiped.  Permanent.
      * ``stall`` — the pilot looks alive (state RUNNING) but its
        heartbeat freezes for ``duration_s``: the grey failure the phi
        detector exists for.  Heartbeats resume afterwards.
      * ``slow``  — every CU pays an extra ``severity`` seconds while the
        window is open (a degraded node, not a dead one).
    """
    at_s: float
    action: str                  # "kill" | "stall" | "slow"
    duration_s: float = 0.5      # stall/slow window length
    severity: float = 0.05       # slow: extra seconds per CU

    def __post_init__(self):
        if self.action not in ("kill", "stall", "slow"):
            raise ValueError(f"ChaosEvent: unknown action {self.action!r}")


@dataclasses.dataclass
class ChaosPolicy(FaultPolicy):
    """FaultPolicy plus a schedule of pilot-level chaos.  Events apply to
    the `target_index`-th pilot this backend provisions (0-based), so a
    respawned replacement — provisioned later — is never re-targeted and
    recovery can actually converge.  Events fire lazily from the pilot's
    execute path and from every ``health()`` probe; no extra threads."""
    events: tuple = ()           # Tuple[ChaosEvent, ...]
    target_index: int = 0


class SimulatedPilot(PilotCompute):
    def __init__(self, desc, devices, policy: FaultPolicy):
        super().__init__(desc, devices)
        self.policy = policy
        self._failed_once: set = set()
        # chaos state: armed by the backend on the target pilot only
        self.chaos_events: tuple = ()
        self._chaos_origin = time.monotonic()
        self._chaos_fired: set = set()
        self._stall_frozen: Optional[float] = None
        self._stall_until: float = 0.0
        self._slow_until: float = 0.0
        self._slow_severity: float = 0.0

    # -- chaos -----------------------------------------------------------
    def arm_chaos(self, events) -> None:
        self.chaos_events = tuple(events)
        self._chaos_origin = time.monotonic()

    def _apply_chaos(self) -> None:
        """Fire every due, unfired event.  Called from the execute path
        and from each health() probe, so a kill lands even on an idle
        pilot (the monitor's probe is what discovers the corpse)."""
        if not self.chaos_events:
            return
        now = time.monotonic()
        elapsed = now - self._chaos_origin
        for i, ev in enumerate(self.chaos_events):
            if i in self._chaos_fired or elapsed < ev.at_s:
                continue
            self._chaos_fired.add(i)
            if ev.action == "kill":
                self.state = State.FAILED
                if self.policy.lose_memory and self.tier_manager is not None:
                    self.tier_manager.lose_volatile()
            elif ev.action == "stall":
                self._stall_frozen = self._last_heartbeat
                self._stall_until = now + ev.duration_s
            elif ev.action == "slow":
                self._slow_until = now + ev.duration_s
                self._slow_severity = ev.severity

    @property
    def last_heartbeat(self) -> float:
        # a stalled pilot's loop keeps running but its liveness signal
        # freezes — exactly what a wedged remote agent looks like
        if (self._stall_frozen is not None
                and time.monotonic() < self._stall_until):
            return self._stall_frozen
        return self._last_heartbeat

    def _execute(self, cu: ComputeUnit):
        self._apply_chaos()
        if (self.policy.fail_devices_at is not None
                and self._completed >= self.policy.fail_devices_at
                and self.state == State.RUNNING):
            self.state = State.FAILED  # simulated node loss
            if self.policy.lose_memory and self.tier_manager is not None:
                # a dead node's RAM and HBM are gone; partitions the pilot
                # had demoted to the durable checkpoint tier survive and
                # stay readable (the recovery path the retry tests assert)
                self.tier_manager.lose_volatile()
        if self.state == State.FAILED:
            cu.state = State.FAILED
            cu.future.set_exception(
                RuntimeError(f"pilot {self.id} lost its devices (simulated)"))
            cu.end_time = time.monotonic()
            return
        if time.monotonic() < self._slow_until:
            time.sleep(self._slow_severity)     # degraded-node tax per CU
        if cu.id in self.policy.straggle_cu_ids:
            # straggling CU occupies the pilot (visible to the scheduler's
            # utilization score and the straggler monitor)
            cu.start_time = cu.start_time or time.monotonic()
            with self._lock:
                self._running += 1
            try:
                time.sleep(self.policy.straggle_seconds)
            finally:
                with self._lock:
                    self._running -= 1
        if cu.id in self.policy.fail_cu_ids and cu.id not in self._failed_once:
            self._failed_once.add(cu.id)
            cu.state = State.FAILED
            cu.future.set_exception(
                RuntimeError(f"CU {cu.id} failed (simulated)"))
            cu.end_time = time.monotonic()
            return
        super()._execute(cu)


class SimulatedClusterBackend(ComputeBackend):
    """A simulated substrate.  ``use_devices=False`` provisions a pilot
    with no device (its CUs run on the host thread, with no current CUDA
    device); with devices, a pilot leases ``num_devices`` of the
    description's device type, sharing them with every other pilot."""
    name = "simulated"

    def __init__(self, substrate: str = "yarn",
                 policy: Optional[FaultPolicy] = None, use_devices: bool = True,
                 max_pilots: Optional[int] = None):
        self.substrate = substrate
        self.policy = policy or FaultPolicy()
        self.use_devices = use_devices
        self.max_pilots = max_pilots     # simulated queue/allocation limit
        self._provisioned = 0    # chaos targeting is by provision order
        self._lock = threading.Lock()

    def capacity(self):
        """Remaining simulated allocation (LRMS queue limit), counted by
        lifetime provisions like chaos targeting; None = unbounded."""
        if self.max_pilots is None:
            return None
        return max(0, self.max_pilots - self._provisioned)

    def provision(self, desc: PilotComputeDescription) -> PilotCompute:
        t0 = time.time()
        fixed, per_dev = SUBSTRATES.get(self.substrate, (0.2, 0.002))
        wait = desc.startup_seconds or (fixed + per_dev * desc.num_devices)
        time.sleep(min(wait, 2.0))
        device = resolve_device(desc.device)    # cuda, or a raise
        devices = []
        if self.use_devices:
            pool = _pool(device)
            devices = pool[:max(1, min(desc.num_devices, len(pool)))]
        pilot = SimulatedPilot(desc, devices, self.policy)
        # same per-pilot managed memory as the inprocess adaptor (one
        # shared provisioning path in ComputeBackend), so simulated
        # substrates participate in replica-aware scheduling /
        # multi-pilot Pilot-Data exactly like real ones; without devices
        # the device tier follows the description's device
        self.attach_managed_memory(
            pilot, desc, device=devices[0] if devices else device)
        # same shared worker-pool provisioning as inprocess: simulated
        # pilots serve the batched task engine too (fault tests drive it)
        self.attach_worker_pool(pilot, desc)
        # chaos schedule applies to exactly the target_index-th provision:
        # the replacement pilot a supervisor respawns is NOT re-targeted.
        # Provisions may run concurrently (autoscaler and supervisor
        # threads), so the order is taken under a lock
        with self._lock:
            index = self._provisioned
            self._provisioned += 1
        if (isinstance(self.policy, ChaosPolicy) and self.policy.events
                and index == self.policy.target_index):
            pilot.arm_chaos(self.policy.events)
        pilot.start()
        pilot.provision_time = time.time() - t0
        return pilot

    def health(self, pilot: PilotCompute) -> dict:
        # fire due chaos first, so the probe itself discovers a scheduled
        # kill/stall even when no CU has touched the pilot
        if isinstance(pilot, SimulatedPilot):
            pilot._apply_chaos()
        return super().health(pilot)


register_backend(SimulatedClusterBackend())
