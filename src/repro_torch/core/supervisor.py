"""Self-healing sessions: heartbeat failure detection, respawn, repair.

The paper's core robustness claim (§3) is that the Pilot-Abstraction
decouples system-level resource allocation from application progress:
losing a pilot never loses work past the durable tier.  Through PR 6 the
repo only *reacted* to failure — map_reduce re-bound groups after their
CU raised, but nothing noticed a dead pilot before a task hit it, nothing
replaced the lost capacity (the Hadoop-on-HPC follow-up, arXiv:1602.00345,
makes dynamic re-provisioning the recovery mechanism), and a partition
whose replicas lived on the dead node silently ran at lower redundancy.
This module is the supervision layer that closes those gaps:

  * ``FailureDetector`` — phi-accrual-style suspicion over heartbeats.
    Every pilot's worker loop stamps a monotonic heartbeat (see
    ``PilotCompute.beat``); the backend exposes it through ``health()``.
    The detector keeps an EWMA of observed beat intervals per pilot and
    scores the current silence as ``phi = age / mean_interval`` — a
    unitless suspicion level that self-calibrates to however fast this
    substrate actually beats.  ``phi >= suspect_phi`` quarantines the
    pilot (no new work routed to it, replication repair refuses to read
    from it) and ``phi >= dead_phi`` — or a terminal pilot state —
    confirms death.  A quarantined pilot whose heartbeats resume is
    readmitted: suspicion is a reversible state, death is not.

  * ``PilotSupervisor`` — the monitor thread driving the detector over a
    session (or a bare service+manager pair).  On suspicion it excludes
    the pilot from the ``SchedulingPolicy`` (quarantine) *before* any
    further task is late-bound onto it; on confirmed death it
    re-provisions a replacement from the dead pilot's own
    ``PilotComputeDescription`` through ``PilotSession.add_pilot`` (so
    the new pilot re-registers its TierManager with the data service and
    rejoins scheduling), then readmits the dead id so the registry stays
    clean.  Respawn events are recorded for ``stats()`` and bounded by
    ``max_respawns`` so a crash-looping substrate cannot spin forever.

  * replication-factor repair — delegated to
    ``PilotDataService.start_repair``: DataUnits registered with a target
    ``replication`` are re-replicated from surviving replicas or the
    durable checkpoint tier whenever a pilot loss (or eviction) drops
    them below target.  The supervisor starts/stops the repair worker
    and feeds it the quarantine set so repair never reads a suspect.

  * ``Backoff`` — bounded exponential backoff with full jitter, shared
    by every hardened retry path (``result_with_retry``, the task-engine
    re-bind, map_reduce group retries, late-binding polls) so a fleet of
    retrying clients does not synchronize into thundering herds.

The seed-era ``repro.runtime.fault_tolerance.ResilientRunner`` is rebuilt
on this layer: its release/re-provision step is ``replace_pilot`` here.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.pilot import PilotCompute, State


# -- bounded exponential backoff with jitter --------------------------------
@dataclasses.dataclass(frozen=True)
class Backoff:
    """Delay schedule for retries: ``base * factor**attempt``, capped at
    ``cap``, with full jitter (uniform in [delay*(1-jitter), delay]) so
    concurrent retriers spread out instead of stampeding in lockstep.
    Frozen: one instance is safely shared across threads."""

    base_s: float = 0.01
    cap_s: float = 0.5
    factor: float = 2.0
    jitter: float = 0.5

    def delay(self, attempt: int) -> float:
        """The (jittered) delay before retry number `attempt` (0-based)."""
        d = min(self.cap_s, self.base_s * self.factor ** max(0, attempt))
        if self.jitter <= 0:
            return d
        lo = d * (1.0 - min(1.0, self.jitter))
        return random.uniform(lo, d)

    def sleep(self, attempt: int) -> float:
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)
        return d


# retry-path defaults: small bases so test suites stay fast, caps bound the
# worst case (a worker thread re-binding a task must never stall its chunk
# for long; a map_reduce attempt can afford a slightly longer breath)
REBIND_BACKOFF = Backoff(base_s=0.005, cap_s=0.1)
RETRY_BACKOFF = Backoff(base_s=0.02, cap_s=0.5)
# late-binding poll: starts near the old fixed 10ms, grows to a bounded tick
POLL_BACKOFF = Backoff(base_s=0.005, cap_s=0.05, jitter=0.3)


# -- failure detection -------------------------------------------------------
class FailureDetector:
    """Phi-accrual-style heartbeat suspicion (per pilot).

    ``observe(pid, last_beat, now)`` feeds one health sample (the pilot's
    most recent monotonic heartbeat stamp); the detector maintains an
    EWMA of the intervals *between distinct beats* it has seen.
    ``phi(pid, now)`` is the current silence measured in units of that
    mean interval — 1.0 means "exactly as late as usual", 4.0 means "4x
    the usual gap".  The floor ``min_interval_s`` keeps a fast-beating
    pilot from tripping on scheduler noise.
    """

    def __init__(self, min_interval_s: float = 0.1, alpha: float = 0.3):
        self.min_interval_s = max(1e-4, float(min_interval_s))
        self.alpha = alpha
        self._last: Dict[str, float] = {}    # pilot -> last beat stamp seen
        self._mean: Dict[str, float] = {}    # pilot -> EWMA beat interval
        self._lock = threading.Lock()

    def observe(self, pid: str, last_beat: float, now: float) -> None:
        with self._lock:
            prev = self._last.get(pid)
            if prev is None:
                self._last[pid] = last_beat
                return
            if last_beat > prev:
                interval = last_beat - prev
                m = self._mean.get(pid)
                self._mean[pid] = (interval if m is None else
                                   (1 - self.alpha) * m
                                   + self.alpha * interval)
                self._last[pid] = last_beat

    def phi(self, pid: str, now: float) -> float:
        with self._lock:
            last = self._last.get(pid)
            if last is None:
                return 0.0
            mean = max(self._mean.get(pid, self.min_interval_s),
                       self.min_interval_s)
        return max(0.0, now - last) / mean

    def forget(self, pid: str) -> None:
        with self._lock:
            self._last.pop(pid, None)
            self._mean.pop(pid, None)


@dataclasses.dataclass
class RespawnEvent:
    """One completed pilot replacement (telemetry for stats())."""
    old_pilot: str
    new_pilot: str      # "" when the respawn was aborted (session closed)
    reason: str         # "state:Failed" | "phi" | "manual" | ...
    downtime_s: float
    t: float            # wall-clock stamp (telemetry only)


class PilotSupervisor:
    """Monitor thread making a pilot fleet self-healing (see module doc).

    Construct over a ``PilotSession`` (the normal path — sessions build
    one with ``supervise=True``) or over bare parts::

        sup = PilotSupervisor(compute=service, manager=manager)

    Knobs
    -----
    interval_s: monitor poll period.
    suspect_phi / dead_phi: suspicion thresholds (units of the pilot's
        own mean heartbeat interval).  A busy pilot stuck in one long CU
        is *suspected* (quarantined) but never phi-confirmed dead while
        it reports ``busy`` — slow work is a straggler problem, not node
        death; terminal pilot *state* confirms death regardless.
    max_respawns: lifetime cap on automatic replacements.
    auto_respawn: False turns the supervisor into detect/quarantine-only
        (the ResilientRunner drives ``replace_pilot`` itself).
    repair_interval_s: period of the data service's replication-repair
        worker (started by ``start()`` when a data service is present).
    """

    def __init__(self, session=None, *, compute=None, manager=None,
                 data_service=None, interval_s: float = 0.05,
                 min_heartbeat_s: float = 0.1,
                 suspect_phi: float = 4.0, dead_phi: float = 30.0,
                 max_respawns: int = 8, auto_respawn: bool = True,
                 repair_interval_s: float = 0.1,
                 backoff: Backoff = RETRY_BACKOFF):
        self.session = session
        self.compute = compute if compute is not None else getattr(
            session, "compute", None)
        self.manager = manager if manager is not None else getattr(
            session, "manager", None)
        self.data_service = data_service if data_service is not None \
            else getattr(session, "data_service", None)
        if self.compute is None:
            raise ValueError("PilotSupervisor needs a session or compute=")
        self.interval_s = max(0.005, float(interval_s))
        self.suspect_phi = float(suspect_phi)
        self.dead_phi = float(dead_phi)
        self.max_respawns = int(max_respawns)
        self.auto_respawn = auto_respawn
        self.repair_interval_s = repair_interval_s
        self.backoff = backoff
        self.detector = FailureDetector(min_interval_s=min_heartbeat_s)
        self.respawns: List[RespawnEvent] = []
        self.events: List[dict] = []
        self._quarantined: set = set()
        self._handled: set = set()      # dead pilots already replaced
        self._forgotten: set = set()    # deliberately released pilots
        self._phi: Dict[str, float] = {}
        self._hb_age: Dict[str, float] = {}
        self._respawn_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "PilotSupervisor":
        if self._started:
            return self
        self._started = True
        if self.data_service is not None and hasattr(self.data_service,
                                                     "start_repair"):
            self.data_service.start_repair(interval_s=self.repair_interval_s)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pilot-supervisor")
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop monitoring (joins the thread, so any in-flight respawn
        completes or aborts before this returns) and stop the repair
        worker.  Idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        if self.data_service is not None and hasattr(self.data_service,
                                                     "stop_repair"):
            self.data_service.stop_repair()

    def forget(self, pilot_id: str) -> None:
        """Stop supervising a pilot (called before a deliberate release,
        so a mid-teardown CANCELED state is not mistaken for death)."""
        self._forgotten.add(pilot_id)
        self._readmit(pilot_id)
        self.detector.forget(pilot_id)

    # -- quarantine plumbing ---------------------------------------------
    def _quarantine(self, pid: str, why: str) -> None:
        if pid in self._quarantined:
            return
        self._quarantined.add(pid)
        policy = getattr(self.manager, "policy", None)
        if policy is not None:
            policy.quarantine(pid)
        ds = self.data_service
        if ds is not None and hasattr(ds, "avoid_pilot"):
            ds.avoid_pilot(pid)
        self.events.append({"op": "quarantine", "pilot": pid, "why": why,
                            "t": time.time()})

    def _readmit(self, pid: str) -> None:
        if pid not in self._quarantined:
            return
        self._quarantined.discard(pid)
        policy = getattr(self.manager, "policy", None)
        if policy is not None:
            policy.readmit(pid)
        ds = self.data_service
        if ds is not None and hasattr(ds, "readmit_pilot"):
            ds.readmit_pilot(pid)
        self.events.append({"op": "readmit", "pilot": pid,
                            "t": time.time()})

    @property
    def quarantined(self) -> frozenset:
        return frozenset(self._quarantined)

    @property
    def handled(self) -> frozenset:
        """Dead pilots this supervisor has already replaced (or given up
        on): the autoscaler must never pick one as a scale-in victim —
        respawn and scale-out share the provision path, not the corpse."""
        return frozenset(self._handled)

    # -- the monitor loop ------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:   # noqa: BLE001 - monitor must survive races
                pass

    def _tick(self) -> None:
        from repro_torch.core.backends.base import get_backend
        now = time.monotonic()
        for pilot in list(self.compute.pilots.values()):
            pid = pilot.id
            if pid in self._forgotten or pid in self._handled:
                continue
            try:
                h = get_backend(pilot.desc.backend).health(pilot)
            except Exception:   # noqa: BLE001 - unhealthy adaptor == dead
                h = {"alive": False, "busy": False,
                     "last_heartbeat": 0.0}
            self.detector.observe(pid, float(h.get("last_heartbeat", 0.0)),
                                  now)
            phi = self.detector.phi(pid, now)
            self._phi[pid] = phi
            self._hb_age[pid] = float(h.get("heartbeat_age_s", 0.0))
            if not h.get("alive", False):
                self._on_dead(pilot, f"state:{h.get('state')}")
            elif phi >= self.dead_phi and not h.get("busy", False):
                self._on_dead(pilot, f"phi:{phi:.1f}")
            elif phi >= self.suspect_phi:
                self._quarantine(pid, f"phi:{phi:.1f}")
            else:
                self._readmit(pid)      # beats resumed: suspicion lifts

    def _on_dead(self, pilot: PilotCompute, reason: str) -> None:
        # quarantine FIRST: between confirmation and replacement no task
        # may late-bind onto the corpse
        self._quarantine(pilot.id, reason)
        if not self.auto_respawn:
            return
        if len(self.respawns) >= self.max_respawns:
            self.events.append({"op": "respawn-budget-exhausted",
                                "pilot": pilot.id, "t": time.time()})
            self._handled.add(pilot.id)
            return
        self.replace_pilot(pilot, reason=reason)

    # -- respawn ---------------------------------------------------------
    def replace_pilot(self, dead: PilotCompute,
                      desc=None, reason: str = "manual"
                      ) -> Optional[PilotCompute]:
        """Re-provision a replacement for `dead` from its own description
        (deregistering the corpse from the data service and the fleet
        first, so its replicas leave the registry before the new pilot
        joins).  Returns the new pilot, or None when the session closed
        under us — the one caller-visible race ``session.close()`` during
        an in-flight respawn can produce, by design."""
        with self._respawn_lock:
            if dead.id in self._handled:
                return None
            self._handled.add(dead.id)
            t0 = time.monotonic()
            new: Optional[PilotCompute] = None
            try:
                if self.session is not None:
                    new = self.session.respawn_pilot(dead)
                else:
                    ds = self.data_service
                    if ds is not None:
                        ds.unregister_pilot(dead.id)
                    try:
                        self.compute.release(dead)
                    except Exception:   # noqa: BLE001 - corpse teardown
                        pass
                    new = self.compute.submit_pilot(desc or dead.desc)
                    if (ds is not None
                            and getattr(new, "tier_manager", None)
                            is not None):
                        ds.register_pilot(new)
            except RuntimeError:
                new = None              # session closed mid-respawn
            finally:
                # the dead id leaves quarantine either way: the registry
                # must not accumulate ids of pilots that no longer exist
                self._readmit(dead.id)
                self.detector.forget(dead.id)
                ev = RespawnEvent(
                    old_pilot=dead.id,
                    new_pilot=new.id if new is not None else "",
                    reason=reason, downtime_s=time.monotonic() - t0,
                    t=time.time())
                self.respawns.append(ev)
                self.events.append({"op": "respawn", "old": ev.old_pilot,
                                    "new": ev.new_pilot, "why": reason,
                                    "t": ev.t})
        return new

    # -- telemetry -------------------------------------------------------
    def stats(self) -> dict:
        """Live supervision view: per-pilot heartbeat age + suspicion,
        the quarantine set, respawn history, and the data service's
        repair-queue depth / per-partition replication levels."""
        pilots = {}
        for pilot in list(self.compute.pilots.values()):
            pid = pilot.id
            pilots[pid] = {
                "state": getattr(pilot.state, "value", str(pilot.state)),
                "heartbeat_age_s": round(self._hb_age.get(pid, 0.0), 4),
                "phi": round(self._phi.get(pid, 0.0), 2),
                "quarantined": pid in self._quarantined,
            }
        out = {
            "pilots": pilots,
            "quarantined": sorted(self._quarantined),
            "respawns": [dataclasses.asdict(ev) for ev in self.respawns],
        }
        ds = self.data_service
        if ds is not None and hasattr(ds, "repair_queue_depth"):
            out["repair_queue_depth"] = ds.repair_queue_depth
            out["replication"] = ds.replication_stats()
        return out

    def __repr__(self) -> str:
        return (f"PilotSupervisor(pilots={len(self.compute.pilots)}, "
                f"quarantined={len(self._quarantined)}, "
                f"respawns={len(self.respawns)}, "
                f"{'running' if self._started and not self._stop.is_set() else 'stopped'})")
