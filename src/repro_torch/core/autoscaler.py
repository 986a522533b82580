"""Elastic autoscaling: grow/shrink the pilot fleet from live load.

The paper's central claim is that the Pilot-Abstraction *dynamically*
allocates and manages resources across heterogeneous infrastructures —
but without this layer the fleet is static after ``add_pilots``: the
supervisor only replaces dead pilots, never resizes the pool.  The
Hadoop-on-HPC follow-up (arXiv:1602.00345) makes pilot-managed *elastic*
resource pools the piece that pays off for bursty data-intensive work;
this module is that control loop:

  * ``ScalingSignals`` — one fused snapshot of everything the fleet
    knows about its own load: the task engine's dispatch backlog and
    accepted-CU counts (through the same backend ``health()`` probe the
    supervisor trusts), per-pilot worker utilization, tier pressure from
    each pilot's ``TierManager`` budgets, and serving queue wait from
    every ``ServingEngine`` registered with the session.

  * ``ScalingPolicy`` / ``LoadScalingPolicy`` — the pluggable decision:
    the default is watermark-based with *hysteresis* (a breach must
    persist for ``hysteresis`` consecutive ticks before acting, so one
    bursty sample never provisions a node) and the Autoscaler adds a
    *cooldown* after every action (a freshly added pilot must get a
    chance to absorb load before the next decision).

  * ``Autoscaler`` — the monitor thread.  Scale-OUT clones a template
    ``PilotComputeDescription`` (default: the current fleet's own)
    through ``session.add_pilot`` — exactly the provision path the
    supervisor's respawn uses, so new pilots join the data service,
    scheduling, and (via the serving reaper's adoption sweep) the
    serving fleet with no extra wiring.  Scale-IN runs the drain
    protocol:

      1. ``SchedulingPolicy.drain(victim)`` — no new CU, engine task, or
         serving request routes to the victim (it stays healthy and
         keeps serving replica reads);
      2. every ``ServingEngine`` hands off the victim's replica —
         in-flight requests are recovered from durable KV pages and
         re-routed exactly like a reaped dead replica;
      3. the victim quiesces: accepted CUs retire, the worker pool's
         backlog drains (bounded by ``drain_timeout_s``);
      4. ``PilotDataService.evacuate_pilot`` migrates or
         checkpoint-flushes every resident partition (priced by the
         InterconnectModel; a partition that cannot be saved ABORTS the
         scale-in);
      5. ``session.release(victim)`` — the supervisor forgets it first,
         so a deliberate release is never mistaken for a death.

    A victim that dies mid-drain (chaos racing the scaler) aborts the
    drain and is left to the supervisor; the next scale-in picks a
    different victim (quarantined and respawn-handled pilots are never
    victims).

Every decision — including rejections — is recorded with the signal
snapshot that drove it and surfaces through ``stats()`` /
``session.stats()["autoscaler"]``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.pilot import PilotCompute, PilotComputeDescription, State

# bounded decision history: enough to audit a long soak, never unbounded
_MAX_DECISIONS = 512


@dataclasses.dataclass
class ScalingSignals:
    """One snapshot of the live-load signals a ScalingPolicy reads."""
    t: float = 0.0                  # wall-clock stamp (telemetry only)
    n_pilots: int = 0               # RUNNING pilots
    queue_depth: int = 0            # task-engine dispatch backlog (sum)
    pending_cus: int = 0            # accepted-but-unfinished classic CUs
    workers: int = 0                # total resident task workers
    load: float = 0.0               # (queue_depth + pending) / workers
    tier_pressure: float = 0.0      # max volatile usage/budget, any pilot
    serving_queued: int = 0         # routed-but-waiting serving requests
    serving_wait_s: float = 0.0     # oldest serving request's queue wait
    per_pilot: Dict[str, float] = dataclasses.field(default_factory=dict)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ScalingDecision:
    """One autoscaler decision (actions AND rejections), with the signal
    values that drove it — the acceptance contract of stats()."""
    t: float
    action: str         # "scale-out"|"scale-in"|"scale-in-aborted"|"reject"
    reason: str
    pilot: str          # newcomer (out) / victim (in) pilot id, "" if none
    signals: dict
    detail: dict = dataclasses.field(default_factory=dict)


class ScalingPolicy:
    """Strategy interface: map one ScalingSignals snapshot to an action.

    ``decide`` returns ``("out" | "in" | "hold", reason)``.  Policies own
    their hysteresis state (consecutive-breach counters); the Autoscaler
    owns cooldown and the min/max clamps."""

    name = "scaling-policy"

    def decide(self, signals: ScalingSignals) -> Tuple[str, str]:
        raise NotImplementedError


class LoadScalingPolicy(ScalingPolicy):
    """Watermark policy with hysteresis.

    Scale OUT when any hot signal breaches for ``hysteresis`` consecutive
    ticks: backlog per worker >= ``scale_out_load``, serving queue wait
    >= ``serving_wait_s``, or volatile tier pressure >= ``tier_pressure``
    (migrate-ahead-of-the-hot-spot: a fleet running out of fast memory
    needs capacity before it starts thrashing the durable tier).

    Scale IN only when EVERY signal is cold for ``in_hysteresis``
    consecutive ticks (default 2x the out hysteresis — releasing a node
    is the expensive mistake): backlog per worker <= ``scale_in_load``,
    no serving queue, and tier pressure below the watermark."""

    name = "load-watermark"

    def __init__(self, scale_out_load: float = 1.5,
                 scale_in_load: float = 0.25,
                 serving_wait_s: float = 0.5,
                 tier_pressure: float = 0.92,
                 hysteresis: int = 2,
                 in_hysteresis: Optional[int] = None):
        if scale_in_load >= scale_out_load:
            raise ValueError(
                f"scale_in_load ({scale_in_load}) must be below "
                f"scale_out_load ({scale_out_load}) — equal watermarks "
                "oscillate")
        self.scale_out_load = float(scale_out_load)
        self.scale_in_load = float(scale_in_load)
        self.serving_wait_s = float(serving_wait_s)
        self.tier_pressure = float(tier_pressure)
        self.hysteresis = max(1, int(hysteresis))
        self.in_hysteresis = (2 * self.hysteresis if in_hysteresis is None
                              else max(1, int(in_hysteresis)))
        self._hot = 0
        self._cold = 0

    def decide(self, s: ScalingSignals) -> Tuple[str, str]:
        hot: List[str] = []
        if s.workers and s.load >= self.scale_out_load:
            hot.append(f"load {s.load:.2f} >= {self.scale_out_load}")
        if s.serving_wait_s >= self.serving_wait_s and s.serving_queued:
            hot.append(f"serving wait {s.serving_wait_s:.2f}s >= "
                       f"{self.serving_wait_s}s")
        if s.tier_pressure >= self.tier_pressure:
            hot.append(f"tier pressure {s.tier_pressure:.2f} >= "
                       f"{self.tier_pressure}")
        if hot:
            self._hot += 1
            self._cold = 0
            if self._hot >= self.hysteresis:
                return "out", "; ".join(hot)
            return "hold", f"hot {self._hot}/{self.hysteresis}: " \
                           + "; ".join(hot)
        self._hot = 0
        cold = (s.load <= self.scale_in_load
                and s.serving_queued == 0
                and s.tier_pressure < self.tier_pressure)
        if cold:
            self._cold += 1
            if self._cold >= self.in_hysteresis:
                return "in", (f"load {s.load:.2f} <= {self.scale_in_load}, "
                              "serving idle")
            return "hold", f"cold {self._cold}/{self.in_hysteresis}"
        self._cold = 0
        return "hold", "in band"


class Autoscaler:
    """The elastic control loop over a PilotSession (see module doc).

    Knobs
    -----
    min_pilots / max_pilots: fleet-size clamps (scale-in never drops the
        fleet below min; scale-out never exceeds max, nor the backend's
        reported ``capacity()``).
    policy: a ScalingPolicy (default LoadScalingPolicy()).
    template: the PilotComputeDescription scale-out clones (default: the
        first running pilot's own description — growth looks exactly
        like the fleet that exists).
    interval_s: monitor tick period.
    cooldown_s: minimum quiet time after any scaling action before the
        policy may act again (manual scale_out/scale_in bypass it).
    drain_timeout_s: bound on the scale-in quiesce phase.

    ``start()`` launches the monitor thread; a bare (unstarted)
    Autoscaler is a valid manual scaler — ``scale_out``/``scale_in`` are
    the public verbs the elastic runtime delegates to.
    """

    def __init__(self, session, *, min_pilots: int = 1, max_pilots: int = 8,
                 policy: Optional[ScalingPolicy] = None,
                 template: Optional[PilotComputeDescription] = None,
                 interval_s: float = 0.05, cooldown_s: float = 0.25,
                 drain_timeout_s: float = 15.0):
        if min_pilots < 1:
            raise ValueError(f"min_pilots must be >= 1, got {min_pilots}")
        if max_pilots < min_pilots:
            raise ValueError(f"max_pilots ({max_pilots}) must be >= "
                             f"min_pilots ({min_pilots})")
        self.session = session
        self.min_pilots = int(min_pilots)
        self.max_pilots = int(max_pilots)
        self.policy = policy or LoadScalingPolicy()
        self.template = template
        self.interval_s = max(0.005, float(interval_s))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.drain_timeout_s = float(drain_timeout_s)
        self.decisions: List[ScalingDecision] = []
        self.counters: Dict[str, int] = {
            "scale_outs": 0, "scale_ins": 0, "aborted_drains": 0,
            "rejects": 0, "ticks": 0}
        self._last_signals: Optional[ScalingSignals] = None
        self._last_action_t = 0.0
        self._lock = threading.Lock()       # decisions/counters
        self._scale_lock = threading.Lock()  # serializes fleet changes
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._started:
            return self
        self._started = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pilot-autoscaler")
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop the monitor (joins the thread, so an in-flight drain
        finishes or aborts before this returns).  Idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    # -- signal collection -----------------------------------------------
    def _running_pilots(self) -> List[PilotCompute]:
        return [p for p in self.session.pilots
                if p.state is State.RUNNING]

    def collect_signals(self) -> ScalingSignals:
        """One fused load snapshot, read through the SAME backend
        ``health()`` probe the supervisor trusts (so a stalled adaptor
        looks as dead to the scaler as to the failure detector)."""
        from repro_torch.core.backends.base import get_backend
        s = ScalingSignals(t=time.time())
        for p in self._running_pilots():
            try:
                h = get_backend(p.desc.backend).health(p)
            except Exception:   # noqa: BLE001 - dying adaptor: skip pilot
                continue
            s.n_pilots += 1
            depth = int(h.get("pool_depth", 0))
            pend = int(h.get("queued", 0)) + int(h.get("busy", False))
            workers = max(1, int(h.get("task_workers", 1)))
            s.queue_depth += depth
            s.pending_cus += pend
            s.workers += workers
            s.per_pilot[p.id] = float(h.get("utilization",
                                            depth + pend)) / workers
            tm = getattr(p, "tier_manager", None)
            if tm is not None:
                try:
                    for tier, st in tm.stats().items():
                        budget = st.get("budget")
                        if tier in ("device", "host") and budget:
                            s.tier_pressure = max(
                                s.tier_pressure, st["usage"] / budget)
                except Exception:   # noqa: BLE001 - closing manager
                    pass
        if s.workers:
            s.load = (s.queue_depth + s.pending_cus) / s.workers
        for eng in list(getattr(self.session, "serving_engines", ())):
            try:
                sl = eng.load()
            except Exception:   # noqa: BLE001 - engine mid-close
                continue
            s.serving_queued += int(sl.get("queued", 0))
            s.serving_wait_s = max(s.serving_wait_s,
                                   float(sl.get("oldest_wait_s", 0.0)))
        with self._lock:
            self._last_signals = s
        return s

    # -- the control loop ------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:   # noqa: BLE001 - loop survives races
                pass

    def _cooling(self) -> bool:
        return (time.monotonic() - self._last_action_t) < self.cooldown_s

    def _tick(self) -> None:
        with self._lock:
            self.counters["ticks"] += 1
        if getattr(self.session, "closed", False):
            return
        signals = self.collect_signals()
        action, reason = self.policy.decide(signals)
        if action == "hold" or self._cooling():
            return
        if action == "out":
            self.scale_out(reason=reason, signals=signals)
        elif action == "in":
            self.scale_in(reason=reason, signals=signals)

    # -- telemetry -------------------------------------------------------
    def _decide(self, action: str, reason: str, pilot: str,
                signals: Optional[ScalingSignals],
                detail: Optional[dict] = None) -> None:
        d = ScalingDecision(
            t=time.time(), action=action, reason=reason, pilot=pilot,
            signals=signals.asdict() if signals is not None else {},
            detail=detail or {})
        with self._lock:
            self.decisions.append(d)
            if len(self.decisions) > _MAX_DECISIONS:
                del self.decisions[:len(self.decisions) - _MAX_DECISIONS]
            if action.startswith("reject"):
                self.counters["rejects"] += 1

    def stats(self) -> dict:
        policy = getattr(self.session.manager, "policy", None)
        with self._lock:
            out = {
                "min_pilots": self.min_pilots,
                "max_pilots": self.max_pilots,
                "policy": self.policy.name,
                "running": len(self._running_pilots()),
                "counters": dict(self.counters),
                "last_signals": (self._last_signals.asdict()
                                 if self._last_signals is not None else {}),
                "decisions": [dataclasses.asdict(d)
                              for d in self.decisions],
            }
        out["draining"] = (sorted(policy.draining)
                           if policy is not None else [])
        return out

    # -- scale-out -------------------------------------------------------
    def scale_out(self, n: int = 1, reason: str = "manual",
                  signals: Optional[ScalingSignals] = None
                  ) -> List[PilotCompute]:
        """Provision up to `n` pilots cloned from the template
        description, clamped by ``max_pilots`` and the backend's
        ``capacity()``.  Returns the pilots actually added (possibly
        empty); every outcome is recorded as a decision."""
        from repro_torch.core.backends.base import get_backend
        if signals is None:
            signals = self.collect_signals()
        added: List[PilotCompute] = []
        for _ in range(max(1, int(n))):
            with self._scale_lock:
                running = self._running_pilots()
                if len(running) >= self.max_pilots:
                    self._decide("reject-out",
                                 f"at max_pilots={self.max_pilots}",
                                 "", signals)
                    break
                desc = self.template or (running[0].desc if running
                                         else None)
                if desc is None:
                    self._decide("reject-out",
                                 "no template description and no running "
                                 "pilot to clone", "", signals)
                    break
                try:
                    cap = get_backend(desc.backend).capacity()
                except Exception:   # noqa: BLE001 - unknown adaptor
                    cap = None
                if cap is not None and cap < 1:
                    self._decide("reject-out",
                                 f"backend {desc.backend!r} at capacity",
                                 "", signals)
                    break
                try:
                    pilot = self.session.add_pilot(desc)
                except RuntimeError:    # session closed under us
                    break
                with self._lock:
                    self.counters["scale_outs"] += 1
                self._last_action_t = time.monotonic()
                self._decide("scale-out", reason, pilot.id, signals)
                added.append(pilot)
        return added

    # -- scale-in (the drain protocol) -----------------------------------
    def _pick_victim(self, running: List[PilotCompute]
                     ) -> Optional[PilotCompute]:
        """Least-loaded healthy pilot that nobody else is handling:
        never a quarantined/suspect pilot, never one whose death the
        supervisor is already respawning (a scale-in racing a chaos kill
        must pick a DISTINCT victim), never one already draining."""
        policy = self.session.manager.policy
        bad = set(policy.quarantined) | set(getattr(policy, "draining",
                                                    frozenset()))
        sup = getattr(self.session, "supervisor", None)
        if sup is not None:
            bad |= set(sup.quarantined) | set(sup.handled)
        cands = [p for p in running if p.id not in bad]
        if not cands:
            return None
        pds = self.session.data_service
        cands.sort(key=lambda p: (p.utilization,
                                  pds.holder_load(p.id)["nbytes"], p.id))
        return cands[0]

    def scale_in(self, victim: Optional[PilotCompute] = None,
                 reason: str = "manual",
                 signals: Optional[ScalingSignals] = None
                 ) -> Optional[PilotCompute]:
        """Drain and release one pilot (the least-loaded eligible one
        unless `victim` is given).  Returns the released pilot, or None
        when nothing was released (at the floor, no eligible victim, or
        the drain aborted — each recorded as a decision)."""
        if signals is None:
            signals = self.collect_signals()
        with self._scale_lock:
            running = self._running_pilots()
            if len(running) <= self.min_pilots:
                self._decide("reject-in",
                             f"at min_pilots={self.min_pilots}", "",
                             signals)
                return None
            if victim is None:
                victim = self._pick_victim(running)
            if victim is None:
                self._decide("reject-in", "no eligible victim "
                             "(quarantined/handled/draining excluded)",
                             "", signals)
                return None
            return self._drain_and_release(victim, reason, signals)

    def _drain_and_release(self, victim: PilotCompute, reason: str,
                           signals: ScalingSignals
                           ) -> Optional[PilotCompute]:
        policy = self.session.manager.policy
        policy.drain(victim.id)
        detail: dict = {"serving_handoff": 0, "evacuated": {}}
        try:
            # 1. serving handoff: retire the victim's replica exactly
            # like the reaper retires a dead one — owed requests recover
            # from durable KV pages and re-route to survivors
            for eng in list(getattr(self.session, "serving_engines", ())):
                try:
                    detail["serving_handoff"] += eng.drain_replica(
                        victim.id)
                except Exception:   # noqa: BLE001 - engine mid-close
                    pass
            # 2. quiesce: accepted CUs retire, the engine backlog drains
            # (no NEW work lands — eligible() excludes draining pilots)
            deadline = time.monotonic() + self.drain_timeout_s
            victim.wait_idle(timeout=max(0.0,
                                         deadline - time.monotonic()))
            pool = getattr(victim, "worker_pool", None)
            while (pool is not None and pool.queue.depth > 0
                   and victim.state is State.RUNNING
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            if victim.state is not State.RUNNING:
                # chaos raced us: the corpse is the supervisor's problem
                with self._lock:
                    self.counters["aborted_drains"] += 1
                self._decide("scale-in-aborted",
                             f"victim died mid-drain ({reason})",
                             victim.id, signals, detail)
                return None
            # 3. migrate or checkpoint-flush every resident partition
            evac = self.session.data_service.evacuate_pilot(victim.id)
            detail["evacuated"] = evac
            if evac.get("failed"):
                with self._lock:
                    self.counters["aborted_drains"] += 1
                self._decide("scale-in-aborted",
                             f"{evac['failed']} partitions not evacuable",
                             victim.id, signals, detail)
                return None
            # 4. release (session forgets it in the supervisor first)
            self.session.release(victim)
            with self._lock:
                self.counters["scale_ins"] += 1
            self._last_action_t = time.monotonic()
            self._decide("scale-in", reason, victim.id, signals, detail)
            return victim
        finally:
            policy.undrain(victim.id)

    def __repr__(self) -> str:
        return (f"Autoscaler(pilots={len(self._running_pilots())}, "
                f"min={self.min_pilots}, max={self.max_pilots}, "
                f"policy={self.policy.name!r}, "
                f"{'running' if self._started and not self._stop.is_set() else 'stopped'})")
