"""Proactive partition rebalancing: migrate data ahead of the hot spot.

Without this layer, partitions only move when a replica *dies* (the
supervisor's repair worker) — placement skew from uneven registration
or a grown fleet (autoscaler scale-out lands an empty pilot next to a
full one) persists until failure.  Xuan et al.'s two-level-storage
work (arXiv:1508.01847) motivates pricing every movement against the
storage hierarchy; this module applies it proactively:

  * detect skew: per-pilot *pressure* = resident partition bytes
    weighted by live worker utilization (a busy pilot's bytes hurt more
    — its workers contend with replica reads);
  * plan: donors above ``skew`` x mean pressure shed their smallest
    partitions first (cheapest wins land earliest) to the
    least-pressured receiver not already holding a replica, each move
    priced by the session's ``InterconnectModel``;
  * execute through the EXISTING ``PilotDataService`` machinery —
    ``replicate`` then ``drop_replica`` — so stripe-locked coherence,
    zero-copy views, and the durable-tier invariants hold for free, and
    the copy lands before the source is dropped (a crash mid-move
    leaves an extra replica, never a missing one).

Quarantined, draining, and avoided pilots are never donors or
receivers: the rebalancer must not read from a suspect or load a pilot
that is on its way out.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.pilot import State

_MAX_LOG = 512


@dataclasses.dataclass
class Migration:
    """One planned partition move (du is the DataUnit name)."""
    du: str
    part: int
    src: str
    dst: str
    nbytes: int
    cost_s: float = 0.0
    status: str = "planned"     # planned | done | skipped | failed


class Rebalancer:
    """Background skew detector + migration planner over a PilotSession.

    ``rebalance_once()`` is the public verb (plan + execute one round);
    ``start()`` runs it periodically.  ``skew`` is the trigger ratio: a
    pilot whose pressure exceeds ``skew`` x the fleet mean donates, up
    to ``max_moves`` migrations per round."""

    def __init__(self, session, *, interval_s: float = 0.5,
                 skew: float = 1.5, max_moves: int = 8,
                 tier: str = "host"):
        if skew <= 1.0:
            raise ValueError(f"skew must be > 1.0, got {skew}")
        self.session = session
        self.interval_s = max(0.01, float(interval_s))
        self.skew = float(skew)
        self.max_moves = max(1, int(max_moves))
        self.tier = tier
        self.counters: Dict[str, int] = {
            "rounds": 0, "migrations": 0, "skipped": 0, "failed": 0,
            "bytes_moved": 0}
        self.migrations: List[dict] = []    # executed-move audit log
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "Rebalancer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pilot-rebalancer")
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.rebalance_once()
            except Exception:   # noqa: BLE001 - loop survives teardown
                pass

    # -- eligibility -----------------------------------------------------
    def _eligible(self) -> List:
        """RUNNING pilots minus quarantined (policy + supervisor),
        draining, and data-service-avoided ones."""
        policy = self.session.manager.policy
        pds = self.session.data_service
        bad = set(policy.quarantined)
        bad |= set(getattr(policy, "draining", frozenset()))
        sup = getattr(self.session, "supervisor", None)
        if sup is not None:
            bad |= set(sup.quarantined) | set(sup.handled)
        bad |= set(getattr(pds, "avoided", frozenset()))
        return [p for p in self.session.pilots
                if p.state is State.RUNNING and p.id not in bad]

    # -- planning --------------------------------------------------------
    def plan(self) -> List[Migration]:
        """Plan (do not execute) one round of migrations."""
        pds = self.session.data_service
        pilots = self._eligible()
        if len(pilots) < 2:
            return []
        loads = {p.id: pds.holder_load(p.id) for p in pilots}
        pressure = {p.id: loads[p.id]["nbytes"] * (1.0 + p.utilization)
                    for p in pilots}
        mean = sum(pressure.values()) / len(pressure)
        if mean <= 0:
            return []
        donors = sorted((pid for pid, pr in pressure.items()
                         if pr > self.skew * mean),
                        key=lambda pid: -pressure[pid])
        receivers = {pid for pid, pr in pressure.items() if pr < mean}
        if not donors or not receivers:
            return []
        ic = getattr(self.session, "interconnect", None)
        plan: List[Migration] = []
        # receivers a partition is already planned onto: two donors of
        # one partition must not both move it to the same receiver (the
        # second move would copy nothing and drop a replica)
        planned: Dict[tuple, set] = {}
        for donor in donors:
            held = []   # (nbytes, du, part) the donor holds live
            for du in pds.data_units():
                for i in range(du.num_partitions):
                    if donor not in pds._live_replicas(du, i):
                        continue
                    try:
                        nb = pds.partition_nbytes(du, i)
                    except Exception:   # noqa: BLE001 - metadata miss
                        nb = 0
                    held.append((nb, du, i))
            held.sort(key=lambda t: (t[0], t[1].name, t[2]))
            for nb, du, i in held:
                if len(plan) >= self.max_moves:
                    return plan
                holders = set(pds._live_replicas(du, i))
                holders |= planned.get((du.name, i), set())
                cands = sorted((r for r in receivers
                                if r != donor and r not in holders),
                               key=lambda r: pressure[r])
                if not cands:
                    continue
                dst = cands[0]
                cost = (ic.transfer_cost(donor, dst, nb)
                        if ic is not None else 0.0)
                plan.append(Migration(du=du.name, part=i, src=donor,
                                      dst=dst, nbytes=nb, cost_s=cost))
                planned.setdefault((du.name, i), set()).add(dst)
                # moved bytes shift pressure: keep later picks honest
                w = 1.0 + next(p.utilization for p in pilots
                               if p.id == dst)
                pressure[dst] += nb * w
                pressure[donor] = max(0.0, pressure[donor] - nb * w)
                if pressure[donor] <= self.skew * mean:
                    break
        return plan

    # -- execution -------------------------------------------------------
    def execute(self, plan: List[Migration]) -> List[Migration]:
        """Run a plan through replicate-then-drop.  A source that became
        quarantined/avoided since planning is skipped — never read from
        a suspect."""
        pds = self.session.data_service
        policy = self.session.manager.policy
        dus = {du.name: du for du in pds.data_units()}
        for m in plan:
            bad = (set(policy.quarantined)
                   | set(getattr(policy, "draining", frozenset()))
                   | set(getattr(pds, "avoided", frozenset())))
            du = dus.get(m.du)
            # a receiver that already holds the partition (a repair or an
            # earlier move put it there) gets no copy, so the source must
            # keep its replica: dropping it would lose one
            if (du is None or m.src in bad or m.dst in bad
                    or m.dst in pds._live_replicas(du, m.part)):
                m.status = "skipped"
                with self._lock:
                    self.counters["skipped"] += 1
                continue
            try:
                pds.replicate(du, m.part, m.dst, self.tier)
                pds.drop_replica(du, m.part, m.src)
            except Exception:   # noqa: BLE001 - capacity/lost races
                m.status = "failed"
                with self._lock:
                    self.counters["failed"] += 1
                continue
            m.status = "done"
            with self._lock:
                self.counters["migrations"] += 1
                self.counters["bytes_moved"] += m.nbytes
                self.migrations.append(dataclasses.asdict(m))
                if len(self.migrations) > _MAX_LOG:
                    del self.migrations[:len(self.migrations) - _MAX_LOG]
        return plan

    def rebalance_once(self) -> List[Migration]:
        with self._lock:
            self.counters["rounds"] += 1
        return self.execute(self.plan())

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "skew": self.skew,
                "max_moves": self.max_moves,
                "tier": self.tier,
                "counters": dict(self.counters),
                "migrations": list(self.migrations),
                "running": self._thread is not None
                           and not self._stop.is_set(),
            }

    def __repr__(self) -> str:
        return (f"Rebalancer(skew={self.skew}, "
                f"moves={self.counters['migrations']}, "
                f"bytes={self.counters['bytes_moved']})")
