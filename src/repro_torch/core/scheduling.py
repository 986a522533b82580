"""Pluggable CU-placement policies + the cost-modelled interconnect.

Paper §3.3 / Fig. 5: the Compute-Data-Manager assigns Compute-Units to
Pilots "taking into account the current available Pilots, their
utilization and data locality".  Through PR 4 that sentence was six
hardcoded ``W_*`` constants inside ``manager.py``; this module makes it a
strategy:

  * ``SchedulingPolicy`` — the interface the ComputeDataManager drives:
    ``score(pilot, cu_desc)`` and ``select(pilots, cu_desc)`` (which also
    *returns* the winning score, so the submit path never pays for the
    same scan twice);
  * ``LocalityPolicy`` — the default.  With default ``LocalityWeights``
    it reproduces the historical W_DEVICE/W_AFFINITY/W_HOST/W_CKPT/
    W_LOCAL/W_QUEUE scoring bit-for-bit (asserted by
    tests/test_scheduling.py); non-default weights or a subclass make
    every future policy (rebalancing, utilization-aware placement) a
    plug-in instead of another constant;
  * ``InterconnectModel`` — per-link bandwidth (GB/s) + latency between
    pilots, plus a model of the home/checkpoint re-pull path.  The
    PilotDataService consults it on every fetch: a CU bound to pilot A
    reads a partition from sibling pilot B's replica exactly when the
    modelled link cost beats re-pulling from the home store (the
    ROADMAP's cross-pilot replica reads).  A ``LocalityPolicy`` built
    with an interconnect additionally credits pilots whose missing
    partitions are one cheap link away from a sibling replica
    (``weights.sibling``) — with no interconnect attached that term is
    inert and parity with the historical constants is exact.

The module is dependency-light on purpose (pilots and DataUnits are duck
typed), so policies can be unit-tested without provisioning anything.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# The historical locality weights (device residency dominates, as
# HBM>host>disk; W_CKPT ranks checkpoint-tier residency below host but
# above absent; W_LOCAL rewards any-tier replica stickiness).  Kept as
# module constants because they are the documented default contract —
# LocalityPolicy() must score exactly what manager.py scored before the
# policy extraction.
W_DEVICE, W_AFFINITY, W_HOST, W_CKPT, W_LOCAL, W_QUEUE = (
    100.0, 10.0, 5.0, 3.0, 2.0, 1.0)
# Sibling-replica credit: only active when a LocalityPolicy carries an
# InterconnectModel, and deliberately below W_LOCAL — a cheap link to
# someone else's replica is better than nothing but never beats holding
# the bytes yourself.
W_SIBLING = 1.0


@dataclasses.dataclass(frozen=True)
class LocalityWeights:
    """The scoring coefficients of LocalityPolicy (defaults = the
    historical constants; every term documented in manager.py's score)."""
    device: float = W_DEVICE
    affinity: float = W_AFFINITY
    host: float = W_HOST
    checkpoint: float = W_CKPT
    local: float = W_LOCAL
    queue: float = W_QUEUE
    sibling: float = W_SIBLING


# guards lazy creation of per-policy quarantine/drain state: SchedulingPolicy
# deliberately has no __init__ (subclasses in the wild don't call super()),
# so the sets are attached on first use under this module lock instead
_QUARANTINE_INIT_LOCK = threading.Lock()


class SchedulingPolicy:
    """Strategy interface for CU-over-pilot placement.

    Implementations score a (pilot, cu_desc) pair; higher wins.  `select`
    is the one call sites use: it returns BOTH the winning pilot and its
    score so the caller can record the decision without re-scoring
    (scoring scans every input DU's partitions, so on the submit hot path
    it scales with pilots x DUs x partitions).

    Every policy additionally carries a *quarantine* set — pilot ids a
    supervisor has marked suspect or dead.  ``eligible()`` filters them
    out and is what every placement call site consults first; it fails
    CLOSED (quarantining the whole fleet yields an empty eligible list,
    making late binding wait for a respawn rather than routing work onto
    a suspect).  Quarantine is reversible: ``readmit()`` lifts it when
    heartbeats resume.

    A parallel *draining* set serves the autoscaler's scale-in protocol:
    ``drain()`` quiesces scheduling on a victim pilot — ``eligible()``
    stops returning it, so no new CU, engine task, or serving request
    routes there — while the pilot itself stays healthy, keeps executing
    its accepted backlog, and keeps serving replica reads until its
    partitions have migrated.  ``undrain()`` lifts it (a drain aborted by
    a racing failure hands the pilot back to normal scheduling)."""

    name = "policy"

    # -- quarantine (supervisor-driven liveness filter) ------------------
    def _qset(self) -> set:
        q = getattr(self, "_quarantined", None)
        if q is None:
            with _QUARANTINE_INIT_LOCK:
                q = getattr(self, "_quarantined", None)
                if q is None:
                    q = set()
                    self._quarantined = q
        return q

    def quarantine(self, pilot_id: str) -> None:
        """Exclude a pilot from placement until readmitted."""
        self._qset().add(pilot_id)

    def readmit(self, pilot_id: str) -> None:
        self._qset().discard(pilot_id)

    @property
    def quarantined(self) -> frozenset:
        return frozenset(self._qset())

    # -- draining (autoscaler-driven scale-in quiesce) -------------------
    def _dset(self) -> set:
        d = getattr(self, "_draining", None)
        if d is None:
            with _QUARANTINE_INIT_LOCK:
                d = getattr(self, "_draining", None)
                if d is None:
                    d = set()
                    self._draining = d
        return d

    def drain(self, pilot_id: str) -> None:
        """Quiesce scheduling on a pilot ahead of scale-in: no new work
        routes to it, but it stays healthy and finishes its backlog."""
        self._dset().add(pilot_id)

    def undrain(self, pilot_id: str) -> None:
        self._dset().discard(pilot_id)

    @property
    def draining(self) -> frozenset:
        return frozenset(self._dset())

    def eligible(self, pilots: Sequence) -> List:
        """`pilots` minus the quarantined and draining ones.  Fails
        closed: may be empty — the caller must wait/retry, never fall
        back to a suspect (or route fresh work onto a draining victim)."""
        q = self._qset()
        d = self._dset()
        if not q and not d:
            return list(pilots)
        return [p for p in pilots if p.id not in q and p.id not in d]

    def score(self, pilot, cu_desc) -> float:
        raise NotImplementedError

    def select(self, pilots: Sequence, cu_desc) -> Tuple[object, float]:
        """Best-scoring pilot and its score (first wins ties, matching the
        historical ``max()`` semantics).  `pilots` must be non-empty."""
        if not pilots:
            raise ValueError("select() needs at least one pilot")
        best, best_s = None, float("-inf")
        for p in pilots:
            s = self.score(p, cu_desc)
            if best is None or s > best_s:
                best, best_s = p, s
        return best, best_s

    # -- batch plane (the task engine's path) ---------------------------
    def score_batch(self, pilot, cu_descs: Sequence) -> List[float]:
        """Scores of `cu_descs` on one pilot.  The default is N single
        scores — bit-for-bit the sequential result — so every policy gets
        the batched surface for free; policies override to amortize
        (LocalityPolicy memoizes identical descriptions)."""
        return [self.score(pilot, d) for d in cu_descs]

    def select_batch(self, pilots: Sequence,
                     cu_descs: Sequence) -> List[Tuple[object, float]]:
        """Placements for a whole batch: one (pilot, score) per
        description, in order.  The default is N sequential ``select``
        calls; LocalityPolicy overrides with one score_batch pass per
        pilot plus an incremental queue-penalty model."""
        return [self.select(pilots, d) for d in cu_descs]


class LocalityPolicy(SchedulingPolicy):
    """The default data-locality policy (see manager.py's module
    docstring for the accelerator adaptation of the paper's locality argument).

    Scoring, per input DataUnit:

      * bound to a PilotDataService and the pilot participates: per-pilot
        replica residency — ``device*dev/n + host*host/n + ckpt*ckpt/n +
        local*any/n`` (one registry scan yields all four terms).  When
        this policy carries an InterconnectModel, the partitions the
        pilot does NOT hold but a *sibling* pilot does are additionally
        credited ``sibling * home_cost/(link_cost + home_cost)`` each (a
        cheap link earns most of the weight, an expensive one almost
        none; with no interconnect the term is exactly 0.0 and the score
        is bit-for-bit the historical one);
      * unbound (single-manager) DU: measured device residency (device-
        aware), then host/checkpoint residency fractions;
      * bound but the pilot is outside the data service: no credit.

    Plus the affinity bonus and minus the utilization (queue) penalty.
    """

    name = "locality"

    def __init__(self, weights: Optional[LocalityWeights] = None,
                 interconnect: Optional["InterconnectModel"] = None):
        self.weights = weights or LocalityWeights()
        self.interconnect = interconnect
        # partition sizes only feed the cost model, so a stale entry is
        # harmless — memoizing them keeps one select() round from paying
        # pilots x parts x holders metadata lookups for pilot-invariant
        # numbers (the same hot-path argument that removed the submit
        # double-scoring)
        self._nbytes_memo: Dict[Tuple[str, int], int] = {}

    # -- helpers --------------------------------------------------------
    @staticmethod
    def _per_pilot_du(pilot, du):
        """The DU's PilotDataService when this (pilot, du) pair is scored
        per-pilot: the DU must be service-bound and the pilot must be a
        registered replica holder candidate."""
        pds = getattr(du, "pilot_data_service", None)
        if (pds is not None and getattr(pilot, "tier_manager", None)
                is not None and pds.knows(pilot.id)):
            return pds
        return None

    @staticmethod
    def _device_tier_hits(pilot, dus) -> float:
        """Fraction of each (single-manager) DU's partitions actually
        resident on the pilot's devices. With a TierManager the *measured*
        residency is used (a DU whose nominal tier is 'device' but whose
        partitions were demoted under memory pressure earns no device
        credit); without one we fall back to the DU's single tier field."""
        hits = 0.0
        for du in dus:
            frac = du.resident_fraction("device")
            if frac <= 0.0:
                continue
            tm = getattr(du, "tier_manager", None)
            be = (tm.backends if tm is not None else du.backends).get("device")
            dev = getattr(be, "device", None)
            pilot_devs = getattr(pilot, "devices", None)
            if dev is None or not pilot_devs:
                hits += frac  # device-resident, single address space
            elif dev in pilot_devs:
                hits += frac
        return hits

    def _partition_nbytes(self, pds, du, i: int) -> int:
        memo = self._nbytes_memo
        key = (du.name, i)
        nb = memo.get(key)
        if nb is None:
            nb = pds.partition_nbytes(du, i)
            if len(memo) > 4096:    # unbounded DU churn must not leak
                memo.clear()
            memo[key] = nb
        return nb

    def _sibling_credit(self, pilot, du, pds) -> float:
        """Fraction-weighted credit for the partitions this pilot does
        NOT hold but can reach over the modelled interconnect from a
        sibling's replica more cheaply than from home (0.0 without an
        interconnect — the parity-preserving default)."""
        ic = self.interconnect
        n = du.num_partitions
        if ic is None or not n:
            return 0.0
        credit = 0.0
        for i in range(n):
            key = du._key(i)
            all_holders = pds.holders(key)
            if pilot.id in all_holders:
                continue    # already earning real residency credit
            holders = [pid for pid in all_holders if pid != pilot.id]
            if not holders:
                continue
            nb = self._partition_nbytes(pds, du, i)
            best = min(ic.transfer_cost(pid, pilot.id, nb)
                       for pid in holders)
            home = ic.home_cost(nb)
            if best < home:
                credit += home / (best + home) if best + home > 0 else 1.0
        return credit / n

    # -- the score ------------------------------------------------------
    def score(self, pilot, cu_desc) -> float:
        w = self.weights
        s = 0.0
        shared_dus = []     # DUs scored by global (single-manager) residency
        for du in cu_desc.input_data:
            pds = self._per_pilot_du(pilot, du)
            if pds is not None:
                # per-pilot replica residency: one registry scan yields the
                # device, host, and any-tier-stickiness terms together
                n = du.num_partitions
                if n:
                    res = pds.residency(du, pilot.id)
                    held = sum(res.values())
                    s += w.device * res.get("device", 0) / n
                    s += w.host * res.get("host", 0) / n
                    s += w.checkpoint * res.get("checkpoint", 0) / n
                    s += w.local * held / n
                    if held < n:
                        s += w.sibling * self._sibling_credit(pilot, du, pds)
            elif getattr(du, "pilot_data_service", None) is None:
                shared_dus.append(du)
            # else: replica-managed DU on a pilot outside the data
            # service — it holds nothing, so no locality credit
        s += w.device * self._device_tier_hits(pilot, shared_dus)
        for du in shared_dus:
            n = du.num_partitions
            if n:
                res = du.residency()    # one scan for both colder terms
                s += w.host * res.get("host", 0) / n
                s += w.checkpoint * res.get("checkpoint", 0) / n
        if cu_desc.affinity and cu_desc.affinity == pilot.desc.affinity:
            s += w.affinity
        s -= w.queue * pilot.utilization
        return s

    # -- batch plane ----------------------------------------------------
    @staticmethod
    def _desc_key(cu_desc):
        """Two descriptions with identical input-DU identity and affinity
        score identically (against a fixed pilot state), so one batch pass
        scores each distinct shape once.  Tasks routed through the engine
        overwhelmingly share ONE shape (same DU, same affinity) — that is
        what makes the batch pass O(distinct) instead of O(N)."""
        return (tuple(id(du) for du in cu_desc.input_data), cu_desc.affinity)

    def score_batch(self, pilot, cu_descs: Sequence) -> List[float]:
        """One pilot's scores for the whole batch, memoized by description
        shape — bit-for-bit N single scores while the pilot/replica state
        is fixed (asserted by tests/test_taskengine.py)."""
        memo: Dict[tuple, float] = {}
        out: List[float] = []
        for d in cu_descs:
            k = self._desc_key(d)
            s = memo.get(k)
            if s is None:
                s = memo[k] = self.score(pilot, d)
            out.append(s)
        return out

    def select_batch(self, pilots: Sequence,
                     cu_descs: Sequence) -> List[Tuple[object, float]]:
        """Batch placement in ONE scoring pass per pilot.

        Each pilot scores the batch once (memoized above); per task the
        winner is ``argmax(score - queue_weight * placed_here_so_far)`` —
        the same utilization growth the sequential path would observe as
        its own submissions deepen the winner's queue, modelled
        incrementally instead of re-scored N times.  Equal pilots
        therefore round-robin instead of all N tasks piling onto the
        first (first-wins ties, matching ``select``)."""
        if not pilots:
            raise ValueError("select_batch() needs at least one pilot")
        per_pilot = [self.score_batch(p, cu_descs) for p in pilots]
        wq = self.weights.queue
        extra = [0] * len(pilots)
        out: List[Tuple[object, float]] = []
        for i in range(len(cu_descs)):
            best, best_s = 0, float("-inf")
            for j, scores in enumerate(per_pilot):
                s = scores[i] - wq * extra[j]
                if s > best_s:
                    best, best_s = j, s
            extra[best] += 1
            out.append((pilots[best], best_s))
        return out


# -- the interconnect ----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Link:
    """One directed pilot-to-pilot (or home) transfer edge."""
    gbps: float                 # bandwidth in GB/s (1e9 bytes per second)
    latency_s: float = 0.0      # fixed per-transfer setup cost

    def __post_init__(self):
        if self.gbps < 0 or self.latency_s < 0:
            raise ValueError(f"Link needs gbps >= 0 and latency_s >= 0, "
                             f"got gbps={self.gbps}, "
                             f"latency_s={self.latency_s}")

    def cost(self, nbytes: int) -> float:
        """Modelled seconds to move `nbytes` over this link."""
        if self.gbps <= 0:
            return float("inf")
        return self.latency_s + nbytes / (self.gbps * 1e9)


class InterconnectModel:
    """Per-link GB/s + latency between pilots, plus the home re-pull path.

    `default` is the link assumed between any pilot pair without an
    explicit `set_link` entry (think: the cluster fabric); `home` models
    re-pulling a partition from the DU's home placement / checkpoint
    store (think: the shared parallel filesystem).  The defaults express
    the usual reason to attach a model at all — node-to-node moves over
    the fabric are cheaper than going back to shared storage — and every
    number is overridable per link.

    ``simulate=True`` makes sibling transfers *charge* their modelled
    cost as wall-clock sleep (capped), mirroring TierProfile.charge, so
    benchmarks can compare topologies without real hardware.
    """

    def __init__(self, default: Link = Link(gbps=12.5, latency_s=5e-5),
                 home: Link = Link(gbps=1.2, latency_s=2e-3),
                 simulate: bool = False, sleep_cap_s: float = 2.0):
        self.default = default
        self.home = home
        self.simulate = simulate
        self.sleep_cap_s = sleep_cap_s
        self._links: Dict[Tuple[str, str], Link] = {}
        self._lock = threading.Lock()

    def set_link(self, src: str, dst: str, gbps: float,
                 latency_s: float = 0.0,
                 symmetric: bool = True) -> "InterconnectModel":
        """Declare the link between two pilots (ids or PilotComputes)."""
        a = src if isinstance(src, str) else src.id
        b = dst if isinstance(dst, str) else dst.id
        link = Link(gbps=gbps, latency_s=latency_s)
        with self._lock:
            self._links[(a, b)] = link
            if symmetric:
                self._links[(b, a)] = link
        return self

    def link(self, src: str, dst: str) -> Link:
        with self._lock:
            return self._links.get((src, dst), self.default)

    def transfer_cost(self, src: str, dst: str, nbytes: int) -> float:
        """Modelled seconds to move `nbytes` from pilot `src` to `dst`."""
        if src == dst:
            return 0.0
        return self.link(src, dst).cost(nbytes)

    def home_cost(self, nbytes: int) -> float:
        """Modelled seconds to re-pull `nbytes` from the home/checkpoint
        store."""
        return self.home.cost(nbytes)

    def charge(self, src: str, dst: str, nbytes: int) -> float:
        """Account one sibling transfer; sleeps the modelled time when
        simulating.  Returns the modelled cost either way."""
        c = self.transfer_cost(src, dst, nbytes)
        if self.simulate and c > 0:
            time.sleep(min(c, self.sleep_cap_s))
        return c

    def __repr__(self) -> str:
        with self._lock:
            n = len(self._links)
        return (f"InterconnectModel(default={self.default}, "
                f"home={self.home}, links={n})")


def make_policy_for(name: str = "locality", **kwargs) -> SchedulingPolicy:
    """Tiny registry-style constructor (mirrors tiering.make_policy)."""
    if name == "locality":
        return LocalityPolicy(**kwargs)
    raise ValueError(f"unknown scheduling policy {name!r}")
