"""Compute-Data-Manager: data-aware, late-binding CU scheduling over pilots.

Paper §3.3 / Fig. 5: "The Compute-Data-Manager will assign submitted
Compute-Units and Data-Units to a Pilot taking into account the current
available Pilots, their utilization and data locality."

Accelerator adaptation of locality: the expensive boundaries are host<->HBM staging
and cross-slice transfers, so the score prefers (1) the pilot whose DEVICE
tier already holds the CU's DataUnits, then (2) matching affinity labels,
then (3) host-resident data, then (4) checkpoint-tier residency (a spilled
partition restores from the pilot's durable node-local store, still
beating a refetch from the home placement), then (5) any-tier replica
stickiness, then (6) lowest queue depth. Late binding: CUs wait in the
manager queue until some pilot is provisioned and healthy.

Multi-pilot locality: when a DataUnit is bound to a PilotDataService,
residency is *per pilot* — each pilot is scored by the fraction of the
DU's partitions ITS OWN TierManager measurably holds (replicas demoted
inside the pilot stop earning device credit; pilots outside the data
service earn none), so the CU lands on the pilot actually holding the
majority of its data.  On binding, the manager queues pre-binding
stage-in: the partitions the CU declared it reads first are replicated
toward the CHOSEN pilot's tiers, and the pilot waits for those copies to
land before the CU body runs (paper's ensure-availability semantics).

Since PR 5 the scoring itself is a pluggable strategy
(repro_torch.core.scheduling): ComputeDataManager drives a SchedulingPolicy,
whose default LocalityPolicy reproduces the scoring described above
bit-for-bit; the W_* constants re-exported here live with the policy.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from repro_torch.core.backends.base import get_backend
from repro_torch.core.pilot import (ComputeUnit, ComputeUnitDescription,
                              PilotCompute, PilotComputeDescription, State)
# the locality score weights live with the policies now; re-exported here
# because four PRs of code and tests import them from manager
from repro_torch.core.scheduling import (LocalityPolicy, SchedulingPolicy,  # noqa: F401
                                   W_AFFINITY, W_CKPT, W_DEVICE, W_HOST,
                                   W_LOCAL, W_QUEUE)
from repro_torch.core.supervisor import POLL_BACKOFF, RETRY_BACKOFF


class PilotComputeService:
    """Provision/release pilots across backend adaptors (paper's PCS)."""

    def __init__(self):
        self.pilots: Dict[str, PilotCompute] = {}
        self._lock = threading.Lock()

    def submit_pilot(self, desc: PilotComputeDescription) -> PilotCompute:
        backend = get_backend(desc.backend)
        pilot = backend.provision(desc)
        with self._lock:
            self.pilots[pilot.id] = pilot
        return pilot

    def release(self, pilot: PilotCompute):
        backend = get_backend(pilot.desc.backend)
        backend.release(pilot)
        with self._lock:
            self.pilots.pop(pilot.id, None)

    def cancel_all(self):
        for p in list(self.pilots.values()):
            self.release(p)

    def healthy_pilots(self) -> List[PilotCompute]:
        with self._lock:
            return [p for p in self.pilots.values()
                    if p.state == State.RUNNING]


class ComputeDataManager:
    """Late-binding scheduler: scores (pilot x CU) through a pluggable
    SchedulingPolicy (default LocalityPolicy — the historical W_* data-
    locality scoring, now a strategy in repro_torch.core.scheduling).

    `history` keeps the most recent `history_limit` placement decisions
    (a bounded window — long-running sessions serving millions of CUs
    must not grow driver memory without limit); `stats()` summarizes the
    whole lifetime regardless of the window.
    """

    _STAT_SHARDS = 8

    def __init__(self, service: PilotComputeService,
                 policy: Optional[SchedulingPolicy] = None,
                 history_limit: int = 1024):
        self.service = service
        self.policy: SchedulingPolicy = policy or LocalityPolicy()
        self.history_limit = max(1, int(history_limit))
        self.history: List[dict] = []   # bounded: see _record
        # stats locks are sharded BY PILOT (hash(pilot.id) -> shard), the
        # same move PR 2 made for read accounting: batched submissions
        # against different pilots account concurrently instead of
        # serializing on one manager-wide lock.  A pilot always maps to
        # the same shard, so its per-pilot counter stays exact; the
        # lifetime total is the sum of per-shard counters.
        n = self._STAT_SHARDS
        self._stats_locks = [threading.Lock() for _ in range(n)]
        self._submitted_shards = [0] * n
        self._per_pilot_shards: List[Dict[str, int]] = [{} for _ in range(n)]
        self._engine = None             # lazy TaskEngine (see .engine)
        self._engine_lock = threading.Lock()

    # ------------------------------------------------------------------
    def score(self, pilot: PilotCompute,
              cu_desc: ComputeUnitDescription) -> float:
        """Policy delegation (kept as a method: four PRs of tests and
        benchmarks call manager.score directly)."""
        return self.policy.score(pilot, cu_desc)

    def eligible_pilots(self, exclude: frozenset = frozenset()
                        ) -> List[PilotCompute]:
        """Healthy, non-excluded, non-quarantined pilots — the one filter
        every placement path shares.  Quarantine (supervisor suspicion)
        fails closed: an empty result makes late binding WAIT, it never
        falls back onto a suspect pilot."""
        pilots = [p for p in self.service.healthy_pilots()
                  if p.id not in exclude]
        return self.policy.eligible(pilots)

    def _select_scored(self, cu_desc: ComputeUnitDescription,
                       timeout: float = 30.0,
                       exclude: frozenset = frozenset()
                       ) -> Tuple[PilotCompute, float]:
        """Late binding: wait for an eligible pilot, return the best-
        scoring one AND its score, so the submit path records the decision
        without scoring the winner a second time (scoring scans every
        input DU's partitions — the recompute scaled with pilots x DUs x
        parts).  The wait uses a monotonic deadline (wall-clock jumps
        can't expire it early) and jittered backoff (a fleet of blocked
        submitters doesn't stampede the registry in lockstep)."""
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            pilots = self.eligible_pilots(exclude)
            if pilots:
                return self.policy.select(pilots, cu_desc)
            if time.monotonic() > deadline:
                raise TimeoutError("no eligible pilot available (late "
                                   "binding timed out)")
            POLL_BACKOFF.sleep(attempt)
            attempt += 1

    def select_pilot(self, cu_desc: ComputeUnitDescription,
                     timeout: float = 30.0,
                     exclude: frozenset = frozenset()) -> PilotCompute:
        return self._select_scored(cu_desc, timeout, exclude)[0]

    # ------------------------------------------------------------------
    def _shard(self, pilot_id: str) -> int:
        return hash(pilot_id) % self._STAT_SHARDS

    def _record(self, cu: ComputeUnit, pilot: PilotCompute,
                score: float) -> None:
        """Append one placement decision, keeping `history` bounded and
        the lifetime counters exact."""
        self.history.append({"cu": cu.id, "pilot": pilot.id,
                             "score": score, "t": time.monotonic()})
        overflow = len(self.history) - self.history_limit
        if overflow > 0:
            del self.history[:overflow]
        shard = self._shard(pilot.id)
        with self._stats_locks[shard]:
            self._submitted_shards[shard] += 1
            pp = self._per_pilot_shards[shard]
            pp[pilot.id] = pp.get(pilot.id, 0) + 1

    def record_batch(self, pilot: PilotCompute, tasks, score: float) -> None:
        """Account a whole engine batch bound to one pilot under that
        pilot's stats shard: ONE lock pass and ONE counter update for N
        tasks.  History gets per-task entries only up to the bounded
        window (appending 10^5 dicts that the very next trim would drop
        is pure hot-path waste), so small batches — e.g. the legacy
        map_reduce path's one-CU-per-partition submissions — keep their
        familiar one-entry-per-task history shape."""
        n = len(tasks)
        if n == 0:
            return
        now = time.monotonic()
        window = tasks if n <= self.history_limit \
            else tasks[n - self.history_limit:]
        pid = pilot.id
        append = self.history.append
        for t in window:
            name = getattr(t.desc, "name", "") if t.desc is not None else ""
            append({"cu": name or "fn-task", "pilot": pid,
                    "score": score, "t": now})
        overflow = len(self.history) - self.history_limit
        if overflow > 0:
            del self.history[:overflow]
        shard = self._shard(pid)
        with self._stats_locks[shard]:
            self._submitted_shards[shard] += n
            pp = self._per_pilot_shards[shard]
            pp[pid] = pp.get(pid, 0) + n

    def stats(self) -> dict:
        """Lifetime scheduling summary (exact even after the bounded
        `history` window has rolled over): per-shard counters summed
        under their own locks."""
        submitted = 0
        per_pilot: Dict[str, int] = {}
        for i, lock in enumerate(self._stats_locks):
            with lock:
                submitted += self._submitted_shards[i]
                per_pilot.update(self._per_pilot_shards[i])
        return {"policy": self.policy.name, "submitted": submitted,
                "per_pilot": per_pilot,
                "history_len": len(self.history),
                "history_limit": self.history_limit}

    def _prefetch_inputs(self, pilot: PilotCompute,
                         cu_desc: ComputeUnitDescription) -> List[Future]:
        """Paper's ensure-availability semantics: once a CU is bound to a
        pilot, start staging the partitions it declared it will read first
        (`prefetch_parts`) toward the CHOSEN pilot's tiers so stage-in
        overlaps the queue wait (async, refusable under budget pressure —
        never blocks submission). The returned futures become the CU's
        pre-binding barrier: the pilot waits for them to land before the
        CU body runs. No hint, no blind prefetch: staging partitions the
        CU never touches would evict ones it is about to read."""
        tm = getattr(pilot, "tier_manager", None)
        if tm is None or not cu_desc.prefetch_parts or not cu_desc.input_data:
            return []
        # the indices are partition positions of the primary (first) DU;
        # applying them to sibling DUs would stage partitions the CU never
        # touches and evict ones it is about to read
        du = cu_desc.input_data[0]
        futs: List[Future] = []
        pds = getattr(du, "pilot_data_service", None)
        if pds is not None and pds.knows(pilot.id):
            # distributed Pilot-Data: replicate toward the chosen pilot's
            # own managed tiers (true pre-binding stage-in)
            for i in cu_desc.prefetch_parts:
                if 0 <= i < du.num_partitions:
                    futs.append(pds.replicate_async(du, i, pilot.id))
        elif getattr(du, "tier_manager", None) is tm:
            tier = "device" if du.tier == "device" else "host"
            for i in cu_desc.prefetch_parts:
                f = du.prefetch(i, tier)
                if f is not None:
                    futs.append(f)
        return futs

    # ------------------------------------------------------------------
    def submit(self, cu_desc: ComputeUnitDescription,
               exclude: frozenset = frozenset(),
               pilot: Optional[PilotCompute] = None) -> ComputeUnit:
        """Late-bind `cu_desc` onto the best-scoring pilot (or onto an
        explicitly chosen `pilot`, e.g. a replica-aware map_reduce group)
        and queue its pre-binding stage-in."""
        cu = ComputeUnit(cu_desc)
        if pilot is None:
            # the winning score is threaded through from selection — the
            # old recompute here doubled the hot-path scoring cost
            pilot, score = self._select_scored(cu_desc, exclude=exclude)
        else:
            score = self.policy.score(pilot, cu_desc)
        self._record(cu, pilot, score)
        cu.prebind_futures = self._prefetch_inputs(pilot, cu_desc)
        pilot.submit_cu(cu)
        return cu

    def run(self, fn, *args, input_data=(), affinity: str = "", **kwargs):
        """Convenience: submit and return the CU."""
        return self.submit(ComputeUnitDescription(
            fn=fn, args=args, kwargs=kwargs, input_data=input_data,
            affinity=affinity))

    # ------------------------------------------------------------------
    @property
    def engine(self):
        """The manager's high-throughput task engine (lazy: sessions that
        never call submit_tasks pay nothing for it)."""
        eng = self._engine
        if eng is None:
            with self._engine_lock:
                eng = self._engine
                if eng is None:
                    from repro_torch.core.taskengine import TaskEngine
                    eng = self._engine = TaskEngine(self)
        return eng

    def submit_tasks(self, items, *, retries: int = 0,
                     timeout: float = 30.0):
        """Batched function-as-task dispatch (the raptor-style engine):
        the whole batch is scored in one policy pass and fed to the
        chosen pilots' resident worker pools under backpressure.  Items
        may be bare callables, ``(fn, args[, kwargs])`` tuples, or
        ``ComputeUnitDescription``s; returns a ``TaskBatch`` of result
        futures in submit order.  ``submit`` remains the single-CU path
        with full CU semantics (pre-binding stage-in, device context,
        per-CU Future)."""
        return self.engine.submit_tasks(items, retries=retries,
                                        timeout=timeout)

    def result_with_retry(self, cu_desc: ComputeUnitDescription,
                          retries: int = 2,
                          timeout: Optional[float] = None):
        """Run a CU to completion, transparently resubmitting on CU/pilot
        failure (task-level fault tolerance; pilot-level recovery lives in
        the supervisor — repro_torch.core.supervisor). Each retry re-runs late
        binding with every pilot that already failed this CU *excluded*,
        so a retry cannot late-bind straight back onto the pilot that just
        failed; when every healthy pilot has failed it, the exclusion
        resets rather than stranding the CU.  Retries back off with
        bounded exponential + jitter (immediate resubmission against a
        fleet that just lost a node only amplifies the failure)."""
        last: Optional[Exception] = None
        exclude: set = set()
        for attempt in range(retries + 1):
            if attempt > 0:
                RETRY_BACKOFF.sleep(attempt - 1)
            healthy = {p.id for p in self.service.healthy_pilots()}
            if healthy and healthy <= exclude:
                exclude.clear()
            cu = self.submit(cu_desc, exclude=frozenset(exclude))
            try:
                return cu.future.result(timeout)
            except Exception as e:  # noqa: BLE001
                last = e
                if cu.pilot_id:
                    exclude.add(cu.pilot_id)
        raise last
