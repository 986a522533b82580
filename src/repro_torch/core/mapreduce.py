"""MapReduce over in-memory Data-Units (Pilot-Data Memory §3.3).

Paper: "we extend the DU interface to provide a higher-level MapReduce-based
API for expressing transformations on the data ... The runtime system
generates the necessary application tasks (Compute-Units) and runs these in
parallel considering data locality."

Execution paths (the paper's backend-adaptor mechanism):
  file/object/host tiers -> Compute-Units through the ComputeDataManager
      (the paper's file/Redis backends: data staged to the worker per task);
  device tier           -> partitions already HBM-resident; map runs as a
      kernel per partition WITHOUT restaging, and the map callable is
      warm in the pilot's executable cache (the paper's Spark backend: this
      is where the 212x comes from).

Pipelined engine (default): instead of the PR 1 "prefetch partition i+1"
hint, every path runs a depth-k double-buffered loop — while partition i is
being mapped, up to `prefetch_depth` later partitions are in flight on the
TierManager's thread-pool stager, and each mapped value is folded into a
running partial immediately (fused tree-combining).  The fold keeps exactly
one partial live per worker, so under a budgeted device tier the reduce
phase moves one partial per pilot instead of one value per partition, and
cold-tier stage-in overlaps the map instead of gating it.  On the managed
path partitions are grouped per pilot: one Compute-Unit per pilot maps+
combines its slice, and the driver reduces the per-pilot partials.
`pipeline=False` restores the PR 1 sequential behavior (one CU per
partition, i+1 prefetch, post-hoc reduction) — kept as the benchmark
baseline.

Adaptive prefetch depth (default, `prefetch_depth=None`): the depth is
derived per worker from measured stage-vs-compute times — an EWMA seeded
from the TierManager's TierProfile restage cost and updated with observed
prefetch waits and per-partition compute times — so staging-bound scans
deepen the pipeline while compute-bound scans stop issuing useless
stages.  Passing `prefetch_depth=k` remains an explicit fixed override.

Replica-aware grouping (DataUnits bound to a PilotDataService): each
partition group is routed to the pilot already holding (most of) its
partitions, unheld partitions are balanced across pilots, and the group's
leading partitions are replicated toward the chosen pilot before the CU
starts (pre-binding stage-in).  Each pilot's fold then reads through ITS
OWN TierManager, so a 2-pilot run splits a 2x-over-budget working set
across two device budgets instead of thrashing one.
"""
from __future__ import annotations

import functools
import itertools
import math
import time

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.data import DataUnit
from repro_torch.core.device import to_device
from repro_torch.core.manager import ComputeDataManager
from repro_torch.core.pilot import ComputeUnitDescription, PilotCompute
from repro_torch.core.supervisor import RETRY_BACKOFF

# upper bound on waiting for one in-flight prefetch before falling back to
# reading the partition wherever it currently resides
_PREFETCH_WAIT_S = 120.0
# pre-binding stage-in width when the depth itself is adaptive
_DEFAULT_PREBIND = 2


class _AdaptiveDepth:
    """EWMA-derived pipeline depth: ceil(stage_time / compute_time).

    Staging-bound scans are wall-clock-bounded by staging/depth, so the
    depth must cover the stage-to-compute ratio; compute-bound scans need
    only one look-ahead.  The stage estimate is the max of a static seed
    (the TierProfile-derived restage cost of a representative partition)
    and an EWMA of *observed* prefetch waits, so an optimistic profile is
    corrected by measurement; compute is an EWMA of mapped-partition
    times.  Before the first observation the PR 2 default (2) applies.
    """

    def __init__(self, seed_stage: float = 0.0, max_depth: int = 8,
                 alpha: float = 0.4):
        self.max_depth = max(1, int(max_depth))
        self.alpha = alpha
        self._seed = max(0.0, seed_stage)
        self._wait = 0.0
        self._compute = 0.0
        self._n = 0

    def observe(self, compute_s: float, wait_s: float = 0.0) -> None:
        a = self.alpha
        if self._n == 0:
            self._compute, self._wait = compute_s, wait_s
        else:
            self._compute = (1 - a) * self._compute + a * compute_s
            self._wait = (1 - a) * self._wait + a * wait_s
        self._n += 1

    @property
    def depth(self) -> int:
        if self._n == 0 or self._compute <= 1e-9:
            return min(2, self.max_depth)
        stage = max(self._seed, self._wait)
        return max(1, min(self.max_depth,
                          math.ceil(stage / self._compute)))


def _depth_controller(du: DataUnit, prefetch_depth: Optional[int],
                      indices: Sequence[int],
                      tier_manager=None,
                      target_tier: str = "host"
                      ) -> Union[int, "_AdaptiveDepth"]:
    """An explicit depth passes through; None builds the adaptive
    controller, seeded from the stage-in cost of the group's leading
    partitions in the manager the reads actually go through — the group
    pilot's own TierManager on the replica path, else the DU's home
    manager (0 => purely observation-driven).

    The seed is the WORST promote_cost over the first few partitions
    toward `target_tier`, billed at each partition's *actual* tier, so a
    group whose leading partitions were spilled to the slow checkpoint
    tier seeds a deep pipeline (its restores are bandwidth-bound on the
    persistent store) while an all-host group seeds a shallow one."""
    if prefetch_depth is not None:
        return max(1, int(prefetch_depth))
    seed = 0.0
    if indices:
        for tm in (tier_manager, du.tier_manager):
            if tm is None:
                continue
            costs = []
            for i in indices[:4]:
                try:
                    costs.append(tm.promote_cost(du._key(i), target_tier))
                except KeyError:
                    continue
            if costs:
                seed = max(costs)
                break
    return _AdaptiveDepth(seed_stage=seed)


def map_reduce(du: DataUnit, map_fn: Callable, reduce_fn: Callable,
               manager: Optional[ComputeDataManager] = None,
               pilot: Optional[PilotCompute] = None,
               extra_args: tuple = (),
               jit_map: bool = True,
               prefetch_depth: Optional[int] = None,
               pipeline: bool = True,
               retries: int = 1,
               prebind_wait_s: Optional[float] = None) -> Any:
    """map_fn(partition, *extra_args) -> value; reduce_fn(a, b) -> value.

    reduce_fn must be associative+commutative (combine order is not fixed:
    the pipelined engine folds left per worker and reduces partials across
    workers; the legacy path tree-reduces).  prefetch_depth=None sizes the
    pipeline adaptively from measured stage/compute times; an int fixes it.

    `manager` may also be a PilotSession (the v2 façade) — its scheduler
    is unwrapped, so `map_reduce(du, f, r, manager=session)` and
    `session.map_reduce(du, f, r)` are the same call.

    retries (managed pipelined path): when a group's Compute-Unit fails —
    typically its pilot died mid-run — the group's partitions are re-bound
    onto the surviving pilots and re-run, up to `retries` times.  The new
    pilots' reads pull the partitions back through the PilotDataService
    fetch path, whose last resort is the durable checkpoint home, so a
    pilot failure costs a lazy restore instead of the whole job (0
    disables; partial results from healthy groups are never recomputed).

    prebind_wait_s (managed paths): per-CU override of the pilot's
    pre-binding stage-in wait bound, threaded onto every Compute-Unit
    map_reduce submits internally (None = each pilot's configured
    default) — a job scanning cold data once can cap how long a wedged
    stage may delay its groups without re-describing the pilots.
    """
    if manager is not None and not isinstance(manager, ComputeDataManager):
        # a PilotSession (or anything façade-shaped) stands in for its
        # scheduler; duck-typed to keep session.py the only importer of
        # the façade layer
        inner = getattr(manager, "manager", None)
        if isinstance(inner, ComputeDataManager):
            manager = inner
        else:
            raise TypeError(f"map_reduce: manager must be a "
                            f"ComputeDataManager or PilotSession, got "
                            f"{type(manager).__name__}")
    if du.tier == "device":
        return _map_reduce_device(du, map_fn, reduce_fn, pilot, extra_args,
                                  jit_map, prefetch_depth, pipeline)
    # the compute kernel is identical across tiers (paper: same CU, different
    # backend); only staging differs
    mfn = map_fn
    dev = _map_device(du, pilot)

    def compute(i):
        # zero-copy stage-in (PR 8): partition_buf hands back the serving
        # tier's read-only view; to_device copies it once onto the device
        # (the host->device transfer; never an alias of the store's bytes)
        return mfn(to_device(du.partition_buf(i).view(), dev), *extra_args)

    if manager is None:
        if pipeline:
            idxs = list(range(du.num_partitions))
            return _pipeline_fold(du, idxs, compute, reduce_fn,
                                  _depth_controller(du, prefetch_depth, idxs),
                                  "host")
        # legacy sequential path: i+1 hint, post-hoc reduction
        vals = []
        for i in range(du.num_partitions):
            du.prefetch(i + 1)
            vals.append(compute(i))
        return functools.reduce(reduce_fn, vals)

    if pipeline:
        # fused partial reduction per pilot: one CU per partition group
        # maps + combines locally; only the per-pilot partials cross back
        # to the driver (cuts reduce-phase data motion)
        prebind = (prefetch_depth if isinstance(prefetch_depth, int)
                   else _DEFAULT_PREBIND)
        group_no = itertools.count()

        def _submit_replica(gi, grp_pilot, idxs):
            # distributed Pilot-Data: the group is bound to the pilot
            # holding its replicas and reads through THAT pilot's tiers
            def _fold(idxs=idxs, p=grp_pilot):
                comp = (lambda i:
                        mfn(du.partition_device(i, pilot=p), *extra_args))
                return _pipeline_fold(
                    du, idxs, comp, reduce_fn,
                    _depth_controller(du, prefetch_depth, idxs,
                                      tier_manager=p.tier_manager,
                                      target_tier="device"),
                    "device", pilot=p)
            return manager.submit(ComputeUnitDescription(
                fn=_fold, input_data=(du,), affinity=du.affinity,
                prefetch_parts=tuple(idxs[:prebind]),
                prebind_wait_s=prebind_wait_s,
                name=f"{du.name}-mapg{gi:03d}"), pilot=grp_pilot)

        def _submit_home(gi, idxs, exclude):
            return manager.submit(ComputeUnitDescription(
                fn=lambda idxs=idxs: _pipeline_fold(
                    du, idxs, compute, reduce_fn,
                    _depth_controller(du, prefetch_depth, idxs), "host"),
                input_data=(du,), affinity=du.affinity,
                prefetch_parts=tuple(idxs[:prebind]),
                prebind_wait_s=prebind_wait_s,
                name=f"{du.name}-mapg{gi:03d}"), exclude=exclude)

        def _submit_groups(indices, exclude):
            """One (cu, idxs) job per group over the CURRENTLY healthy
            pilots (minus `exclude`), replica-aware when possible."""
            groups = _replica_groups(du, manager, indices=indices,
                                     exclude=exclude)
            if groups is not None:
                return [(_submit_replica(next(group_no), p, idxs), idxs)
                        for p, idxs in groups]
            return [(_submit_home(next(group_no), idxs, exclude), idxs)
                    for idxs in _partition_groups(du, manager,
                                                  indices=indices)]

        jobs = _submit_groups(None, frozenset())
        partials: List[Any] = []
        last_error: Optional[BaseException] = None
        attempts = max(0, int(retries))
        for attempt in range(attempts + 1):
            failed_idxs: List[int] = []
            failed_pilots: set = set()
            for cu, idxs in jobs:
                try:
                    partials.append(cu.result())
                except Exception as e:  # noqa: BLE001 - retried below
                    last_error = e
                    failed_idxs.extend(idxs)
                    if cu.pilot_id:
                        failed_pilots.add(cu.pilot_id)
            if not failed_idxs:
                break
            if attempt == attempts:
                raise last_error
            # recovery path: re-bind only the failed partitions onto the
            # surviving pilots; their reads pull the data back through the
            # PilotDataService fetch chain (live replicas, then the
            # durable checkpoint home), so a mid-run pilot death costs a
            # lazy restore, not the job.  Back off first (bounded, with
            # jitter): re-submitting the instant a pilot died races the
            # supervisor's quarantine and stampedes the survivors.
            RETRY_BACKOFF.sleep(attempt)
            healthy = {p.id for p in manager.eligible_pilots()}
            if not healthy:
                raise last_error
            exclude = (frozenset(failed_pilots) if healthy - failed_pilots
                       else frozenset())    # all failed: reset, like
            #                                 result_with_retry
            jobs = _submit_groups(sorted(failed_idxs), exclude)
        return functools.reduce(reduce_fn, partials)

    def _task(idx):
        du.prefetch(idx + 1)
        return compute(idx)

    # legacy one-CU-per-partition path, routed through the batched task
    # engine: the N map tasks are scored in ONE policy pass and run on
    # the pilots' resident worker pools instead of paying N submit()
    # round-trips (results still reduce in partition order)
    batch = manager.submit_tasks(
        [ComputeUnitDescription(
            fn=lambda idx=i: _task(idx),
            input_data=(du,), affinity=du.affinity,
            prebind_wait_s=prebind_wait_s,
            name=f"{du.name}-map{i:04d}")
         for i in range(du.num_partitions)],
        retries=max(0, int(retries)))
    return functools.reduce(reduce_fn, batch.results())


def _pipeline_fold(du: DataUnit, indices, compute: Callable,
                   reduce_fn: Callable,
                   depth: Union[int, _AdaptiveDepth], tier: str,
                   pilot: Optional[PilotCompute] = None) -> Any:
    """Depth-k double-buffered map+combine over `indices`.

    Keeps up to `depth` stage-ins in flight on the background stager while
    the current partition computes, waits for partition i's own stage (if
    one was issued) so the read hits the warm tier, and folds each mapped
    value into a running partial so at most one partial plus the current
    partition are live at any time.  With `pilot` set, prefetches and
    reads target that pilot's own tiers (per-pilot replica residency).
    An _AdaptiveDepth instance re-sizes the look-ahead every iteration
    from the measured stage-vs-compute ratio.
    """
    indices = list(indices)
    adaptive = isinstance(depth, _AdaptiveDepth)
    inflight: dict = {}
    acc = None
    for pos, i in enumerate(indices):
        d = depth.depth if adaptive else max(1, int(depth))
        for j in indices[pos + 1: pos + 1 + d]:
            if j not in inflight:
                inflight[j] = du.prefetch(j, tier, pilot=pilot)
        fut = inflight.pop(i, None)
        wait_s = 0.0
        if fut is not None:
            t0 = time.perf_counter()
            try:
                fut.result(timeout=_PREFETCH_WAIT_S)
            except Exception:   # noqa: BLE001
                pass    # refused/raced stage: the read finds the partition
            wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        val = compute(i)
        if adaptive:
            depth.observe(compute_s=time.perf_counter() - t0, wait_s=wait_s)
        acc = val if acc is None else reduce_fn(acc, val)
    return acc


def _partition_groups(du: DataUnit, manager: ComputeDataManager,
                      indices: Optional[Sequence[int]] = None
                      ) -> List[List[int]]:
    """Contiguous partition slices, one per healthy pilot (>=1); `indices`
    restricts the split to a subset (the retry path's failed residue)."""
    idx = (list(range(du.num_partitions)) if indices is None
           else list(indices))
    n_workers = max(1, len(manager.eligible_pilots()))
    n_groups = max(1, min(len(idx), n_workers))
    bounds = np.linspace(0, len(idx), n_groups + 1).astype(int)
    return [idx[bounds[g]:bounds[g + 1]]
            for g in range(n_groups) if bounds[g] < bounds[g + 1]]


def _replica_groups(du: DataUnit, manager: ComputeDataManager,
                    indices: Optional[Sequence[int]] = None,
                    exclude: frozenset = frozenset()
                    ) -> Optional[List[Tuple[PilotCompute, List[int]]]]:
    """Replica-aware partition->pilot assignment, or None when the DU is
    not bound to a PilotDataService (or no healthy pilot participates in
    it — the contiguous fallback then applies).

    Each partition sticks to the pilot already holding its replica at the
    hottest tier (so iterated scans keep hitting warm per-pilot memory);
    partitions no pilot holds go to the least-loaded pilots, keeping the
    split balanced and deterministic.  `indices` restricts the assignment
    to a subset and `exclude` removes pilots (both used by the failure
    retry, which re-binds only the failed residue onto survivors).
    """
    pds = getattr(du, "pilot_data_service", None)
    if pds is None:
        return None
    pilots = [p for p in manager.eligible_pilots(exclude)
              if getattr(p, "tier_manager", None) is not None
              and pds.knows(p.id)]
    if not pilots:
        return None
    by_id = {p.id: p for p in pilots}
    assign: dict = {p.id: [] for p in pilots}
    unheld: List[int] = []
    for i in (range(du.num_partitions) if indices is None else indices):
        best = pds.best_pilot(du._key(i), list(assign))
        if best is not None:
            assign[best].append(i)
        else:
            unheld.append(i)
    for i in unheld:
        target = min(assign, key=lambda pid: len(assign[pid]))
        assign[target].append(i)
    return [(by_id[pid], idxs) for pid, idxs in assign.items() if idxs]


def _map_device(du: DataUnit, pilot: Optional[PilotCompute]):
    """Where a staged host partition is mapped: the named pilot's device,
    else the device of the DU's device tier, else the default (cuda)."""
    if pilot is not None and pilot.devices:
        return pilot.devices[0]
    return getattr(du.backends.get("device"), "device", None)


def _map_reduce_device(du: DataUnit, map_fn, reduce_fn, pilot, extra_args,
                       jit_map: bool, prefetch_depth: Optional[int],
                       pipeline: bool):
    """Device-tier path: no host restaging; warm-cache reuse of the map.

    PyTorch runs eagerly, so the pilot's executable cache holds the map
    callable itself (its kernels build once per process on first use)."""
    if jit_map and pilot is not None:
        jitted = pilot.jit_cached(("map", map_fn), lambda: map_fn)
    else:
        jitted = map_fn
    if pipeline:
        # fused combine keeps one partial in HBM instead of num_partitions
        # mapped values awaiting the tree reduce
        idxs = list(range(du.num_partitions))
        return _pipeline_fold(
            du, idxs,
            lambda i: jitted(du.partition_device(i), *extra_args),
            reduce_fn,
            _depth_controller(du, prefetch_depth, idxs,
                              target_tier="device"), "device")
    vals: List[Any] = []
    for i in range(du.num_partitions):
        # under a budgeted device tier some partitions sit one level colder;
        # start their promotion while the current partition computes
        du.prefetch(i + 1, "device")
        vals.append(jitted(du.partition_device(i), *extra_args))
    # tree reduce (log depth; on real pods this maps to collective schedule)
    while len(vals) > 1:
        nxt = []
        for j in range(0, len(vals) - 1, 2):
            nxt.append(reduce_fn(vals[j], vals[j + 1]))
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]
