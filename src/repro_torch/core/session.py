"""PilotSession: the unified Pilot-API v2 façade.

The paper's central claim (§3, Fig. 5) is that the Pilot-Abstraction is
ONE API for reasoning about compute/data placement across heterogeneous
infrastructures — yet assembling it by hand takes five objects wired in
the right order (PilotComputeService -> ComputeDataManager ->
PilotDataService -> make_backend -> DataUnit.from_array) and per-test
teardown rituals.  PilotSession is that one API:

    from repro_torch.core import PilotSession

    with PilotSession() as s:                       # on the card (cuda)
        s.add_pilots(2, memory_gb=0.05)             # provision + register
        du = s.data("points", pts, parts=8)         # home placement, bound
        total = s.map_reduce(du, map_fn, reduce_fn) # replica-aware engine
        res = s.kmeans(du, k=8, iters=3)
    # <- deterministic teardown: in-flight replication drained, checkpoint
    #    writes flushed + manifest fsync'd, TierManagers closed, pilots
    #    released — in that order, every time

One session owns:
  * a PilotComputeService (provision/release across backend adaptors);
  * a ComputeDataManager driving a pluggable SchedulingPolicy (default
    LocalityPolicy; pass `policy=` to plug in your own);
  * a PilotDataService (the distributed Pilot-Data replica layer), with
    an optional shared durable checkpoint home (`checkpoint_dir=`) and
    an optional InterconnectModel (`interconnect=`) enabling cost-
    modelled cross-pilot replica reads;
  * the DataUnits created through `data()` (home placement on session-
    owned backends; `tier="file"` lands them in a session scratch dir).

The v1 objects stay public and unchanged — a session is composition,
not replacement — and `session.compute` / `session.manager` /
`session.data_service` expose them for anything the façade doesn't
cover.

The session runs on the card unless `device="cpu"` is asked for; without
CUDA it raises rather than falling back.  An elastic session:

    with PilotSession(supervise=True, autoscale=True, rebalance=True,
                      min_pilots=1, max_pilots=4) as s:
        s.add_pilot(backend="simulated", memory_gb=1)   # a slurm/yarn/...
        ...                                             # substrate model
"""
from __future__ import annotations

import os
import shutil
import tempfile
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import analytics
from repro_torch.core import mapreduce as _mapreduce
from repro_torch.core.data import DataUnit
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.manager import ComputeDataManager, PilotComputeService
from repro_torch.core.memory import PROFILES, TierProfile, make_backend
from repro_torch.core.pilot import (ComputeUnit, ComputeUnitDescription,
                              PilotCompute, PilotComputeDescription)
from repro_torch.core.pilotdata import PilotDataService
from repro_torch.core.scheduling import InterconnectModel, SchedulingPolicy
from repro_torch.core.supervisor import PilotSupervisor


class PilotSession:
    """Context-managed façade over the whole Pilot-API (see module doc).

    Parameters
    ----------
    policy: SchedulingPolicy for CU placement (default LocalityPolicy).
    interconnect: InterconnectModel enabling cost-modelled cross-pilot
        replica reads (also handed to a LocalityPolicy built by default).
    checkpoint_dir: shared durable checkpoint home for the session's
        PilotDataService (pilots may additionally name their own).
    prebind_wait_s: default stage-in wait bound stamped onto pilot
        descriptions built from kwargs by `add_pilot` (an explicit
        description always wins).
    history_limit: bound on the scheduler's placement-history window.
    supervise: True makes the session self-healing — a PilotSupervisor
        monitor thread heartbeat-checks every pilot, quarantines suspects
        before any task routes to them, respawns confirmed-dead pilots
        from their own descriptions, and drives replication-factor repair
        for DataUnits declared with `data(..., replication=n)`.  Extra
        keyword knobs go through `supervisor_kwargs` (e.g.
        ``supervisor_kwargs={"interval_s": 0.02}``).
    autoscale: True makes the session elastic — an Autoscaler monitor
        thread grows/shrinks the fleet between `min_pilots` and
        `max_pilots` from live load (task-engine backlog, worker
        utilization, tier pressure, serving queue wait), scaling out by
        cloning the fleet's own description and scaling in through the
        drain protocol (quiesce -> serving handoff -> evacuate every
        resident partition -> release).  Extra knobs go through
        `autoscaler_kwargs` (e.g. ``{"policy": LoadScalingPolicy(...)}``).
    rebalance: True starts a background Rebalancer migrating partitions
        off pressure-skewed pilots onto idle ones, priced by the
        session's InterconnectModel; knobs via `rebalancer_kwargs`.
    device: where pilots and device-tier data live (default cuda; no
        CUDA raises).  Pilot descriptions built from kwargs by
        `add_pilot` inherit it; an explicit description always wins.
    """

    def __init__(self, *, policy: Optional[SchedulingPolicy] = None,
                 interconnect: Optional[InterconnectModel] = None,
                 checkpoint_dir: Optional[str] = None,
                 prebind_wait_s: Optional[float] = None,
                 history_limit: int = 1024, name: str = "",
                 supervise: bool = False,
                 supervisor_kwargs: Optional[dict] = None,
                 autoscale: bool = False, min_pilots: int = 1,
                 max_pilots: int = 8,
                 autoscaler_kwargs: Optional[dict] = None,
                 rebalance: bool = False,
                 rebalancer_kwargs: Optional[dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.name = name or f"session-{uuid.uuid4().hex[:8]}"
        self.interconnect = interconnect
        if policy is None:
            # the default policy sees the same interconnect the data
            # service prices fetches with, so placement and fetch agree
            # on what a "cheap" sibling is
            from repro_torch.core.scheduling import LocalityPolicy
            policy = LocalityPolicy(interconnect=interconnect)
        self.compute = PilotComputeService()
        self.manager = ComputeDataManager(self.compute, policy=policy,
                                          history_limit=history_limit)
        self.data_service = PilotDataService(checkpoint_dir=checkpoint_dir,
                                             interconnect=interconnect)
        self._prebind_wait_s = prebind_wait_s
        self._data: Dict[str, DataUnit] = {}
        self._host_backend = make_backend("host")
        self._scratch: Optional[str] = None
        self._closed = False
        # serving engines register themselves here (ServingEngine.deploy)
        # so the autoscaler can read their queue-wait signal and hand off
        # a draining pilot's replica before release
        self.serving_engines: List = []
        self._supervisor: Optional[PilotSupervisor] = None
        if supervise:
            self._supervisor = PilotSupervisor(
                self, **(supervisor_kwargs or {})).start()
        self._autoscaler = None
        self._rebalancer = None
        if autoscale:
            from repro_torch.core.autoscaler import Autoscaler
            self._autoscaler = Autoscaler(
                self, min_pilots=min_pilots, max_pilots=max_pilots,
                **(autoscaler_kwargs or {})).start()
        if rebalance:
            from repro_torch.core.rebalance import Rebalancer
            self._rebalancer = Rebalancer(
                self, **(rebalancer_kwargs or {})).start()

    @property
    def supervisor(self) -> Optional[PilotSupervisor]:
        return self._supervisor

    @property
    def autoscaler(self):
        return self._autoscaler

    @property
    def rebalancer(self):
        return self._rebalancer

    # -- lifecycle -------------------------------------------------------
    def __enter__(self) -> "PilotSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Deterministic teardown, idempotent: (0) stop the supervisor
        FIRST — its monitor thread joins here, so an in-flight respawn
        finishes or aborts before teardown proceeds and the deliberate
        releases below are never mistaken for deaths — then (1) drain
        in-flight replication and flush every checkpoint write
        (durability barrier), (2) release the pilots — which closes each
        pilot's TierManager: queued stages cancelled, in-flight ones
        landed, stager threads joined — and (3) remove the session
        scratch directory backing file-tier home placements (explicit
        `root=` directories are the caller's and stay)."""
        if self._closed:
            return
        self._closed = True
        # the fleet-resizing loops stop before the supervisor: a drain
        # mid-flight finishes or aborts while the failure detector can
        # still tell a released pilot from a dead one
        if self._autoscaler is not None:
            self._autoscaler.close()
        if self._rebalancer is not None:
            self._rebalancer.close()
        if self._supervisor is not None:
            self._supervisor.close()
        self.data_service.drain(timeout=30)
        self.data_service.close()
        self.compute.cancel_all()
        if self._scratch is not None:
            shutil.rmtree(self._scratch, ignore_errors=True)
            self._scratch = None

    # -- pilots ----------------------------------------------------------
    def add_pilot(self, desc: Optional[PilotComputeDescription] = None,
                  **kwargs) -> PilotCompute:
        """Provision a pilot and (when it carries managed memory) join it
        to the session's data service.  Pass a full description, or the
        description's kwargs directly — nested blocks and flat legacy
        fields both work:

            s.add_pilot(memory_gb=0.5, checkpoint_dir="/ckpt")
            s.add_pilot(PilotComputeDescription(memory=MemoryDescription(
                memory_gb=0.5, eviction_policy="gdsf")))
        """
        if self._closed:
            raise RuntimeError(f"{self.name} is closed")
        if desc is None:
            if (self._prebind_wait_s is not None
                    and "prebind_wait_s" not in kwargs):
                kwargs["prebind_wait_s"] = self._prebind_wait_s
            kwargs.setdefault("device", self.device)
            desc = PilotComputeDescription(**kwargs)
        elif kwargs:
            raise TypeError("add_pilot: pass a description OR kwargs, "
                            "not both")
        pilot = self.compute.submit_pilot(desc)
        if pilot.tier_manager is not None:
            self.data_service.register_pilot(pilot)
        return pilot

    def add_pilots(self, n: int, **kwargs) -> List[PilotCompute]:
        """Provision `n` identically-described pilots."""
        return [self.add_pilot(**kwargs) for _ in range(n)]

    @property
    def pilots(self) -> List[PilotCompute]:
        return list(self.compute.pilots.values())

    def release(self, pilot: PilotCompute) -> None:
        """Release one pilot (its replicas leave the registry first, so
        the scheduler stops crediting it immediately; the supervisor is
        told to forget it first, so a deliberate release is never
        mistaken for a death and respawned)."""
        if self._supervisor is not None:
            self._supervisor.forget(pilot.id)
        self.data_service.unregister_pilot(pilot.id)
        self.compute.release(pilot)

    def respawn_pilot(self, dead: PilotCompute) -> PilotCompute:
        """Replace a dead pilot with a fresh one provisioned from the
        dead pilot's own description: the corpse's replicas leave the
        registry and its resources are released (teardown of a FAILED
        pilot is best-effort), then `add_pilot(dead.desc)` re-provisions
        and re-registers the TierManager with the data service.  Raises
        RuntimeError when the session is closed — the supervisor treats
        that as an aborted respawn."""
        if self._closed:
            raise RuntimeError(f"{self.name} is closed")
        self.data_service.unregister_pilot(dead.id)
        try:
            self.compute.release(dead)
        except Exception:   # noqa: BLE001 - the corpse may be half-dead
            self.compute.pilots.pop(dead.id, None)
        return self.add_pilot(dead.desc)

    # -- data ------------------------------------------------------------
    def _scratch_dir(self) -> str:
        if self._scratch is None:
            self._scratch = tempfile.mkdtemp(prefix=f"{self.name}-")
        return self._scratch

    def data(self, name: str, array, parts: int = 1, *,
             tier: str = "host", affinity: str = "", persist: bool = False,
             replication: int = 0,
             profile: Optional[TierProfile] = None,
             root: Optional[str] = None) -> DataUnit:
        """Create a partitioned DataUnit on the session's home backends
        and bind it to the session's data service (so per-pilot replica
        reads, coherent writes, and replica-aware scheduling all work
        out of the box).

        `tier` picks the home placement ("host" default; "file"/"object"
        land under a session scratch directory unless `root` is given,
        with `profile` optionally simulating the home store's bandwidth —
        e.g. PROFILES["stampede_disk"] for a slow shared filesystem).
        `persist=True` additionally writes the partitions through to the
        session's durable checkpoint home.  `replication=n` declares a
        target live-replica count per partition: the data service's
        repair worker (started by a supervising session) re-replicates
        any partition that falls below it after a pilot loss."""
        if self._closed:
            raise RuntimeError(f"{self.name} is closed")
        if name in self._data:
            raise ValueError(f"DataUnit {name!r} already exists in "
                             f"{self.name} (names are session-unique)")
        backends = {"host": self._host_backend,
                    "device": make_backend("device", device=self.device)}
        if tier in ("file", "object") or root is not None:
            file_tier = tier if tier in ("file", "object") else "file"
            backends[file_tier] = make_backend(
                file_tier, root=root or os.path.join(self._scratch_dir(),
                                                     name),
                profile=profile or PROFILES["native"])
        if tier not in backends:
            raise ValueError(f"data(): unsupported home tier {tier!r} "
                             f"(have {sorted(backends)})")
        du = DataUnit.from_array(name, np.asarray(array), parts, backends,
                                 tier=tier, affinity=affinity)
        self.data_service.register(du, persist=persist,
                                   replication=replication)
        self._data[name] = du
        return du

    def data_parts(self, name: str, parts: Sequence, *, tier: str = "host",
                   affinity: str = "", persist: bool = False,
                   replication: int = 0) -> DataUnit:
        """Create a DataUnit from explicit per-partition arrays — ragged
        shapes allowed — and bind it to the session's data service.

        Where `data()` splits one array on axis 0, this takes the
        partition list as given: model shard leaves (one param leaf per
        partition), per-request KV pages, any heterogeneous collection.
        An empty list is valid — grow it later with
        ``DataUnit.append_partition`` (dynamically-arriving request
        state).  `persist`/`replication` behave exactly as in `data()`."""
        if self._closed:
            raise RuntimeError(f"{self.name} is closed")
        if name in self._data:
            raise ValueError(f"DataUnit {name!r} already exists in "
                             f"{self.name} (names are session-unique)")
        backends = {"host": self._host_backend,
                    "device": make_backend("device", device=self.device)}
        if tier not in backends:
            raise ValueError(f"data_parts(): unsupported home tier "
                             f"{tier!r} (have {sorted(backends)})")
        du = DataUnit.from_partitions(
            name, [np.asarray(p) for p in parts], backends, tier=tier,
            affinity=affinity)
        self.data_service.register(du, persist=persist,
                                   replication=replication)
        self._data[name] = du
        return du

    def get_data(self, name: str) -> DataUnit:
        return self._data[name]

    # -- compute ---------------------------------------------------------
    def run(self, fn, *args, input_data: Sequence = (), affinity: str = "",
            **kwargs) -> ComputeUnit:
        """Submit one Compute-Unit through the data-aware scheduler."""
        return self.manager.run(fn, *args, input_data=input_data,
                                affinity=affinity, **kwargs)

    def submit(self, cu_desc: ComputeUnitDescription, **kw) -> ComputeUnit:
        return self.manager.submit(cu_desc, **kw)

    def submit_tasks(self, items, *, retries: int = 0,
                     timeout: float = 30.0):
        """Batched function-as-task dispatch through the session's
        high-throughput task engine: the whole batch is scored in one
        policy pass and executed on the pilots' resident worker pools.
        Items may be bare callables, ``(fn, args[, kwargs])`` tuples, or
        ``ComputeUnitDescription``s; returns a ``TaskBatch`` whose
        ``results()`` preserves submit order.  ``submit``/``run`` remain
        the single-CU path with full CU semantics."""
        return self.manager.submit_tasks(items, retries=retries,
                                         timeout=timeout)

    def map_reduce(self, du: DataUnit, map_fn, reduce_fn, **kw):
        """The replica-aware pipelined map_reduce engine, bound to this
        session's manager (all map_reduce kwargs pass through)."""
        return _mapreduce.map_reduce(du, map_fn, reduce_fn,
                                     manager=self.manager, **kw)

    def kmeans(self, du: DataUnit, k: int, **kw) -> analytics.KMeansResult:
        """The paper's §4.3 KMeans over this session's scheduler."""
        return analytics.kmeans(du, k, manager=self.manager, **kw)

    # -- telemetry -------------------------------------------------------
    def stats(self) -> dict:
        """One merged view: scheduler lifetime stats, data-service
        counters, per-pilot tier residency — and, when supervised, the
        live recovery picture (heartbeat ages, suspicion levels, the
        quarantine set, respawn events, repair-queue depth, and
        per-partition current-vs-target replication)."""
        from repro_torch.core.buf import STATS as _transport_stats
        out = {"session": self.name,
               "scheduler": self.manager.stats(),
               "data": dict(self.data_service.counters),
               "pilots": self.data_service.stats(),
               # process-wide data-plane movement: bytes served as
               # zero-copy views vs bytes memcpy'd, per-codec counts
               "transport": _transport_stats.snapshot()}
        if self._supervisor is not None:
            out["supervisor"] = self._supervisor.stats()
        if self._autoscaler is not None:
            out["autoscaler"] = self._autoscaler.stats()
        if self._rebalancer is not None:
            out["rebalancer"] = self._rebalancer.stats()
        return out

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (f"PilotSession({self.name!r}, pilots="
                f"{len(self.compute.pilots)}, data={len(self._data)}, "
                f"{state})")
