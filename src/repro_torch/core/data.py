"""Data-Units: named, partitioned datasets with affinity + tier placement.

Paper §3: "A Data-Unit represents a self-contained, related set of data";
Pilot-Data manages DUs across heterogeneous storage, ensures availability
before a Compute-Unit starts, and exposes *affinity labels* so the scheduler
can co-locate compute with data. A DU's partitions live in storage tiers
(file/object/host/device) and can be moved (staged) between tiers explicitly
or by the ComputeDataManager's late-binding placement.

With a TierManager attached (repro_torch.core.tiering) the DU becomes part of a
*managed* hierarchy: `tier` is the preferred/nominal placement, but each
partition's actual residency is tracked by the manager, which enforces
capacity budgets, demotes LRU partitions under pressure, promotes hot ones,
and stages asynchronously. Reads always go through the manager so they find
a partition wherever it currently lives and record access heat.

Bound to a PilotDataService (repro_torch.core.pilotdata) the DU additionally
grows *per-pilot replica residency*: a partition can be resident in
several pilots' managed tiers at once.  Pilot-aware reads
(`partition(i, pilot=...)`) hit that pilot's own tiers and pull the
partition through on a miss; `replicate_to_pilot` copies a working set
into a pilot explicitly; writes (`update_partition`) and `delete`
invalidate every replica coherently.  The home placement (this DU's own
`tier_manager`/backends) stays the source of truth the replicas are
pulled from.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.buf import Buf, materialize, zero_copy_enabled
from repro_torch.core.device import to_device
from repro_torch.core.memory import StorageBackend, TIERS
from repro_torch.core.tiering import TierManager


@dataclasses.dataclass(frozen=True)
class DataUnitDescription:
    name: str
    affinity: str = ""              # label, e.g. "pilot-0" / "us-east"
    preferred_tier: str = "file"


class DataUnit:
    """A partitioned dataset resident in one (managed) storage tier."""

    def __init__(self, description: DataUnitDescription,
                 backends: Dict[str, StorageBackend],
                 num_partitions: int = 0,
                 tier_manager: Optional[TierManager] = None):
        self.description = description
        self.name = description.name or f"du-{uuid.uuid4().hex[:8]}"
        self.backends = backends
        self.num_partitions = num_partitions
        self.tier: str = description.preferred_tier
        self.tier_manager = tier_manager
        self.pilot_data_service = None       # set by PilotDataService.register
        self._lock = threading.Lock()
        self.transfer_log: List[dict] = []   # telemetry for benchmarks

    # ------------------------------------------------------------------
    @classmethod
    def from_partitions(cls, name: str, parts: Sequence[np.ndarray],
                        backends: Dict[str, StorageBackend],
                        tier: str = "host", affinity: str = "",
                        tier_manager: Optional[TierManager] = None
                        ) -> "DataUnit":
        du = cls(DataUnitDescription(name, affinity, tier), backends,
                 num_partitions=len(parts), tier_manager=tier_manager)
        if tier_manager is not None:
            for i, p in enumerate(parts):
                tier_manager.put(du._key(i), np.asarray(p), tier)
        else:
            be = du._backend(tier)
            for i, p in enumerate(parts):
                be.put(du._key(i), np.asarray(p))
        du.tier = tier
        return du

    @classmethod
    def from_array(cls, name: str, arr: np.ndarray, num_partitions: int,
                   backends: Dict[str, StorageBackend], tier: str = "host",
                   affinity: str = "",
                   tier_manager: Optional[TierManager] = None) -> "DataUnit":
        parts = np.array_split(np.asarray(arr), num_partitions, axis=0)
        return cls.from_partitions(name, parts, backends, tier, affinity,
                                   tier_manager=tier_manager)

    # ------------------------------------------------------------------
    def _key(self, i: int) -> str:
        return f"{self.name}/part{i:05d}"

    def _backend(self, tier: str) -> StorageBackend:
        if tier not in self.backends:
            raise KeyError(f"DataUnit {self.name}: no backend for tier {tier!r}"
                           f" (have {sorted(self.backends)})")
        return self.backends[tier]

    @property
    def affinity(self) -> str:
        return self.description.affinity

    def attach_tier_manager(self, tm: TierManager) -> "DataUnit":
        """Adopt this DU's partitions into a managed hierarchy.

        The manager's backends replace the DU's flat backend dict; existing
        partitions are registered (and count against budgets) in place when
        the manager wraps the same backend, else copied into the manager's.
        """
        same = tm.backends.get(self.tier) is self.backends.get(self.tier)
        for i in range(self.num_partitions):
            if same:
                tm.adopt(self._key(i), self.tier)
            else:
                tm.put(self._key(i),
                       self._backend(self.tier).get(self._key(i)), self.tier)
        self.backends = tm.backends
        self.tier_manager = tm
        return self

    def _pilot_route(self, pilot) -> Optional[str]:
        """Resolve a pilot argument (PilotCompute or id string) to a pilot
        id this DU's PilotDataService can serve, else None (home read)."""
        if pilot is None or self.pilot_data_service is None:
            return None
        pid = pilot if isinstance(pilot, str) else getattr(pilot, "id", None)
        if pid is not None and self.pilot_data_service.knows(pid):
            return pid
        return None

    def partition(self, i: int, pilot=None) -> np.ndarray:
        """Partition bytes as a read-only ndarray view (zero-copy: the
        serving tier's mmap/aliasing/dlpack view — see repro_torch.core.buf).
        Mutating callers take `partition_copy` instead."""
        pid = self._pilot_route(pilot)
        if pid is not None:
            return self.pilot_data_service.read(self, i, pid)
        key = self._key(i)
        if self.tier_manager is not None:
            return self.tier_manager.get(key)
        # a concurrent to_tier() moves copy-first/delete-last, so on a miss
        # the partition is guaranteed to exist in some other tier — retry
        for _ in range(8):
            try:
                return self._backend(self.tier).get(key)
            except (KeyError, FileNotFoundError):
                for t in reversed(TIERS):
                    be = self.backends.get(t)
                    if be is None or t == self.tier:
                        continue
                    try:
                        if be.exists(key):
                            return be.get(key)
                    except (KeyError, FileNotFoundError):
                        continue
        raise KeyError(key)

    def partition_buf(self, i: int, pilot=None) -> Buf:
        """Like `partition`, wrapped in a `Buf` carrying provenance (which
        tier/pilot served the bytes) — the view the pipelined stage-in and
        worker-local read paths move end to end."""
        pid = self._pilot_route(pilot)
        if pid is not None:
            arr = self.pilot_data_service.read(self, i, pid)
            return Buf(arr, source=f"pilot:{pid}",
                       owned=not zero_copy_enabled())
        if self.tier_manager is not None:
            return self.tier_manager.get_buf(self._key(i))
        return Buf(self.partition(i), source=self.tier,
                   owned=not zero_copy_enabled())

    def partition_copy(self, i: int, pilot=None) -> np.ndarray:
        """An owned, writable copy of partition `i` — the sanctioned path
        for callers that mutate fetched bytes (records bytes_copied)."""
        return materialize(self.partition(i, pilot=pilot))

    def partition_device(self, i: int, pilot=None) -> torch.Tensor:
        pid = self._pilot_route(pilot)
        if pid is not None:
            return self.pilot_data_service.read(self, i, pid, device=True)
        if self.tier_manager is not None:
            return self.tier_manager.get_device(self._key(i))
        be = self._backend(self.tier)
        if hasattr(be, "get_device"):
            return be.get_device(self._key(i))
        dev_be = self.backends.get("device")
        return to_device(be.get(self._key(i)), getattr(dev_be, "device", None))

    def partitions(self) -> Iterable[np.ndarray]:
        for i in range(self.num_partitions):
            yield self.partition(i)

    def nbytes(self) -> int:
        return sum(self.partition_nbytes(i)
                   for i in range(self.num_partitions))

    def partition_nbytes(self, i: int) -> int:
        """One partition's size in bytes without pulling its payload
        through a (possibly throttled) tier — TierManager metadata when
        managed, else the home backend's nbytes (FileBackend answers from
        the .npy header).  Used by the interconnect cost model to price
        transfers."""
        key = self._key(i)
        if self.tier_manager is not None:
            return int(self.tier_manager.entry_nbytes(key))
        return int(self._backend(self.tier).nbytes(key))

    # -- managed-hierarchy surface -------------------------------------
    def residency(self) -> Dict[str, int]:
        """Partition count per tier of *actual* residency."""
        if self.tier_manager is None:
            return {self.tier: self.num_partitions}
        out: Dict[str, int] = {}
        for i in range(self.num_partitions):
            t = self.tier_manager.tier_of(self._key(i))
            if t is not None:
                out[t] = out.get(t, 0) + 1
        return out

    def resident_fraction(self, tier: str) -> float:
        if self.num_partitions == 0:
            return 0.0
        if self.tier_manager is None:
            return 1.0 if self.tier == tier else 0.0
        return self.residency().get(tier, 0) / self.num_partitions

    def pin(self) -> "DataUnit":
        """Exempt every partition from eviction (Spark persist() analogue)."""
        if self.tier_manager is not None:
            self.tier_manager.pin([self._key(i)
                                   for i in range(self.num_partitions)])
        return self

    def unpin(self) -> "DataUnit":
        if self.tier_manager is not None:
            self.tier_manager.unpin([self._key(i)
                                     for i in range(self.num_partitions)])
        return self

    def prefetch(self, i: int, tier: str = "host",
                 pilot=None) -> Optional[Future]:
        """Async-stage partition i toward a hotter tier (no-op unmanaged,
        out of range, or already at least that hot).  With `pilot` set and
        the DU bound to a PilotDataService, the stage targets *that pilot's*
        tiers instead (async replication toward the pilot)."""
        if not 0 <= i < self.num_partitions:
            return None
        pid = self._pilot_route(pilot)
        if pid is not None:
            return self.pilot_data_service.replicate_async(self, i, pid, tier)
        if self.tier_manager is None:
            return None
        return self.tier_manager.prefetch(self._key(i), tier)

    def prefetch_window(self, start: int, depth: int, tier: str = "host",
                        wrap: bool = False, pilot=None) -> List[Future]:
        """Issue async prefetches for partitions [start, start+depth) toward
        `tier` (the depth-k pipeline hint). With wrap=True indices cycle
        modulo num_partitions (streaming input pipelines). Returns the
        futures of the stages actually queued."""
        futs: List[Future] = []
        n = self.num_partitions
        if n == 0 or (self.tier_manager is None
                      and self._pilot_route(pilot) is None):
            return futs
        for j in range(depth):
            i = start + j
            if wrap:
                i %= n
            elif i >= n:
                break
            f = self.prefetch(i, tier, pilot=pilot)
            if f is not None:
                futs.append(f)
        return futs

    # -- per-pilot replica surface ---------------------------------------
    def replicate_to_pilot(self, pilot, parts=None, tier: str = "device",
                           pin: bool = False) -> Dict[int, str]:
        """Copy partitions into a pilot's managed tiers (requires binding
        via PilotDataService.register); returns {partition: landed tier}.
        ``pin=True`` exempts the landed replicas from that pilot's
        eviction (model shards must not be churned out by request
        state)."""
        if self.pilot_data_service is None:
            raise RuntimeError(f"DataUnit {self.name}: not bound to a "
                               "PilotDataService")
        pid = pilot if isinstance(pilot, str) else pilot.id
        return self.pilot_data_service.replicate_to_pilot(
            self, pid, parts=parts, tier=tier, pin=pin)

    def replica_residency(self, pilot) -> Dict[str, int]:
        """Partition count per tier inside one pilot (empty if unbound)."""
        pid = self._pilot_route(pilot)
        if pid is None:
            return {}
        return self.pilot_data_service.residency(self, pid)

    def replica_fraction(self, pilot, tier: str = "device") -> float:
        pid = self._pilot_route(pilot)
        if pid is None:
            return 0.0
        return self.pilot_data_service.resident_fraction(self, pid, tier)

    def persist(self, parts=None, flush: bool = False) -> List[int]:
        """Write partitions through to the PilotDataService's durable
        checkpoint home (the recovery source after pilot loss); requires
        binding via `PilotDataService.register`.  Async by default —
        `flush=True` is the durability barrier."""
        if self.pilot_data_service is None:
            raise RuntimeError(f"DataUnit {self.name}: not bound to a "
                               "PilotDataService")
        return self.pilot_data_service.persist(self, parts=parts,
                                               flush=flush)

    def append_partition(self, value) -> int:
        """Grow the DU by one partition and return its index.

        Dynamically-arriving state — e.g. a serving engine's per-request
        KV pages — needs partitions that appear after registration.  The
        new partition lands in the home placement under the DU lock (the
        index is published only after the bytes exist, so a concurrent
        reader iterating ``range(num_partitions)`` never sees a hole),
        and from then on behaves like any other partition: pilot replica
        reads, ``update_partition`` coherence, ``persist`` to the durable
        tier, replication-factor repair."""
        arr = np.asarray(value)
        with self._lock:
            i = self.num_partitions
            key = self._key(i)
            if self.tier_manager is not None:
                self.tier_manager.put(key, arr, self.tier)
            else:
                self._backend(self.tier).put(key, arr)
            self.num_partitions = i + 1
        return i

    def update_partition(self, i: int, value) -> "DataUnit":
        """Coherent write: the new value lands in the home placement and
        every per-pilot replica is invalidated, so a subsequent pilot read
        re-pulls the fresh bytes instead of serving a stale copy."""
        if not 0 <= i < self.num_partitions:
            raise IndexError(f"partition {i} out of range "
                             f"[0, {self.num_partitions})")
        arr = np.asarray(value)
        if self.tier_manager is not None:
            self.tier_manager.put(self._key(i), arr, self.tier)
        else:
            self._backend(self.tier).put(self._key(i), arr)
        if self.pilot_data_service is not None:
            self.pilot_data_service.invalidate(self, i)
        return self

    # ------------------------------------------------------------------
    def to_tier(self, tier: str, delete_source: bool = True) -> "DataUnit":
        """Stage every partition into another tier (paper: stage-in/out)."""
        if tier == self.tier:
            return self
        t0 = time.perf_counter()
        moved = 0
        if self.tier_manager is not None:
            tm = self.tier_manager
            with self._lock:
                for i in range(self.num_partitions):
                    key = self._key(i)
                    tm.stage(key, tier, keep_source=not delete_source)
                    moved += tm.entry_nbytes(key)
                old, self.tier = self.tier, tier
        else:
            src, dst = self._backend(self.tier), self._backend(tier)
            with self._lock:
                for i in range(self.num_partitions):
                    arr = src.get(self._key(i))
                    dst.put(self._key(i), arr)
                    moved += int(arr.nbytes)
                    if delete_source:
                        src.delete(self._key(i))
                old, self.tier = self.tier, tier
        self.transfer_log.append({
            "from": old, "to": tier, "bytes": moved,
            "seconds": time.perf_counter() - t0})
        return self

    def to_tier_async(self, tier: str) -> List[Future]:
        """Queue every partition onto the background stager; returns the
        per-partition futures. `tier` becomes the nominal placement at once;
        reads stay consistent throughout because they follow actual
        residency via the TierManager."""
        if self.tier_manager is None:
            self.to_tier(tier)
            return []
        futs = [self.tier_manager.stage_async(self._key(i), tier)
                for i in range(self.num_partitions)]
        self.tier = tier
        return futs

    def replicate_to(self, tier: str) -> "DataUnit":
        return self.to_tier(tier, delete_source=False)

    def delete(self) -> None:
        # home copy first, replicas second: a pull-through racing the
        # delete can only re-replicate while the home copy still exists,
        # and the trailing invalidation clears any such resurrection — the
        # opposite order would leak an ownerless replica into a pilot's
        # budget forever
        if self.tier_manager is not None:
            for i in range(self.num_partitions):
                self.tier_manager.delete(self._key(i))
        else:
            be = self._backend(self.tier)
            for i in range(self.num_partitions):
                be.delete(self._key(i))
        if self.pilot_data_service is not None:
            # drop_persistent: the durable checkpoint home must not
            # resurrect a deleted DU through the recovery fetch path
            self.pilot_data_service.invalidate(self, drop_persistent=True)

    def __repr__(self) -> str:
        return (f"DataUnit({self.name!r}, parts={self.num_partitions}, "
                f"tier={self.tier!r}, affinity={self.affinity!r})")
