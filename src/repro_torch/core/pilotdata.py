"""PilotDataService: the distributed Pilot-Data layer over per-pilot tiers.

Paper §3.3 / Fig. 5: Pilot-Data manages Data-Units *across* Pilots on
heterogeneous infrastructure, and the Compute-Data-Manager binds CUs
"taking into account the current available Pilots, their utilization and
data locality".  A single TierManager models one pilot's managed memory;
this service is the layer above it, the piece that makes "locality" a
per-pilot fact rather than one shared pool:

  * a **replica registry**: which pilot holds which partition key (each
    pilot's TierManager remains the authority for *which tier* the replica
    currently sits in — demotions inside a pilot never desynchronize the
    registry);
  * **replication**: `replicate` copies a partition into a target pilot's
    managed tiers (pull-through on read misses, explicit via
    `DataUnit.replicate_to_pilot`, async for pre-binding stage-in), with
    per-key stripe locks serializing replicate-vs-invalidate races;
  * **coherent invalidation**: a write or delete of a partition removes
    every pilot replica before/after the home copy changes, so two pilots
    can read the same partition concurrently and never observe a stale
    value after a write completes (the follow-on two-level-storage paper,
    arXiv:1508.01847, motivates exactly this replicated node-local store).

Cross-pilot replica reads (`interconnect=` / `attach_interconnect`): with
a cost model attached (repro_torch.core.scheduling.InterconnectModel — per-link
GB/s + latency between pilots, plus the home re-pull path), the fetch
path prices every way of sourcing a partition and takes the cheapest: a
CU bound to pilot A reads from sibling pilot B's replica over the
modelled link exactly when that beats re-pulling from the home store
(the checkpoint home stays the unpriced last resort).  Without a model
the home-first order is preserved bit-for-bit.

Capacity stays per-pilot: a replica landing in a full pilot demotes that
pilot's own data through *its* hierarchy (device -> host -> file), or is
refused outright when it cannot fit anywhere in the pilot — replication
never silently expands a pilot's memory ask.

Checkpoint home (`checkpoint_dir=` / `attach_checkpoint_store`): the
service can own a durable checkpoint store that acts as a **shared home**
beneath every pilot:

  * `persist(du)` writes a DU's partitions through to the store (async
    via the store's write-behind writer; `flush()` is the barrier), and
    `register(du, persist=True)` does it at registration;
  * the replica fetch path falls back to the checkpoint store when the
    home placement and every live replica are gone — so a CU retried
    after a pilot failure (volatile tiers wiped) restores its partitions
    from checkpoint instead of erroring.  Recovery is lazy: bytes come
    back one partition at a time, as reads pull them through;
  * writes stay coherent: `update_partition` refreshes the persisted
    copy alongside the replica invalidation, and `DataUnit.delete` drops
    it (`drop_persistent=True`), so the store never resurrects deleted
    or stale data.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.device import to_device
from repro_torch.core.memory import TIERS, StorageBackend
from repro_torch.core.memory import checkpoint_store as _checkpoint_store
from repro_torch.core.tiering import CapacityError, TierManager

_N_STRIPES = 32


def _as_nd(val) -> np.ndarray:
    """One conversion per hop: the fetch/replicate/persist plane already
    carries ndarrays (read-only views since PR 8), so `np.asarray` is a
    no-op for them — but routing every hop through this helper keeps the
    \"convert at most once\" contract greppable and never re-materializes
    a view that is already an ndarray."""
    return val if isinstance(val, np.ndarray) else np.asarray(val)


class PilotDataService:
    """Registry + mover for per-pilot DataUnit replicas.

    Pilots join with `register_pilot` (they must carry a TierManager — the
    per-pilot managed memory provisioned from `memory_gb`); DataUnits join
    with `register`, after which their pilot-aware reads, prefetches, and
    coherence flow through this service.
    """

    def __init__(self, max_workers: int = 4,
                 checkpoint_dir: Optional[str] = None,
                 interconnect=None):
        self._managers: Dict[str, TierManager] = {}   # pilot id -> manager
        self._replicas: Dict[str, Set[str]] = {}      # key -> pilot ids
        self._dus: Dict[str, object] = {}             # du name -> DataUnit
        self._lock = threading.Lock()                 # registry metadata
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        self._inflight: Dict[tuple, Future] = {}
        self._closed = False
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="pds-replicator")
        self.events: List[dict] = []
        self.counters: Dict[str, int] = {
            "replications": 0, "pulls": 0, "invalidations": 0,
            "replicate_refused": 0, "checkpoint_restores": 0, "persists": 0,
            "sibling_reads": 0, "home_reads": 0, "repairs": 0}
        # replication-factor repair (PR 7): per-DU target replica counts,
        # the supervisor-driven avoid set (quarantined pilots are never
        # read from NOR repaired onto), and the background repair worker
        self._repl_targets: Dict[str, tuple] = {}     # du.name -> (du, n)
        self._avoid: Set[str] = set()
        self._repair_thread: Optional[threading.Thread] = None
        self._repair_stop = threading.Event()
        self._repair_depth = 0
        # cost-modelled cross-pilot reads (repro_torch.core.scheduling.
        # InterconnectModel): with a model attached, _fetch sources a
        # partition from the CHEAPEST modelled path — a sibling pilot's
        # replica over its link, or a home re-pull — instead of always
        # going home first.  None preserves the home-first PR 3 order.
        self.interconnect = interconnect
        # the shared durable home (see module docstring); per-directory
        # shared instance, so pilots spilling to the same dir and this
        # service recover from ONE consistent store.  The service never
        # closes it — pilots naming the same dir hold the same instance,
        # and a second live instance over one directory would clobber the
        # manifest — it only flushes (the durability barrier).
        self.checkpoint_store: Optional[StorageBackend] = (
            _checkpoint_store(checkpoint_dir) if checkpoint_dir else None)

    def attach_checkpoint_store(self, store: StorageBackend
                                ) -> "PilotDataService":
        """Use an existing (possibly shared) checkpoint store as the
        durable home; the caller keeps ownership of its lifecycle."""
        self.checkpoint_store = store
        return self

    def attach_interconnect(self, model) -> "PilotDataService":
        """Enable cost-modelled cross-pilot replica reads (see
        repro_torch.core.scheduling.InterconnectModel)."""
        self.interconnect = model
        return self

    # -- membership ------------------------------------------------------
    def register_pilot(self, pilot) -> "PilotDataService":
        tm = getattr(pilot, "tier_manager", None)
        if tm is None:
            raise ValueError(
                f"pilot {pilot.id} has no TierManager: provision it with "
                "memory_gb (or attach_tier_manager) before registering")
        with self._lock:
            self._managers[pilot.id] = tm
        return self

    def unregister_pilot(self, pilot_id: str) -> None:
        """Forget a pilot: its manager stops serving replicas and its ids
        leave the registry (the data in its tiers is the releaser's to
        clean up, usually via PilotCompute.cancel -> TierManager.close)."""
        with self._lock:
            self._managers.pop(pilot_id, None)
            for pids in self._replicas.values():
                pids.discard(pilot_id)

    def register(self, du, persist: bool = False,
                 replication: int = 0):  # noqa: F821 - fwd ref
        """Bind a DataUnit to this service.  `replication` > 0 declares a
        target replica count per partition: the background repair worker
        (see `start_repair`) re-replicates any partition that falls below
        it — e.g. after a pilot death wiped one copy — from surviving
        replicas or the checkpoint home.  0 (the default) keeps the
        historical demand-driven behavior: replicas appear only where
        reads pull them."""
        du.pilot_data_service = self
        with self._lock:
            self._dus[du.name] = du
        if persist:
            self.persist(du)
        if replication > 0:
            with self._lock:
                self._repl_targets[du.name] = (du, int(replication))
        return du

    def data_units(self) -> List:
        """Every DataUnit bound to this service (evacuation and
        rebalancing sweep these — the replica registry alone maps keys,
        not partitions)."""
        with self._lock:
            return list(self._dus.values())

    # -- supervisor liveness filter --------------------------------------
    def avoid_pilot(self, pilot_id: str) -> None:
        """Quarantine a pilot for data sourcing: fetches and repair stop
        reading from (and repairing onto) its replicas until readmitted.
        The registry itself is untouched — if the pilot recovers, its
        replicas are still valid."""
        with self._lock:
            self._avoid.add(pilot_id)

    def readmit_pilot(self, pilot_id: str) -> None:
        with self._lock:
            self._avoid.discard(pilot_id)

    @property
    def avoided(self) -> frozenset:
        with self._lock:
            return frozenset(self._avoid)

    def live_holders(self, key: str) -> List[str]:
        """`holders` minus the quarantined pilots — the only holder list
        repair and cost planning may source from."""
        with self._lock:
            avoid = set(self._avoid)
        return [pid for pid in self.holders(key) if pid not in avoid]

    # -- durable home ----------------------------------------------------
    def persist(self, du, parts: Optional[Sequence[int]] = None,
                flush: bool = False) -> List[int]:
        """Write partitions of `du` through to the checkpoint store (the
        durable home replica all pilots can recover from).  Writes ride
        the store's async writer; pass flush=True (or call
        `flush_checkpoints`) for the durability barrier.  Returns the
        partition indices persisted (missing ones are skipped)."""
        store = self.checkpoint_store
        if store is None:
            raise RuntimeError("no checkpoint store attached: construct "
                               "PilotDataService(checkpoint_dir=...) or "
                               "attach_checkpoint_store first")
        done: List[int] = []
        for i in (range(du.num_partitions) if parts is None else parts):
            try:
                val = du.partition(i)
            except (KeyError, FileNotFoundError):
                continue
            store.put(du._key(i), _as_nd(val))
            done.append(i)
        with self._lock:
            self.counters["persists"] += len(done)
        if done:
            self.events.append({"op": "persist", "du": du.name,
                                "parts": len(done)})
        if flush:
            self.flush_checkpoints()
        return done

    def flush_checkpoints(self) -> None:
        """Durability barrier: every persisted byte on disk, manifest
        fsync'd (no-op without a store)."""
        store = self.checkpoint_store
        if store is not None and hasattr(store, "flush"):
            store.flush()

    def knows(self, pilot_id: str) -> bool:
        return pilot_id in self._managers

    def pilot_ids(self) -> List[str]:
        with self._lock:
            return list(self._managers)

    def manager_for(self, pilot_id: str) -> Optional[TierManager]:
        return self._managers.get(pilot_id)

    # -- queries ---------------------------------------------------------
    def _stripe(self, key: str) -> threading.Lock:
        return self._stripes[hash(key) % _N_STRIPES]

    def _holds(self, pilot_id: str, key: str) -> bool:
        with self._lock:
            return pilot_id in self._replicas.get(key, ())

    def holders(self, key: str) -> List[str]:
        """Pilots holding a replica of `key`, in registration order."""
        with self._lock:
            pids = self._replicas.get(key, ())
            return [pid for pid in self._managers if pid in pids]

    def tier_on(self, key: str, pilot_id: str) -> Optional[str]:
        """The tier `key` currently occupies inside `pilot_id` (live from
        the pilot's TierManager, so demotions are always reflected)."""
        if not self._holds(pilot_id, key):
            return None
        tm = self._managers.get(pilot_id)
        return tm.tier_of(key) if tm is not None else None

    def residency(self, du, pilot_id: str) -> Dict[str, int]:
        """Partition count per tier of `du` inside one pilot."""
        out: Dict[str, int] = {}
        for i in range(du.num_partitions):
            t = self.tier_on(du._key(i), pilot_id)
            if t is not None:
                out[t] = out.get(t, 0) + 1
        return out

    def resident_fraction(self, du, pilot_id: str, tier: str) -> float:
        if du.num_partitions == 0:
            return 0.0
        return self.residency(du, pilot_id).get(tier, 0) / du.num_partitions

    def local_fraction(self, du, pilot_id: str) -> float:
        """Fraction of `du` resident in the pilot at *any* tier."""
        if du.num_partitions == 0:
            return 0.0
        return sum(self.residency(du, pilot_id).values()) / du.num_partitions

    def best_pilot(self, key: str,
                   candidates: Sequence[str]) -> Optional[str]:
        """The candidate holding `key` at the hottest tier (ties resolve to
        the earliest candidate, keeping placement deterministic)."""
        best, best_rank = None, -1
        for pid in candidates:
            t = self.tier_on(key, pid)
            if t is None:
                continue
            rank = TIERS.index(t)
            if rank > best_rank:
                best, best_rank = pid, rank
        return best

    # -- replication -----------------------------------------------------
    def replicate(self, du, i: int, pilot_id: str,
                  tier: str = "device", pin: bool = False) -> str:
        """Ensure partition `i` of `du` is resident in `pilot_id`, copying
        it in from the home placement (or another replica) when absent and
        promoting it toward `tier` when already held colder.  Returns the
        tier the replica occupies; raises CapacityError when the partition
        cannot fit anywhere in the pilot's hierarchy.  ``pin=True`` marks
        the replica eviction-exempt inside that pilot (a serving fleet's
        model shards must survive KV-page churn)."""
        tm = self._managers.get(pilot_id)
        if tm is None:
            raise KeyError(f"unknown pilot {pilot_id!r}")
        key = du._key(i)
        with self._stripe(key):
            if self._holds(pilot_id, key) and tm.tier_of(key) is not None:
                if pin:
                    tm.pin(key)
                if tier in tm.backends:
                    try:
                        return tm.stage(key, tier)   # no-op when already hot
                    except CapacityError:
                        pass
                return tm.tier_of(key) or tier
            val = self._fetch(du, i, exclude=pilot_id, dest=pilot_id)
            dst = tier if tier in tm.backends else tm.order[-1]
            try:
                tm.put(key, _as_nd(val), dst, pinned=pin)
            except CapacityError:
                with self._lock:
                    self.counters["replicate_refused"] += 1
                self.events.append({"op": "replicate-refused", "key": key,
                                    "pilot": pilot_id, "tier": dst})
                raise
            with self._lock:
                self._replicas.setdefault(key, set()).add(pilot_id)
                self.counters["replications"] += 1
            self.events.append({"op": "replicate", "key": key,
                                "pilot": pilot_id, "tier": dst})
            return dst

    def replicate_async(self, du, i: int, pilot_id: str,
                        tier: str = "device") -> Future:
        """Queue `replicate` on the background pool (pre-binding stage-in).
        The future resolves to the landed tier, or None when the copy was
        refused for capacity / the partition vanished — never raises."""
        with self._lock:
            if self._closed:
                fut: Future = Future()
                fut.set_result(None)
                return fut
            token = (du._key(i), pilot_id)
            fut = self._inflight.get(token)
            if fut is not None and not fut.done():
                return fut
            for k in [k for k, f in self._inflight.items() if f.done()]:
                del self._inflight[k]
            fut = self._executor.submit(
                self._replicate_task, du, i, pilot_id, tier)
            self._inflight[token] = fut
            return fut

    def _replicate_task(self, du, i, pilot_id, tier) -> Optional[str]:
        try:
            return self.replicate(du, i, pilot_id, tier)
        except (CapacityError, KeyError):
            return None

    def replicate_to_pilot(self, du, pilot_id: str,
                           parts: Optional[Sequence[int]] = None,
                           tier: str = "device",
                           pin: bool = False) -> Dict[int, str]:
        """Synchronously replicate `parts` (default: all partitions) of
        `du` into a pilot; returns {partition: landed tier} for the copies
        that fit (capacity-refused or vanished partitions are skipped, not
        forced; an unregistered pilot raises).  ``pin=True`` marks the
        landed replicas eviction-exempt in that pilot."""
        if pilot_id not in self._managers:
            raise KeyError(f"unknown pilot {pilot_id!r}: register it with "
                           "register_pilot first")
        out: Dict[int, str] = {}
        for i in (range(du.num_partitions) if parts is None else parts):
            try:
                out[i] = self.replicate(du, i, pilot_id, tier, pin=pin)
            except (CapacityError, KeyError):
                continue
        return out

    # -- replication-factor repair ---------------------------------------
    def _live_replicas(self, du, i: int) -> List[str]:
        """Pilots verifiably holding partition `i` right now: registered,
        not quarantined, and their TierManager still has the bytes (a
        registry entry can outlive the data after lose_volatile)."""
        key = du._key(i)
        out: List[str] = []
        for pid in self.live_holders(key):
            tm = self._managers.get(pid)
            if tm is None or getattr(tm, "_lost", False):
                continue
            if tm.tier_of(key) is not None:
                out.append(pid)
        return out

    def under_replicated(self) -> List[tuple]:
        """Every (du, partition, current, target) below its declared
        replication target, given the pilots usable right now.  Targets
        are clamped to the usable fleet size — 2 replicas on a 1-pilot
        fleet is satisfied by 1, not permanently 'under'."""
        with self._lock:
            targets = list(self._repl_targets.values())
            avoid = set(self._avoid)
            usable = [pid for pid, tm in self._managers.items()
                      if pid not in avoid and not getattr(tm, "_lost", False)]
        out: List[tuple] = []
        for du, target in targets:
            eff = min(target, len(usable))
            if eff <= 0:
                continue
            for i in range(du.num_partitions):
                cur = len(self._live_replicas(du, i))
                if cur < eff:
                    out.append((du, i, cur, eff))
        return out

    def repair_partition(self, du, i: int, target: int,
                         tier: str = "host") -> int:
        """Bring partition `i` up to `target` live replicas, copying from
        surviving replicas or the checkpoint home (never from a
        quarantined pilot — the fetch path filters them).  New homes are
        chosen cheapest-first by the InterconnectModel when one is
        attached (re-replication is bulk traffic; it should ride the
        cheap links), else in registration order.  Returns the number of
        replicas created."""
        cur = set(self._live_replicas(du, i))
        need = target - len(cur)
        if need <= 0:
            return 0
        with self._lock:
            avoid = set(self._avoid)
            cands = [pid for pid, tm in self._managers.items()
                     if pid not in avoid and pid not in cur
                     and not getattr(tm, "_lost", False)]
        if not cands:
            return 0
        ic = self.interconnect
        if ic is not None and cur:
            nb = self.partition_nbytes(du, i)
            cands.sort(key=lambda pid: min(
                [ic.transfer_cost(src, pid, nb) for src in cur]
                + [ic.home_cost(nb)]))
        made = 0
        key = du._key(i)
        for pid in cands[:need]:
            try:
                landed = self.replicate(du, i, pid, tier)
            except (CapacityError, KeyError, FileNotFoundError):
                continue
            made += 1
            with self._lock:
                self.counters["repairs"] += 1
            self.events.append({"op": "repair", "key": key, "pilot": pid,
                                "tier": landed})
        return made

    def repair_once(self) -> int:
        """One repair sweep: re-replicate everything currently below
        target.  Returns replicas created (0 = fully replicated)."""
        work = self.under_replicated()
        self._repair_depth = len(work)
        made = 0
        for du, i, _cur, target in work:
            if self._repair_stop.is_set() and self._repair_thread is not None:
                break
            made += self.repair_partition(du, i, target)
        self._repair_depth = len(self.under_replicated())
        return made

    def start_repair(self, interval_s: float = 0.1) -> "PilotDataService":
        """Start the background repair worker (idempotent).  It sweeps
        every `interval_s`, so detection-to-repair latency is bounded by
        one interval plus copy time."""
        if self._repair_thread is not None and self._repair_thread.is_alive():
            return self
        self._repair_stop.clear()

        def _loop():
            while not self._repair_stop.wait(interval_s):
                try:
                    self.repair_once()
                except Exception:   # noqa: BLE001 - repair races teardown
                    pass

        self._repair_thread = threading.Thread(
            target=_loop, daemon=True, name="pds-repair")
        self._repair_thread.start()
        return self

    def stop_repair(self, timeout: float = 5.0) -> None:
        self._repair_stop.set()
        t = self._repair_thread
        if t is not None:
            t.join(timeout)
        self._repair_thread = None

    @property
    def repair_queue_depth(self) -> int:
        """Under-replicated partitions seen at the last repair sweep."""
        return self._repair_depth

    def replication_stats(self) -> Dict[str, dict]:
        """Per-DU current-vs-target replication: partition -> live replica
        count, the declared target, and how many partitions are below it."""
        with self._lock:
            targets = list(self._repl_targets.values())
        out: Dict[str, dict] = {}
        for du, target in targets:
            per_part = {i: len(self._live_replicas(du, i))
                        for i in range(du.num_partitions)}
            out[du.name] = {
                "target": target,
                "per_partition": per_part,
                "under": sum(1 for c in per_part.values() if c < target),
            }
        return out

    # -- scale-in drain / rebalancing ------------------------------------
    def holder_load(self, pilot_id: str) -> Dict[str, int]:
        """How much replica state a pilot is carrying right now:
        ``{"partitions": n, "nbytes": total}`` of *live* replicas (the
        registry entry must be backed by bytes in the pilot's tiers).
        The autoscaler's victim choice and the rebalancer's skew
        detection both rank pilots by this."""
        tm = self._managers.get(pilot_id)
        with self._lock:
            keys = [k for k, pids in self._replicas.items()
                    if pilot_id in pids]
        parts, nbytes = 0, 0
        if tm is not None and not getattr(tm, "_lost", False):
            for k in keys:
                if tm.tier_of(k) is None:
                    continue
                parts += 1
                try:
                    nbytes += int(tm.entry_nbytes(k))
                except KeyError:
                    continue
        return {"partitions": parts, "nbytes": nbytes}

    def _home_has(self, du, i: int) -> bool:
        """Whether the DU's home placement still holds partition `i`
        (metadata check — never pulls bytes through a throttled home)."""
        key = du._key(i)
        tm = getattr(du, "tier_manager", None)
        if tm is not None:
            return tm.tier_of(key) is not None
        try:
            return bool(du._backend(du.tier).exists(key))
        except Exception:   # noqa: BLE001 - a released home tier == gone
            return False

    def drop_replica(self, du, i: int, pilot_id: str) -> bool:
        """Remove ONE pilot's replica of partition `i` — the second half
        of a migration (`invalidate` drops every replica; a rebalance
        move must drop only the source's).  Stripe-locked against
        replicate/invalidate races.  Like `invalidate`, a durable copy
        that shared the pilot's spill store is re-persisted from the
        surviving sources, so dropping a replica never costs durability.
        Returns True when a registry entry was actually removed."""
        key = du._key(i)
        store = self.checkpoint_store
        with self._stripe(key):
            with self._lock:
                pids = self._replicas.get(key)
                held = pids is not None and pilot_id in pids
                if held:
                    pids.discard(pilot_id)
                    if not pids:
                        self._replicas.pop(key, None)
            tm = self._managers.get(pilot_id)
            if tm is None or tm.tier_of(key) is None:
                return held
            persisted = store is not None and store.exists(key)
            snap = None
            if persisted:
                # the replica may BE the persisted copy (demoted into a
                # spill tier sharing the store's directory): hold a view
                # of the bytes before delete so we can re-persist
                try:
                    snap = tm.get(key)
                except (KeyError, FileNotFoundError):
                    snap = None
            try:
                tm.delete(key)
            except Exception:   # noqa: BLE001 - a dying manager is fine
                pass
            if persisted and not store.exists(key):
                # the delete purged the shared durable copy: restore it
                # from the held view, or home / surviving replicas
                try:
                    val = (np.array(snap) if snap is not None
                           else self._fetch(du, i, exclude=pilot_id))
                    store.put(key, _as_nd(val))
                except KeyError:
                    pass
        self.events.append({"op": "drop-replica", "key": key,
                            "pilot": pilot_id})
        return held

    def evacuate_pilot(self, pilot_id: str, tier: str = "host") -> dict:
        """The data half of the autoscaler's drain protocol: make every
        partition resident in `pilot_id` survivable without it, then drop
        the pilot's replicas.

        Per resident partition, in order of preference: (1) it already
        has another live replica, a readable home placement, or a durable
        checkpoint copy — nothing to move; (2) migrate it to the
        cheapest other pilot(s) (priced by the InterconnectModel when one
        is attached, via the same `replicate` machinery repair uses), also
        topping a declared ``replication=`` target back up *excluding*
        the victim; (3) checkpoint-flush it as a last resort.  A
        partition none of those can save is left in place and counted in
        ``failed`` — the caller must then abort the release.

        Returns ``{"partitions": scanned, "migrated": n, "flushed": n,
        "dropped": n, "failed": n}``."""
        out = {"partitions": 0, "migrated": 0, "flushed": 0,
               "dropped": 0, "failed": 0}
        tm = self._managers.get(pilot_id)
        if tm is None:
            return out
        with self._lock:
            dus = list(self._dus.values())
            targets = {name: n for name, (_du, n) in
                       self._repl_targets.items()}
        flush_needed = False
        for du in dus:
            target = targets.get(du.name, 0)
            for i in range(du.num_partitions):
                key = du._key(i)
                if not self._holds(pilot_id, key) or tm.tier_of(key) is None:
                    continue
                out["partitions"] += 1
                survivors = [p for p in self._live_replicas(du, i)
                             if p != pilot_id]
                home_ok = self._home_has(du, i)
                store = self.checkpoint_store
                ckpt_ok = store is not None and store.exists(key)
                # live copies required after the victim leaves: the
                # declared replication target, and at least one anywhere
                # when no durable/home source could restore the bytes
                need = target
                if not (home_ok or ckpt_ok):
                    need = max(1, need)
                missing = need - len(survivors)
                if missing > 0:
                    with self._lock:
                        avoid = set(self._avoid)
                        cands = [pid for pid, m in self._managers.items()
                                 if pid != pilot_id and pid not in avoid
                                 and pid not in survivors
                                 and not getattr(m, "_lost", False)]
                    ic = self.interconnect
                    if ic is not None and cands:
                        nb = self.partition_nbytes(du, i)
                        cands.sort(key=lambda pid:
                                   ic.transfer_cost(pilot_id, pid, nb))
                    for pid in cands:
                        try:
                            self.replicate(du, i, pid, tier)
                        except (CapacityError, KeyError,
                                FileNotFoundError):
                            continue
                        survivors.append(pid)
                        out["migrated"] += 1
                        if len(survivors) >= need:
                            break
                if not survivors and not (home_ok or ckpt_ok):
                    # nowhere to migrate: checkpoint-flush the victim's
                    # own bytes (it may hold the only copy — the home
                    # read `persist` does would miss), the paper's
                    # durable-tier escape hatch for scale-in
                    try:
                        if store is None:
                            raise KeyError(key)
                        store.put(key, _as_nd(tm.get(key)))
                    except (KeyError, FileNotFoundError):
                        out["failed"] += 1
                        continue
                    with self._lock:
                        self.counters["persists"] += 1
                    out["flushed"] += 1
                    flush_needed = True
                self.drop_replica(du, i, pilot_id)
                out["dropped"] += 1
        if flush_needed:
            self.flush_checkpoints()    # durability barrier before release
        self.events.append({"op": "evacuate", "pilot": pilot_id, **out})
        return out

    # -- reads -----------------------------------------------------------
    def read(self, du, i: int, pilot_id: str, device: bool = False,
             pull_tier: str = "device"):
        """Read partition `i` *as the pilot*: hit the pilot's own tiers when
        a replica is resident (recording heat in that pilot's manager),
        else pull the partition through into the pilot (replicate-on-read)
        so subsequent iterations stay node-local.  A partition too large to
        cache in the pilot is served from its home without caching."""
        key = du._key(i)
        tm = self._managers.get(pilot_id)
        if tm is None:
            return du.partition_device(i) if device else du.partition(i)
        if self._holds(pilot_id, key):
            try:
                return tm.get_device(key) if device else tm.get(key)
            except (KeyError, FileNotFoundError):
                pass    # invalidated under us; fall through to a re-pull
        try:
            self.replicate(du, i, pilot_id, pull_tier)
            return tm.get_device(key) if device else tm.get(key)
        except CapacityError:
            # too large to cache in the pilot: serve without caching, via
            # the full fetch chain (home, live replicas, checkpoint home)
            with self._lock:
                self.counters["pulls"] += 1
            val = self._fetch(du, i, dest=pilot_id)
            if device:
                dev_be = tm.backends.get("device")
                return to_device(_as_nd(val), getattr(dev_be, "device", None))
            return _as_nd(val)
        except (KeyError, FileNotFoundError):
            # deleted while pulling: the home read gives the truth (and
            # raises KeyError if the partition is truly gone)
            return du.partition_device(i) if device else du.partition(i)

    def partition_nbytes(self, du, i: int) -> int:
        """Best-effort partition size for cost modelling: replica-holder
        metadata first (an in-memory dict read), then the home placement
        (FileBackend answers from the .npy header, so a throttled home
        profile is NOT charged just to price a transfer).  0 when nobody
        can say — the cost comparison then reduces to the links' fixed
        latencies."""
        key = du._key(i)
        for pid in self.holders(key):
            tm = self._managers.get(pid)
            if tm is None:
                continue
            try:
                n = tm.entry_nbytes(key)
            except KeyError:
                continue
            if n:
                return int(n)
        try:
            return int(du.partition_nbytes(i))
        except (KeyError, FileNotFoundError, AttributeError):
            return 0

    def _fetch(self, du, i: int, exclude: Optional[str] = None,
               dest: Optional[str] = None):
        """Source a partition's bytes for `dest` (the pilot pulling it).

        Without an InterconnectModel (or without a destination pilot) the
        PR 3 order applies: home placement first, then any other replica
        holder, then the durable checkpoint home (survives a released
        home tier AND pilot loss — the recovery path a retried CU
        restores through).

        With a model attached, the home re-pull and every sibling replica
        are priced (link bandwidth + latency x partition size) and tried
        cheapest-first — the ROADMAP's cross-pilot replica read: a CU
        bound to pilot A reads from sibling pilot B's memory exactly when
        the modelled link beats going back to the home store.  Ties break
        toward home (the historical order); the checkpoint store stays
        the unpriced last resort either way."""
        key = du._key(i)
        ic = self.interconnect
        # quarantined pilots are never read from: a suspect's bytes may be
        # mid-loss, and touching its TierManager can block on a dead node
        sibs = [pid for pid in self.live_holders(key)
                if pid != exclude and pid != dest]
        # (modelled cost, tiebreak, source pilot or None=home)
        if ic is not None and dest is not None and sibs:
            nbytes = self.partition_nbytes(du, i)
            plan = [(ic.home_cost(nbytes), 0, None)]
            plan += [(ic.transfer_cost(pid, dest, nbytes), 1, pid)
                     for pid in sibs]
            plan.sort(key=lambda c: (c[0], c[1]))
            costed = True
        else:
            plan = [(0.0, 0, None)] + [(0.0, 1, pid) for pid in sibs]
            costed = False
        for cost, _, pid in plan:
            if pid is None:
                try:
                    val = du.partition(i)
                except (KeyError, FileNotFoundError):
                    continue
                if costed:
                    with self._lock:
                        self.counters["home_reads"] += 1
                return val
            tm = self._managers.get(pid)
            if tm is None:
                continue
            try:
                val = tm.get(key)
            except (KeyError, FileNotFoundError):
                continue
            if costed:
                # size from the cost plan's header-only/metadata estimate —
                # never re-materialize the (possibly mmap'd) value just to
                # measure it; val is always an ndarray view here anyway
                ic.charge(pid, dest, nbytes or int(val.nbytes))
                with self._lock:
                    self.counters["sibling_reads"] += 1
                self.events.append({"op": "sibling-read", "key": key,
                                    "src": pid, "dst": dest, "cost": cost})
            return val
        store = self.checkpoint_store
        if store is not None:
            try:
                val = store.get(key)
            except (KeyError, FileNotFoundError):
                val = None
            if val is not None:
                with self._lock:
                    self.counters["checkpoint_restores"] += 1
                self.events.append({"op": "checkpoint-restore", "key": key})
                return val
        raise KeyError(key)

    # -- coherence -------------------------------------------------------
    def invalidate(self, du, i: Optional[int] = None,
                   keep: Optional[str] = None,
                   drop_persistent: bool = False) -> int:
        """Drop pilot replicas of partition `i` (or of every partition) —
        the write/delete coherence path.  `keep` preserves one pilot's
        replica (used when that pilot just produced the new value).

        The durable home stays coherent too: on a write
        (drop_persistent=False) a persisted copy is refreshed from the
        new home bytes, so recovery never restores a stale value; on a
        delete (drop_persistent=True) the persisted copy is removed, so
        the store cannot resurrect deleted data.  Returns the number of
        replicas removed."""
        idxs = range(du.num_partitions) if i is None else (i,)
        store = self.checkpoint_store
        removed = 0
        for j in idxs:
            key = du._key(j)
            with self._stripe(key):
                # snapshot BEFORE dropping replicas: a replica manager's
                # delete also purges its untracked durable copies, which
                # may live in this very store when the pilots spill to it
                persisted = store is not None and store.exists(key)
                with self._lock:
                    pids = self._replicas.pop(key, set())
                    if keep is not None and keep in pids:
                        self._replicas[key] = {keep}
                dropped = 0
                for pid in pids:
                    if pid == keep:
                        continue
                    tm = self._managers.get(pid)
                    if tm is not None:
                        tm.delete(key)
                        dropped += 1
                if persisted:
                    if drop_persistent:
                        store.delete(key)
                    else:
                        try:
                            store.put(key, _as_nd(du.partition(j)))
                        except (KeyError, FileNotFoundError):
                            store.delete(key)   # home gone: don't go stale
                if dropped:
                    self.events.append({"op": "invalidate", "key": key,
                                        "replicas": dropped})
                removed += dropped
        with self._lock:
            self.counters["invalidations"] += removed
        return removed

    # -- telemetry / shutdown -------------------------------------------
    def stats(self) -> Dict[str, dict]:
        """Per-pilot TierManager stats (usage/budget/entries per tier)."""
        with self._lock:
            managers = dict(self._managers)
        return {pid: tm.stats() for pid, tm in managers.items()}

    def drain(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            futs = list(self._inflight.values())
        for f in futs:
            if not f.cancelled():
                try:
                    f.result(timeout)
                except Exception:   # noqa: BLE001 - refusals are normal
                    pass

    def close(self) -> None:
        """Stop the replicator pool and flush the checkpoint store so
        every persisted byte is durable and the manifest is fsync'd.  The
        store itself stays open (it is shared per directory with the
        pilots' spill tiers; its writer thread is a daemon) — closing it
        here while another holder still wrote to it would fork two live
        manifests over one directory.  Idempotent; registry and store
        stay readable."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.stop_repair()
        self._executor.shutdown(wait=True, cancel_futures=True)
        with self._lock:
            self._inflight.clear()
        self.flush_checkpoints()

    def __repr__(self) -> str:
        with self._lock:
            return (f"PilotDataService(pilots={len(self._managers)}, "
                    f"replicated_keys={len(self._replicas)})")
