"""TierManager: a capacity-aware memory hierarchy over Pilot-Data tiers.

The paper's central extension is Pilot-Data *Memory*: memory retained for a
set of tasks so iterative analytics never re-stage inputs (§3.3, the 212x
KMeans effect; the two-level-storage follow-up arXiv:1508.01847 gets the
same win from a managed burst-buffer tier). The flat backends in
repro_torch.core.memory give the tiers themselves; this module adds the
management the paper assigns to Pilot-Data:

  * per-tier capacity budgets (bytes) — HBM and host RAM are finite;
  * pluggable eviction that *demotes* a partition to the next-colder tier
    (device -> host -> object/file -> checkpoint) instead of dropping it,
    so data is never lost to pressure.  With a checkpoint tier attached
    (the durable manifest-backed store of repro_torch.core.memory) the hierarchy
    bottoms out on disk: pressure beyond the volatile budgets spills the
    coldest partitions to persistent storage and reads restore them
    lazily through the same copy-first/delete-last protocol, with heat
    promotion pulling hot restorees back up.  Policies: plain LRU
    (default, recency only)
    and GDSF (Greedy-Dual-Size-Frequency: priority = frequency x
    cost-of-restage / size, so a small hot partition outlives a large cold
    one even when the cold one was touched more recently);
  * eviction hysteresis: freshly demoted partitions sit out promotion (and
    freshly promoted ones are deprioritized as victims) for a configurable
    number of clock ticks, bounding demote/promote ping-pong under
    adversarial alternating access patterns;
  * access-heat tracking with automatic promotion of hot partitions
    toward the device tier (the Spark `persist()` analogue);
  * `pin`/`unpin` so a working set can be exempted from eviction;
  * an async staging pipeline (thread-pool stager returning futures) so
    stage-in/promotion overlaps with Compute-Unit execution.

Hot-path accounting is amortized: reads never take the manager-wide
metadata lock.  Residency lookup is a plain (GIL-atomic) dict read whose
staleness is tolerated by the copy-first/delete-last move protocol, and
heat/recency updates land in a sharded access ledger (one small lock per
shard, touched by at most a handful of readers each) that is folded into
the authoritative entries in batches — on shard overflow, when a key has
accumulated enough heat to matter for promotion, and always right before
an eviction decision, so LRU/GDSF victim selection still sees exact
recency and frequency.

A partition (key) is resident in exactly one managed tier at a time.
Moves — explicit stages *and* pressure demotions — copy to the destination
*before* deleting the source and flip the residency metadata in between,
so concurrent readers observe either-tier-consistent data and never a
hole.  The copy itself always runs outside the metadata lock (demotion
victims are fenced with the `_moving` marker while their bytes drain to
the colder tier), so a throttled cold tier never serializes concurrent
readers or stagers during reservation.

Zero-copy plane (PR 8): backend reads hand out read-only *views*
(mmap'd files, aliasing host views, dlpack device views — see
repro_torch.core.buf), so a move's get+put pipes a view straight into the
destination encoder and the only memcpy in a demotion is the cold
tier's own write.  Deleting the source after the flip only drops the
store's reference: a reader's live view pins the backing bytes (numpy
base / mmap'd inode / dlpack capsule), so demotion and eviction can
never mutate data under a reader.  `get_buf` returns the same view
wrapped with provenance.

Multi-pilot note: one TierManager manages ONE pilot's tiers.  Cross-pilot
replication and coherence live a layer up in
repro_torch.core.pilotdata.PilotDataService, which owns the mapping from
partition keys to the set of per-pilot managers holding a replica.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.buf import Buf, zero_copy_enabled
from repro_torch.core.device import to_device
from repro_torch.core.memory import (DEFAULT_TIER_BANDWIDTH, DURABLE_TIERS,
                               StorageBackend, TIERS)


class CapacityError(RuntimeError):
    """A tier budget cannot be satisfied (value too large or all pinned)."""


@dataclasses.dataclass
class _Entry:
    key: str
    tier: str
    nbytes: int
    pinned: bool = False
    heat: int = 0               # accesses since the last promotion decision
    freq: int = 0               # lifetime accesses (GDSF frequency term)
    last_access: int = 0
    no_promote_until: int = 0   # hysteresis stamp set on demotion
    no_demote_until: int = 0    # hysteresis stamp set on promotion


# -- eviction policies ---------------------------------------------------
class EvictionPolicy:
    """Chooses the victim among evictable entries of an over-budget tier.

    `candidates` is never empty, already filtered to unpinned, not-in-
    flight, not-excluded entries of `tier`.  Called with the manager's
    metadata lock held, so implementations must not call back into
    locking TierManager methods other than `_restage_cost_entry`.
    """

    name = "policy"

    def select_victim(self, tier: str, candidates: Sequence[_Entry],
                      manager: "TierManager") -> _Entry:
        raise NotImplementedError

    def on_evict(self, tier: str, entry: _Entry,
                 manager: "TierManager") -> None:
        """Hook invoked just before `entry` is demoted out of `tier`."""


class LRUPolicy(EvictionPolicy):
    """Pure recency (the PR 1 behavior; default)."""

    name = "lru"

    def select_victim(self, tier, candidates, manager):
        return min(candidates, key=lambda e: e.last_access)


class GDSFPolicy(EvictionPolicy):
    """Greedy-Dual-Size-Frequency with cost-of-restage weighting.

    priority(e) = L(tier at access time) + (1 + freq(e)) * restage_cost(e)
                  / size(e)

    restage_cost is the estimated seconds to bring the partition back
    (read from the next-colder tier + write back into this one), derived
    from the TierProfile bandwidths/latencies, so evicting data that is
    expensive to re-stage requires proportionally more pressure.  L is the
    classic GDSF aging term: each eviction inflates it to the evicted
    priority, and an entry's priority is *frozen with the L current at its
    last access* (recomputed only when its freq/tier changes), so a once-
    hot long-idle entry keeps its stale small-L priority while freshly
    accessed entries earn the inflated one — long-idle data eventually
    becomes evictable instead of squatting on its lifetime frequency.
    """

    name = "gdsf"

    def __init__(self):
        self._L: Dict[str, float] = {}
        # key -> (freq, tier, H): H computed with L at that access state
        self._h: Dict[str, tuple] = {}

    def priority(self, entry: _Entry, manager: "TierManager") -> float:
        cached = self._h.get(entry.key)
        if (cached is not None and cached[0] == entry.freq
                and cached[1] == entry.tier):
            return cached[2]
        cost = manager._restage_cost_entry(entry)
        h = (self._L.get(entry.tier, 0.0)
             + (1.0 + entry.freq) * cost / max(entry.nbytes, 1))
        self._h[entry.key] = (entry.freq, entry.tier, h)
        return h

    def select_victim(self, tier, candidates, manager):
        return min(candidates,
                   key=lambda e: (self.priority(e, manager), e.last_access))

    def on_evict(self, tier, entry, manager):
        self._L[tier] = self.priority(entry, manager)
        self._h.pop(entry.key, None)
        if len(self._h) > 2 * len(manager._entries):
            self._h = {k: v for k, v in self._h.items()
                       if k in manager._entries}


def make_policy(policy: Union[str, EvictionPolicy]) -> EvictionPolicy:
    if isinstance(policy, EvictionPolicy):
        return policy
    if policy == "lru":
        return LRUPolicy()
    if policy == "gdsf":
        return GDSFPolicy()
    raise ValueError(f"unknown eviction policy {policy!r} "
                     "(expected 'lru', 'gdsf', or an EvictionPolicy)")


# -- amortized access accounting ----------------------------------------
class _AccessLedger:
    """Sharded pending-access counters; the lock-contention absorber.

    Readers record (count, last-clock) per key under a shard-local lock and
    the shards are drained into the authoritative entries in batches.  The
    global metadata lock is never taken on the record path; drain() is only
    called by holders of the metadata lock (lock order: meta -> shard)."""

    def __init__(self, nshards: int = 8, flush_every: int = 64,
                 key_trigger: int = 0):
        self.nshards = max(1, nshards)
        self.flush_every = max(1, flush_every)
        self.key_trigger = key_trigger      # promote_threshold fast path
        self._shards: List[Dict[str, List[int]]] = [
            {} for _ in range(self.nshards)]
        self._locks = [threading.Lock() for _ in range(self.nshards)]
        self._pending = [0] * self.nshards

    def record(self, key: str, clock: int) -> Tuple[bool, int]:
        """Note one access; returns (flush-now?, key's pending count)."""
        i = hash(key) % self.nshards
        with self._locks[i]:
            ent = self._shards[i].get(key)
            if ent is None:
                ent = self._shards[i][key] = [0, 0]
            ent[0] += 1
            if clock > ent[1]:
                ent[1] = clock
            self._pending[i] += 1
            flush = (self._pending[i] >= self.flush_every
                     or (self.key_trigger > 0 and ent[0] >= self.key_trigger))
            return flush, ent[0]

    def drain(self) -> Dict[str, Tuple[int, int]]:
        out: Dict[str, Tuple[int, int]] = {}
        for i in range(self.nshards):
            with self._locks[i]:
                if not self._shards[i]:
                    continue
                for k, (cnt, last) in self._shards[i].items():
                    prev = out.get(k)
                    if prev is None:
                        out[k] = (cnt, last)
                    else:
                        out[k] = (prev[0] + cnt, max(prev[1], last))
                self._shards[i].clear()
                self._pending[i] = 0
        return out


class TierManager:
    """Managed placement of named partitions across storage tiers.

    backends — tier name -> StorageBackend (any subset of TIERS).
    budgets  — tier name -> capacity in bytes; missing/None = unbounded.
    promote_threshold — accesses after which a partition is asynchronously
        promoted one tier hotter (0 disables auto-promotion).
    policy — eviction policy: "lru" (default), "gdsf", or an
        EvictionPolicy instance.
    hysteresis — clock ticks a demoted partition sits out re-promotion
        (and a promoted one is deprioritized as a victim); 0 disables.
    """

    def __init__(self, backends: Dict[str, StorageBackend],
                 budgets: Optional[Dict[str, Optional[int]]] = None,
                 *, promote_threshold: int = 4, max_workers: int = 2,
                 policy: Union[str, EvictionPolicy] = "lru",
                 hysteresis: int = 0, ledger_shards: int = 8,
                 ledger_flush_every: int = 64):
        unknown = set(backends) - set(TIERS)
        if unknown:
            raise ValueError(f"unknown tiers {sorted(unknown)}")
        self.backends = dict(backends)
        # cold -> hot, restricted to the tiers that actually have backends
        self.order: List[str] = [t for t in TIERS if t in backends]
        self.budgets: Dict[str, Optional[int]] = {
            t: (budgets or {}).get(t) for t in self.order}
        self.promote_threshold = promote_threshold
        self.policy = make_policy(policy)
        self.hysteresis = int(hysteresis)
        self._entries: Dict[str, _Entry] = {}
        self._usage: Dict[str, int] = {t: 0 for t in self.order}
        self._peak: Dict[str, int] = {t: 0 for t in self.order}
        self._tick = itertools.count(1)   # GIL-atomic monotonic clock
        self._latest_tick = 0
        self._ledger = _AccessLedger(ledger_shards, ledger_flush_every,
                                     key_trigger=promote_threshold)
        self._meta = threading.RLock()
        self._moving: set = set()      # keys with a copy in flight
        self._inflight: Dict[tuple, Future] = {}
        self._closed = False
        self._lost = False             # node death: refuse new placements
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="tier-stager")
        self.events: List[dict] = []   # telemetry: evict/demote/promote/stage
        self.counters: Dict[str, int] = {
            "demotions": 0, "promotions": 0, "bytes_demoted": 0,
            "bytes_promoted": 0, "stage_refused": 0}

    # -- clock ----------------------------------------------------------
    def _tick_next(self) -> int:
        t = next(self._tick)
        self._latest_tick = t   # benign race: only needs to be monotone-ish
        return t

    def _now(self) -> int:
        return self._latest_tick

    # -- introspection --------------------------------------------------
    def budget(self, tier: str) -> Optional[int]:
        return self.budgets.get(tier)

    def usage(self, tier: str) -> int:
        with self._meta:
            return self._usage.get(tier, 0)

    def peak_usage(self, tier: str) -> int:
        with self._meta:
            return self._peak.get(tier, 0)

    def tier_of(self, key: str) -> Optional[str]:
        e = self._entries.get(key)
        return e.tier if e else None

    def entry_nbytes(self, key: str) -> int:
        with self._meta:
            return self._entries[key].nbytes

    def resident_keys(self, tier: str) -> List[str]:
        with self._meta:
            return [k for k, e in self._entries.items() if e.tier == tier]

    def stats(self) -> Dict[str, dict]:
        with self._meta:
            self._apply_ledger_locked(allow_promote=False)
            out = {}
            for t in self.order:
                ent = [e for e in self._entries.values() if e.tier == t]
                out[t] = {"usage": self._usage[t], "peak": self._peak[t],
                          "budget": self.budgets[t], "entries": len(ent),
                          "pinned": sum(e.pinned for e in ent)}
            return out

    def event_summary(self) -> Dict[str, int]:
        """Cumulative movement counters (for benchmarks/CI artifacts)."""
        with self._meta:
            return dict(self.counters)

    def restage_cost(self, key: str) -> float:
        """Estimated seconds to re-stage `key` from the next-colder tier."""
        with self._meta:
            return self._restage_cost_entry(self._entries[key])

    def _transfer_cost(self, src: str, dst: str, nbytes: int) -> float:
        """Seconds to read `nbytes` from `src` and write them into `dst`
        (profile bandwidths, nominal per-tier defaults when unthrottled)."""
        rp = self.backends[src].profile
        read_bw = rp.read_bw or DEFAULT_TIER_BANDWIDTH.get(src, 1e9)
        wp = self.backends[dst].profile if dst in self.backends else rp
        write_bw = wp.write_bw or DEFAULT_TIER_BANDWIDTH.get(dst, 1e9)
        return (rp.latency + nbytes / read_bw
                + wp.latency + nbytes / write_bw)

    def _restage_cost_entry(self, e: _Entry) -> float:
        colder = self._colder(e.tier) or e.tier
        return self._transfer_cost(colder, e.tier, e.nbytes)

    def promote_cost(self, key: str, tier: str) -> float:
        """Estimated seconds to stage `key` from where it currently resides
        into `tier` — the lazy-restore cost a prefetch planner should
        budget for.  Unlike `restage_cost` (the hypothetical cost of
        bringing the key back after one more demotion), this bills the
        bandwidth of the key's ACTUAL tier, so a checkpoint-resident
        partition is priced at the persistent store's bandwidth, not the
        host tier's."""
        with self._meta:
            e = self._entries[key]
            if e.tier == tier:
                return 0.0
            return self._transfer_cost(e.tier, tier, e.nbytes)

    # -- internal helpers (meta lock held) ------------------------------
    def _hotter(self, tier: str) -> Optional[str]:
        i = self.order.index(tier)
        return self.order[i + 1] if i + 1 < len(self.order) else None

    def _colder(self, tier: str) -> Optional[str]:
        i = self.order.index(tier)
        return self.order[i - 1] if i > 0 else None

    def _touch(self, e: _Entry) -> None:
        e.last_access = self._tick_next()
        e.heat += 1
        e.freq += 1

    def _charge(self, tier: str, nbytes: int) -> None:
        self._usage[tier] += nbytes
        if self._usage[tier] > self._peak[tier]:
            self._peak[tier] = self._usage[tier]

    def _apply_ledger_locked(self, allow_promote: bool = True) -> List[tuple]:
        """Fold pending ledger records into the entries; return promotion
        targets (key, tier) to schedule once the lock is released."""
        recs = self._ledger.drain()
        promote: List[tuple] = []
        if not recs:
            return promote
        now = self._now()
        for key, (cnt, last) in recs.items():
            e = self._entries.get(key)
            if e is None:
                continue
            e.heat += cnt
            e.freq += cnt
            if last > e.last_access:
                e.last_access = last
            if (allow_promote and self.promote_threshold
                    and e.heat >= self.promote_threshold):
                # the decision consumes the heat either way: blocked keys
                # (hysteresis, hottest tier, oversized) re-earn it instead
                # of re-triggering a flush on every subsequent read
                e.heat = 0
                if now < e.no_promote_until:
                    continue
                hot = self._hotter(e.tier)
                budget = self.budgets.get(hot) if hot else None
                if hot is not None and (budget is None
                                        or e.nbytes <= budget):
                    promote.append((key, hot))
        return promote

    def _flush_accounting(self) -> None:
        with self._meta:
            promote = self._apply_ledger_locked()
        for key, tier in promote:
            self.stage_async(key, tier)

    def _fits_locked(self, tier: str, need: int) -> bool:
        """Whether charging `need` bytes keeps `tier` within budget (meta
        lock held). Raises CapacityError when `need` can never fit."""
        budget = self.budgets.get(tier)
        if budget is None or need <= 0:
            return True
        if need > budget:
            raise CapacityError(
                f"{need} bytes exceed the whole {tier!r} budget ({budget})")
        return self._usage[tier] + need <= budget

    def _evict_one(self, tier: str, exclude: frozenset,
                   deadline: float) -> None:
        """Demote one policy-chosen victim out of `tier`, with the data copy
        performed OUTSIDE the metadata lock (the same copy-first/delete-last
        protocol as `stage`), so a slow write into a throttled colder tier
        no longer serializes concurrent readers and stagers during
        reservation.  Returns after one demotion landed — or after a short
        wait when victims are mid-move and may free room on their own — and
        the caller re-tests the budget; raises CapacityError when the tier
        holds nothing evictable at all."""
        with self._meta:
            # eviction decisions must see exact recency/frequency
            self._apply_ledger_locked(allow_promote=False)
            victims = [e for e in self._entries.values()
                       if e.tier == tier and not e.pinned
                       and e.key not in exclude
                       and e.key not in self._moving]
            if not victims:
                moving_here = any(e.tier == tier and e.key in self._moving
                                  for e in self._entries.values())
                if not moving_here:
                    raise CapacityError(
                        f"tier {tier!r} over budget and nothing evictable "
                        f"(usage={self._usage[tier]}, "
                        f"budget={self.budgets.get(tier)})")
                victim = None
            else:
                if self.hysteresis:
                    # prefer victims past their promotion hold-down;
                    # capacity is a hard constraint, so fall back to all
                    now = self._now()
                    settled = [e for e in victims
                               if e.no_demote_until <= now]
                    victims = settled or victims
                victim = self.policy.select_victim(tier, victims, self)
                dst = self._colder(tier)
                if dst is None:
                    raise CapacityError(
                        f"cannot evict {victim.key!r}: {tier!r} is the "
                        "coldest tier")
                self.policy.on_evict(tier, victim, self)
                self._moving.add(victim.key)
                key, nbytes = victim.key, victim.nbytes
        if victim is None:
            time.sleep(0.001)   # an in-flight move may free the room
            return
        charged = False
        try:
            # reserve room in the colder tier (may recurse further down);
            # a tier whose WHOLE budget is smaller than the victim is
            # skipped over — the victim falls through toward the durable
            # floor instead of wedging the demotion chain (a host tier
            # sized below the partition must not block the spill to disk)
            while True:
                with self._meta:
                    try:
                        fits = self._fits_locked(dst, nbytes)
                    except CapacityError:
                        nxt = self._colder(dst)
                        if nxt is None:
                            raise
                        dst = nxt
                        continue
                    if fits:
                        self._charge(dst, nbytes)
                        charged = True
                        break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"eviction contention on tier {tier!r}")
                self._evict_one(dst, exclude | {key}, deadline)
            # the copy itself: readers and stagers proceed meanwhile
            val = self.backends[tier].get(key)
            self.backends[dst].put(key, val)
        except (KeyError, FileNotFoundError):
            # victim deleted mid-demotion: its space is already freed
            with self._meta:
                if charged:
                    self._usage[dst] -= nbytes
                self._moving.discard(key)
            return
        except BaseException:
            with self._meta:
                if charged:
                    self._usage[dst] -= nbytes
                self._moving.discard(key)
            raise
        with self._meta:
            e = self._entries.get(key)
            if e is None:       # deleted mid-move: drop the staged copy
                self._usage[dst] -= nbytes
                self.backends[dst].delete(key)
                self._moving.discard(key)
                return
            e.tier = dst
            e.heat = 0          # demoted data must re-earn promotion
            if self.hysteresis:
                e.no_promote_until = self._now() + self.hysteresis
            self._usage[tier] -= nbytes
            self.backends[tier].delete(key)
            self._moving.discard(key)
            self.counters["demotions"] += 1
            self.counters["bytes_demoted"] += nbytes
            self.events.append({"op": "demote", "key": key, "from": tier,
                                "to": dst, "bytes": nbytes})

    # -- placement ------------------------------------------------------
    def put(self, key: str, value, tier: str, pinned: bool = False) -> None:
        """Store `value` in `tier`, evicting (demoting) data to fit.

        On CapacityError nothing has changed: a pre-existing copy of the
        key (any tier) is still resident and correctly accounted.
        """
        if tier not in self.backends:
            raise KeyError(f"no backend for tier {tier!r}")
        if self._lost:
            raise CapacityError(
                "tier manager lost its node (lose_volatile); refusing "
                "new placements")
        arr = value if hasattr(value, "nbytes") else np.asarray(value)
        nbytes = int(arr.nbytes)
        deadline = time.monotonic() + 30.0
        while True:
            evict = False
            with self._meta:
                if key not in self._moving:
                    old = self._entries.get(key)
                    freed = old.nbytes if (old is not None
                                           and old.tier == tier) else 0
                    # reserve before touching the old copy, so a
                    # CapacityError here leaves it intact (the "never lost
                    # to pressure" guarantee)
                    if self._fits_locked(tier, nbytes - freed):
                        self._usage[tier] -= freed
                        self._charge(tier, nbytes)
                        try:
                            self.backends[tier].put(key, arr)
                        except Exception:
                            self._usage[tier] += freed - nbytes
                            raise
                        if old is not None and old.tier != tier:
                            self._usage[old.tier] -= old.nbytes
                            self.backends[old.tier].delete(key)
                        self._entries[key] = _Entry(
                            key, tier, nbytes, pinned=pinned,
                            last_access=self._tick_next())
                        return
                    evict = True
            if time.monotonic() > deadline:
                raise RuntimeError(f"staging contention on {key!r}")
            if evict:
                self._evict_one(tier, frozenset({key}), deadline)
            else:
                time.sleep(0.001)   # key mid-move; wait for the stager

    def delete(self, key: str) -> None:
        with self._meta:
            e = self._entries.pop(key, None)
            if e is None:
                return
            self._usage[e.tier] -= e.nbytes
            self.backends[e.tier].delete(key)
            # purge the untracked durable copies promotions leave behind,
            # so a deleted key can never be resurrected from the store
            for t in DURABLE_TIERS:
                if t != e.tier and t in self.backends:
                    self.backends[t].delete(key)

    def lose_volatile(self) -> List[str]:
        """Simulate node loss: drop every entry resident in a volatile
        tier (everything but the durable checkpoint store) — metadata,
        accounting, and backend bytes.  Checkpoint-resident entries
        survive and stay readable; the keys lost are returned so callers
        (fault harnesses, the PilotDataService) can account for them."""
        lost: List[str] = []
        with self._meta:
            self._lost = True    # in-flight replications must not revive
            #                      the dead node's tiers
            self._apply_ledger_locked(allow_promote=False)
            for key, e in list(self._entries.items()):
                if e.tier in DURABLE_TIERS:
                    continue
                self._usage[e.tier] -= e.nbytes
                self.backends[e.tier].delete(key)
                del self._entries[key]
                lost.append(key)
            self.events.append({"op": "lose-volatile", "keys": len(lost)})
        return lost

    def adopt(self, key: str, tier: str, nbytes: Optional[int] = None,
              pinned: bool = False) -> None:
        """Register data already sitting in a backend (e.g. a pre-existing
        DataUnit) so it participates in budgets/eviction/heat."""
        if self._lost:
            raise CapacityError(
                "tier manager lost its node (lose_volatile); refusing "
                "new placements")
        if nbytes is None:
            nbytes = self.backends[tier].nbytes(key)
        deadline = time.monotonic() + 30.0
        while True:
            with self._meta:
                if key in self._entries:
                    return
                if self._fits_locked(tier, int(nbytes)):
                    self._charge(tier, int(nbytes))
                    self._entries[key] = _Entry(
                        key, tier, int(nbytes), pinned=pinned,
                        last_access=self._tick_next())
                    return
            if time.monotonic() > deadline:
                raise RuntimeError(f"adoption contention on {key!r}")
            self._evict_one(tier, frozenset({key}), deadline)

    # -- access ---------------------------------------------------------
    def get(self, key: str) -> np.ndarray:
        """Read a partition from wherever it currently resides.

        Lock-free on the hot path: residency is a GIL-atomic dict read and
        access accounting goes through the sharded ledger.  Tolerates
        concurrent staging: a move copies to the destination, flips
        residency, then deletes the source, so on a miss we re-read the
        (updated) residency and retry.
        """
        for _ in range(8):
            e = self._entries.get(key)      # snapshot; staleness tolerated
            tier = e.tier if e else None
            if tier is None:
                break
            try:
                val = self.backends[tier].get(key)
            except (KeyError, FileNotFoundError):
                continue    # raced with a move; residency will have flipped
            self._after_read(key)
            return val
        # last resort: scan every backend (covers unmanaged stragglers)
        for tier in reversed(self.order):
            be = self.backends[tier]
            try:
                if be.exists(key):
                    val = be.get(key)
                    self._after_read(key)
                    return val
            except (KeyError, FileNotFoundError):
                continue
        raise KeyError(key)

    def get_buf(self, key: str) -> Buf:
        """Like `get`, but wraps the read-only view in a `Buf` carrying
        provenance (the tier the bytes were served from) and ownership.
        Since the backends hand out views under zero-copy and owned
        copies in copy mode, no extra bytes move here."""
        e = self._entries.get(key)      # snapshot; staleness tolerated
        tier = e.tier if e else None
        val = self.get(key)
        if tier is None:
            tier = self.tier_of(key)
        return Buf(val, source=tier or "?",
                   owned=not zero_copy_enabled())

    def get_device(self, key: str):
        """Device-resident handle if HBM holds the key; else a staged
        read copied onto the device of this manager's device tier."""
        e = self._entries.get(key)          # lock-free residency snapshot
        tier = e.tier if e else None
        be = self.backends.get("device")
        if tier == "device" and be is not None and hasattr(be, "get_device"):
            try:
                arr = be.get_device(key)
                self._after_read(key)
                return arr
            except KeyError:
                pass
            except FileNotFoundError:
                pass
        return to_device(self.get(key), getattr(be, "device", None))

    def _after_read(self, key: str) -> None:
        flush, pending = self._ledger.record(key, self._tick_next())
        if not flush and self.promote_threshold:
            # non-promoting drains (eviction, stats) may have consumed
            # part of this key's window while its accumulated heat kept
            # growing; a lock-free peek over drained heat + pending window
            # keeps the PR 1 guarantee that the threshold-th read triggers
            # the promotion decision
            e = self._entries.get(key)
            flush = (e is not None
                     and e.heat + pending >= self.promote_threshold)
        if flush:
            self._flush_accounting()

    # -- pinning --------------------------------------------------------
    def pin(self, keys: Iterable[str] | str) -> None:
        self._set_pinned(keys, True)

    def unpin(self, keys: Iterable[str] | str) -> None:
        self._set_pinned(keys, False)

    def _set_pinned(self, keys, flag: bool) -> None:
        if isinstance(keys, str):
            keys = (keys,)
        with self._meta:
            for k in keys:
                e = self._entries.get(k)
                if e is not None:
                    e.pinned = flag

    # -- staging --------------------------------------------------------
    def stage(self, key: str, tier: str, keep_source: bool = False) -> str:
        """Synchronously move `key` to `tier` (promotion or demotion).

        With keep_source=True the source copy is left behind (untracked,
        cold-tier cache); residency metadata moves to the destination.
        Promotion out of a DURABLE tier always keeps the source copy —
        staging a partition up from the checkpoint store must not delete
        the only copy that survives node loss (data staged in from Lustre
        is not removed from Lustre); a later demotion simply overwrites
        it.  Returns the tier the key resides in afterwards.

        The copy itself runs *outside* the metadata lock (so staging
        overlaps concurrent reads/compute); the lock is taken only to
        reserve destination capacity and to flip residency. Concurrent
        stages of the same key serialize on the `_moving` marker.
        """
        if tier not in self.backends:
            raise KeyError(f"no backend for tier {tier!r}")
        if self._lost and tier not in DURABLE_TIERS:
            raise CapacityError(
                "tier manager lost its node (lose_volatile); refusing "
                "stages into volatile tiers")
        deadline = time.monotonic() + 30.0
        while True:
            evict = False
            reserved = False
            with self._meta:
                e = self._entries.get(key)
                if e is None:
                    raise KeyError(key)
                if key not in self._moving:
                    src = e.tier
                    if src == tier:
                        self._touch(e)
                        return tier
                    nbytes = e.nbytes
                    if self._fits_locked(tier, nbytes):
                        self._charge(tier, nbytes)
                        self._moving.add(key)
                        reserved = True
                    else:
                        evict = True
            if reserved:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"staging contention on {key!r}")
            if evict:
                self._evict_one(tier, frozenset({key}), deadline)
            else:
                time.sleep(0.001)   # another mover has this key; wait it out
        try:
            val = self.backends[src].get(key)      # outside the lock:
            self.backends[tier].put(key, val)      # reads proceed meanwhile
        except Exception:
            with self._meta:
                self._usage[tier] -= nbytes
                self._moving.discard(key)
            raise
        with self._meta:
            e = self._entries.get(key)
            if e is None:
                # deleted mid-move: drop the staged copy + reservation
                self._usage[tier] -= nbytes
                self.backends[tier].delete(key)
                self._moving.discard(key)
                raise KeyError(key)
            e.tier = tier
            self._touch(e)
            self._usage[src] -= nbytes
            if not keep_source and src not in DURABLE_TIERS:
                self.backends[src].delete(key)
            self._moving.discard(key)
            hot = self.order.index(tier) > self.order.index(src)
            if self.hysteresis:
                if hot:
                    e.no_demote_until = self._now() + self.hysteresis
                else:
                    e.no_promote_until = self._now() + self.hysteresis
            op = "promote" if hot else "demote"
            self.counters["promotions" if hot else "demotions"] += 1
            self.counters["bytes_promoted" if hot
                          else "bytes_demoted"] += nbytes
            self.events.append({"op": op, "key": key, "from": src,
                                "to": tier, "bytes": nbytes})
        return tier

    def stage_async(self, key: str, tier: str,
                    keep_source: bool = False) -> Future:
        """Queue a move on the background stager; returns a future resolving
        to the tier the key ends up in (the current tier if the move was
        refused for capacity, or immediately after close())."""
        with self._meta:
            if self._closed:
                fut: Future = Future()
                fut.set_result(self.tier_of(key) or tier)
                return fut
            fut = self._inflight.get((key, tier))
            if fut is not None and not fut.done():
                return fut
            for k in [k for k, f in self._inflight.items() if f.done()]:
                del self._inflight[k]   # don't retain completed stages
            fut = self._executor.submit(
                self._stage_task, key, tier, keep_source)
            self._inflight[(key, tier)] = fut
            return fut

    def _stage_task(self, key: str, tier: str, keep_source: bool) -> str:
        try:
            return self.stage(key, tier, keep_source=keep_source)
        except CapacityError:
            with self._meta:
                self.counters["stage_refused"] += 1
                self.events.append({"op": "stage-refused", "key": key,
                                    "to": tier})
            return self.tier_of(key) or tier
        except KeyError:
            return tier   # key deleted while queued; nothing to do

    def prefetch(self, key: str, tier: str) -> Optional[Future]:
        """Async promotion toward `tier` if the key is currently colder."""
        with self._meta:
            e = self._entries.get(key)
            if e is None or tier not in self.backends:
                return None
            if self.order.index(e.tier) >= self.order.index(tier):
                return None
        return self.stage_async(key, tier)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Wait for every queued stage to finish (tests/benchmarks)."""
        with self._meta:
            futs = list(self._inflight.values())
        for f in futs:
            if f.cancelled():
                continue
            try:
                f.result(timeout)
            except CancelledError:
                continue
        self._flush_accounting()

    def close(self) -> None:
        """Deterministic shutdown: refuse new stages, cancel queued moves,
        wait for in-flight ones to land, and join the stager threads, so
        no tier-stager thread or half-applied move outlives the manager.
        Backends with a durability barrier (the checkpoint tier's `flush`)
        are flushed LAST — after every stager-driven demotion has landed —
        so all in-flight checkpoint writes are on disk and the manifest is
        fsync'd: a store reopened after close() is exactly consistent with
        this manager's final residency.  Idempotent; reads keep working
        afterwards."""
        with self._meta:
            if self._closed:
                return
            self._closed = True
        # queued-but-unstarted moves are cancelled (their capacity is only
        # reserved once they run, so nothing leaks); running moves complete
        # their copy-first/delete-last protocol before the join returns
        self._executor.shutdown(wait=True, cancel_futures=True)
        with self._meta:
            self._inflight.clear()
            self._apply_ledger_locked(allow_promote=False)
        for be in self.backends.values():
            flush = getattr(be, "flush", None)
            if flush is not None:
                flush()     # write barrier + fsync'd manifest

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{t}={self._usage[t]}/{self.budgets[t] or 'inf'}"
            for t in self.order)
        return f"TierManager({parts}, policy={self.policy.name})"


def make_tier_manager(*, device_budget: Optional[int] = None,
                      host_budget: Optional[int] = None,
                      root: Optional[str] = None, device=None,
                      promote_threshold: int = 4,
                      policy: Union[str, EvictionPolicy] = "lru",
                      hysteresis: int = 0,
                      max_workers: int = 2,
                      checkpoint_root: Optional[str] = None,
                      checkpoint_budget: Optional[int] = None) -> TierManager:
    """Convenience: a host(+file)(+device) hierarchy with common budgets.

    Without `root` the coldest volatile tier is host RAM (no disk side
    effects); with `root` a file tier is added below it.  With
    `checkpoint_root` a durable checkpoint tier is added at the very
    bottom (shared per directory — several managers naming the same root
    get the same store instance), so pressure demotions beyond the
    volatile budgets spill to persistent storage instead of refusing.
    """
    from repro_torch.core.memory import make_backend
    backends: Dict[str, StorageBackend] = {}
    if checkpoint_root is not None:
        backends["checkpoint"] = make_backend("checkpoint",
                                              root=checkpoint_root)
    if root is not None:
        backends["file"] = make_backend("file", root=root)
    backends["host"] = make_backend("host")
    backends["device"] = make_backend("device", device=device)
    budgets: Dict[str, Optional[int]] = {}
    if device_budget is not None:
        budgets["device"] = int(device_budget)
    if host_budget is not None:
        budgets["host"] = int(host_budget)
    if checkpoint_budget is not None:
        budgets["checkpoint"] = int(checkpoint_budget)
    return TierManager(backends, budgets, promote_threshold=promote_threshold,
                       policy=policy, hysteresis=hysteresis,
                       max_workers=max_workers)


def tier_manager_for_pilot(desc, device=None) -> Optional[TierManager]:
    """Per-pilot managed memory from a PilotComputeDescription resource ask
    (shared by the backend adaptors; None when no memory_gb was asked).

    The YARN-style `memory_gb` becomes the pilot's device-tier budget and
    `host_memory_gb` (optional) its host-tier budget: DUs placed — or
    replicated by the PilotDataService — into this manager are retained in
    the pilot's HBM share up to the ask and demoted through its own host
    tier beyond it, making each pilot a separate locality domain.

    `checkpoint_dir` adds the durable checkpoint tier beneath the volatile
    budgets (`checkpoint_gb` optionally bounds it; 0 = unbounded): the
    pilot spills its coldest partitions there under pressure instead of
    refusing, restores lazily on read, and — because the store is shared
    per directory — pilots naming the same dir form one persistent home
    the PilotDataService can recover replicas from after a pilot dies.

    Accepts the v2 composed description (reads its `memory`/`durability`
    blocks) or any object carrying the flat legacy fields."""
    mem = getattr(desc, "memory", None)
    if mem is None:
        mem = desc                      # flat legacy / duck-typed object
    dur = getattr(desc, "durability", None)
    if dur is None:
        dur = desc
    if not getattr(mem, "memory_gb", 0):
        return None
    ckpt_dir = getattr(dur, "checkpoint_dir", "") or None
    ckpt_gb = getattr(dur, "checkpoint_gb", 0.0)
    return make_tier_manager(
        device_budget=int(mem.memory_gb * 2 ** 30),
        host_budget=(int(mem.host_memory_gb * 2 ** 30)
                     if mem.host_memory_gb else None),
        device=device, policy=mem.eviction_policy,
        hysteresis=mem.hysteresis, max_workers=mem.stager_workers,
        checkpoint_root=ckpt_dir,
        checkpoint_budget=(int(ckpt_gb * 2 ** 30) if ckpt_gb else None))
