"""Pilot-Data storage tiers: one DataUnit API over heterogeneous backends.

Paper mapping (§3.1/§3.3): the paper's pluggable Pilot-Data backends
(local disk / Lustre / HDFS / Redis / Spark-RDD) become storage *tiers* of a
accelerator system:

  checkpoint — durable manifest-backed store (paper: Lustre/HDFS, the
               persistent anchor beneath the retained in-memory resources)
  file    — mmap'd .npy on disk            (paper: file backend, node-local)
  object  — file + simulated WAN latency   (paper: cloud object store, S3)
  host    — process-resident numpy         (paper: Redis in-memory store)
  device  — torch.Tensors resident in HBM  (paper: Spark executor memory)

The checkpoint tier is the only DURABLE one: its contents survive pilot
loss (`TierManager.lose_volatile`) and process restarts (an fsync'd JSON
manifest makes a reopened store self-describing).  Writes are asynchronous
(the repro.checkpoint.CheckpointManager write-behind pattern): `put`
buffers and returns, a writer thread lands bytes atomically
(tmp + rename), and reads of a still-pending key are served from the
buffer, so demotion into the slow tier never stalls the stager.  `flush`
drains the writer and fsyncs the manifest deterministically.

Backends expose a bandwidth/latency profile so benchmarks can reproduce the
paper's Stampede-disk vs Gordon-flash comparison (Fig. 7/8) on one box: the
simulated profiles throttle honestly (sleep for bytes/bw) and are clearly
labeled as simulations in benchmark output.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core import codecs as _codecs
from repro_torch.core.buf import (STATS, as_view, device_view, materialize,
                                  zero_copy_enabled)
from repro_torch.core.device import resolve_device, to_device

TIERS = ("checkpoint", "file", "object", "host", "device")

# tiers whose contents survive pilot loss (TierManager.lose_volatile) —
# everything else dies with the node that held it
DURABLE_TIERS = ("checkpoint",)


@dataclasses.dataclass(frozen=True)
class TierProfile:
    """Bandwidth/latency model for a simulated storage tier."""
    name: str
    read_bw: float = 0.0       # bytes/s; 0 = unthrottled (native speed)
    write_bw: float = 0.0
    latency: float = 0.0       # seconds per operation
    simulate: bool = False

    def charge(self, nbytes: int, write: bool) -> None:
        if not self.simulate:
            return
        bw = self.write_bw if write else self.read_bw
        t = self.latency + (nbytes / bw if bw else 0.0)
        if t > 0:
            time.sleep(min(t, 5.0))  # cap: benchmarks stay bounded


# Published-order-of-magnitude profiles for the Fig. 7/8 reproductions.
PROFILES: Dict[str, TierProfile] = {
    "stampede_disk": TierProfile("stampede_disk", 120e6, 90e6, 5e-3, True),
    "gordon_flash": TierProfile("gordon_flash", 800e6, 500e6, 1e-4, True),
    "lustre": TierProfile("lustre", 300e6, 200e6, 2e-3, True),
    "hdfs": TierProfile("hdfs", 250e6, 80e6, 8e-3, True),
    "object_store": TierProfile("object_store", 80e6, 40e6, 50e-3, True),
    "native": TierProfile("native"),
}

# Nominal read/write bandwidth (bytes/s) per tier when its profile runs
# unthrottled; cost-aware eviction (GDSF) uses these so restage costs stay
# ordered (file < object << host << device) even without simulated profiles.
DEFAULT_TIER_BANDWIDTH: Dict[str, float] = {
    "checkpoint": 120e6, "file": 200e6, "object": 80e6, "host": 10e9,
    "device": 60e9,
}


class StorageBackend:
    """One tier's put/get/delete over named partitions."""

    tier: str = "file"

    def __init__(self, profile: TierProfile = PROFILES["native"]):
        self.profile = profile

    def put(self, name: str, value: np.ndarray) -> None:
        raise NotImplementedError

    def get(self, name: str) -> np.ndarray:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def nbytes(self, name: str) -> int:
        return int(self.get(name).nbytes)


class FileBackend(StorageBackend):
    tier = "file"

    def __init__(self, root: str | Path,
                 profile: TierProfile = PROFILES["native"]):
        super().__init__(profile)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.root / f"{name}.npy"

    def put(self, name: str, value: np.ndarray) -> None:
        value = np.asarray(value)
        self.profile.charge(value.nbytes, write=True)
        path = self._path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        # write-to-temp + atomic rename: a concurrent reader of an
        # overwritten key sees the old bytes or the new bytes, never a
        # truncated file (the either-tier-consistency the staging
        # protocol promises ends at this backend's put).  The bytes are
        # laid down by the codec registry (raw-header fast path for
        # numeric arrays, pickle tail for object dtypes) so the format is
        # pluggable without forking this transport.
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            codec = _codecs.encoder_for(value)
            with open(tmp, "wb") as f:
                codec.write(f, value)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)

    def get(self, name: str) -> np.ndarray:
        """Read-only partition bytes.  Zero-copy by default: the raw
        codec maps the file (``mmap_mode="r"``) instead of memcpy'ing the
        payload, so fetch cost is a page-table update and the simulated
        profile charge — a reader's live view pins the inode even across
        a concurrent overwrite (``os.replace``) or delete."""
        arr = _codecs.decode_file(self._path(name))
        self.profile.charge(arr.nbytes, write=False)
        return arr

    def nbytes(self, name: str) -> int:
        # header-only read (codec registry): sizing a partition (e.g. for
        # interconnect cost modelling) must not charge the simulated
        # bandwidth profile nor touch the payload pages
        return _codecs.file_nbytes(self._path(name))

    def delete(self, name: str) -> None:
        self._path(name).unlink(missing_ok=True)

    def exists(self, name: str) -> bool:
        return self._path(name).exists()


class ObjectStoreBackend(FileBackend):
    """File storage behind an object-store-like latency profile."""
    tier = "object"

    def __init__(self, root: str | Path,
                 profile: TierProfile = PROFILES["object_store"]):
        super().__init__(root, profile)


class CheckpointBackend(StorageBackend):
    """Durable coldest tier: atomic .npy files + an fsync'd JSON manifest.

    Write-behind: `put` buffers the value and enqueues it for a single
    writer thread (the CheckpointManager async-save pattern), which lands
    each partition atomically (write to a .tmp sibling, `os.replace`) and
    batches manifest rewrites.  Reads of a still-pending key are served
    from the buffer, so the copy-first/delete-last move protocol stays
    hole-free while bytes drain to disk.  `flush()` waits for every queued
    write to land and fsyncs the manifest; `close()` flushes and joins the
    writer.  A fresh CheckpointBackend over an existing root loads the
    manifest, so a reopened store is self-describing (keys, sizes) without
    touching the data files.

    One instance may safely back several TierManagers (the multi-pilot
    shared home): all metadata is lock-guarded and file writes are atomic,
    so two pilots demoting the same replica key write identical bytes.
    """
    tier = "checkpoint"

    _MANIFEST = "MANIFEST.json"

    def __init__(self, root: str | Path,
                 profile: TierProfile = PROFILES["native"],
                 max_pending_bytes: int = 128 * 2 ** 20):
        super().__init__(profile)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_pending_bytes = int(max_pending_bytes)
        self._lock = threading.RLock()
        self._space = threading.Condition(self._lock)
        self._manifest: Dict[str, dict] = {}     # key -> {file, nbytes, ...}
        self._pending: Dict[str, np.ndarray] = {}  # buffered, not yet on disk
        self._pending_bytes = 0
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        self._manifest_dirty = False
        self.counters: Dict[str, int] = {
            "writes": 0, "reads": 0, "manifest_flushes": 0}
        mpath = self.root / self._MANIFEST
        if mpath.exists():
            try:
                self._manifest = json.loads(mpath.read_text()).get("keys", {})
            except (OSError, ValueError):
                self._manifest = {}

    # -- paths / manifest ----------------------------------------------
    def _path(self, name: str) -> Path:
        return self.root / f"{name}.npy"

    def _write_manifest_locked(self, fsync: bool = False) -> None:
        doc = {"schema": "repro-checkpoint-tier.v1", "keys": self._manifest}
        tmp = self.root / (self._MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(doc, sort_keys=True))
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self.root / self._MANIFEST)
        if fsync:
            dirfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        self._manifest_dirty = False
        self.counters["manifest_flushes"] += 1

    # -- async writer ---------------------------------------------------
    def _ensure_writer_locked(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="checkpoint-writer")
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            key = self._queue.get()
            if key is None:
                self._queue.task_done()
                return
            try:
                self._land(key)
            finally:
                self._queue.task_done()

    def _land(self, key: str) -> None:
        """Write one pending key to disk atomically; skip if it was deleted
        (or re-put) while queued."""
        with self._lock:
            arr = self._pending.get(key)
        if arr is None:
            return
        self.profile.charge(int(arr.nbytes), write=True)
        path = self._path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.parent / (path.name + ".tmp")
        codec = _codecs.encoder_for(arr)
        with open(tmp, "wb") as f:     # file object: the codec must not
            codec.write(f, arr)        # append .npy to the tmp name
        with self._lock:
            if self._pending.get(key) is not arr:
                tmp.unlink(missing_ok=True)   # deleted/replaced mid-write
                return
            os.replace(tmp, path)
            del self._pending[key]
            self._pending_bytes -= int(arr.nbytes)
            self._space.notify_all()
            self._manifest[key] = {
                "file": path.name, "nbytes": int(arr.nbytes),
                "shape": list(arr.shape), "dtype": str(arr.dtype)}
            self._manifest_dirty = True
            self.counters["writes"] += 1
            # batch manifest rewrites: only when the queue has drained
            if self._queue.unfinished_tasks <= 1:
                self._write_manifest_locked()

    # -- StorageBackend surface ----------------------------------------
    def put(self, name: str, value: np.ndarray) -> None:
        arr = np.asarray(value)
        with self._space:
            if self._closed:
                # post-close stores write synchronously (durability over
                # latency once the writer is gone)
                self._pending[name] = arr
                self._land(name)
                self._write_manifest_locked(fsync=True)
                return
            # backpressure: the write-behind buffer is byte-bounded, so a
            # spill under memory pressure actually frees RAM instead of
            # parking the whole overflow in _pending while the (possibly
            # throttled) writer drains; an oversized single value is
            # admitted once the buffer is empty
            while (self._pending_bytes
                   and self._pending_bytes + int(arr.nbytes)
                   > self.max_pending_bytes):
                self._space.wait(1.0)
            old = self._pending.get(name)
            if old is not None:
                self._pending_bytes -= int(old.nbytes)
            self._pending[name] = arr
            self._pending_bytes += int(arr.nbytes)
            self._ensure_writer_locked()
            self._queue.put(name)

    def get(self, name: str) -> np.ndarray:
        with self._lock:
            arr = self._pending.get(name)
            if arr is None and name not in self._manifest:
                raise KeyError(name)
        if arr is not None:
            # buffered write: a read-only aliasing view of the pending
            # buffer — a reader must never scribble into bytes the writer
            # thread is about to land
            return as_view(arr)
        # landed bytes: zero-copy restore (mmap'd raw fast path) — the
        # checkpoint-restore hop no longer memcpy's the whole partition
        arr = _codecs.decode_file(self._path(name))
        self.profile.charge(int(arr.nbytes), write=False)
        with self._lock:
            self.counters["reads"] += 1
        return arr

    def delete(self, name: str) -> None:
        with self._lock:
            dropped = self._pending.pop(name, None)
            if dropped is not None:
                self._pending_bytes -= int(dropped.nbytes)
                self._space.notify_all()
            had = self._manifest.pop(name, None)
            self._path(name).unlink(missing_ok=True)
            if had is not None:
                self._manifest_dirty = True

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._pending or name in self._manifest

    def nbytes(self, name: str) -> int:
        with self._lock:
            arr = self._pending.get(name)
            if arr is not None:
                return int(arr.nbytes)
            info = self._manifest.get(name)
            if info is not None:
                return int(info["nbytes"])
        raise KeyError(name)

    def keys(self) -> List[str]:
        """Every key the store holds (pending or landed) — the reopen
        surface: a fresh manager can adopt these."""
        with self._lock:
            return sorted(set(self._pending) | set(self._manifest))

    # -- durability -----------------------------------------------------
    def flush(self, timeout: Optional[float] = None) -> None:
        """Deterministic write barrier: every buffered put is on disk and
        the manifest is fsync'd when this returns.  On a store shared
        across managers this waits for EVERY holder's queued writes (it
        is one directory and one manifest); `timeout` bounds the wait and
        raises TimeoutError with writes still in flight."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._queue.all_tasks_done:
            while self._queue.unfinished_tasks:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "checkpoint flush timed out with writes in flight")
                self._queue.all_tasks_done.wait(remaining)
        with self._lock:
            self._write_manifest_locked(fsync=True)

    def close(self) -> None:
        """Flush, then stop and join the writer thread (idempotent; reads
        and synchronous writes keep working afterwards)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            writer = self._writer
        self._queue.join()
        if writer is not None and writer.is_alive():
            self._queue.put(None)
            writer.join(timeout=30)
        with self._lock:
            self._write_manifest_locked(fsync=True)


# shared checkpoint stores: pilots naming the same checkpoint_dir must hit
# the SAME instance (one manifest writer per directory), which is also what
# makes the store a shared home the PilotDataService can recover from
_CHECKPOINT_STORES: Dict[str, CheckpointBackend] = {}
_CHECKPOINT_STORES_LOCK = threading.Lock()


def checkpoint_store(root: str | Path,
                     profile: TierProfile = PROFILES["native"]
                     ) -> CheckpointBackend:
    """The CheckpointBackend for `root`, shared per resolved directory.
    A closed cached instance is replaced by a fresh one that reloads the
    manifest (the reopen path)."""
    key = str(Path(root).resolve())
    with _CHECKPOINT_STORES_LOCK:
        be = _CHECKPOINT_STORES.get(key)
        if be is None or be._closed:
            be = CheckpointBackend(root, profile)
            _CHECKPOINT_STORES[key] = be
        return be


class HostMemoryBackend(StorageBackend):
    """Process-resident numpy store (the paper's Redis analogue)."""
    tier = "host"

    def __init__(self, profile: TierProfile = PROFILES["native"]):
        super().__init__(profile)
        self._store: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def put(self, name: str, value: np.ndarray) -> None:
        value = np.asarray(value)
        self.profile.charge(value.nbytes, write=True)
        with self._lock:
            self._store[name] = value

    def get(self, name: str) -> np.ndarray:
        with self._lock:
            arr = self._store[name]
        self.profile.charge(arr.nbytes, write=False)
        # read-only aliasing view (copy mode: an owned copy — the
        # pre-PR-8 baseline the transport bench measures against).  A
        # demotion/overwrite/delete only drops the STORE's reference;
        # a reader's live view keeps the old bytes alive and unchanged.
        if zero_copy_enabled():
            return as_view(arr)
        return as_view(materialize(arr), count=False)

    def delete(self, name: str) -> None:
        with self._lock:
            self._store.pop(name, None)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._store


# the 64-bit types ``jax.device_put`` narrows with x64 off, and what to
_NARROW_64 = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32, torch.complex128: torch.complex64}


class DeviceBackend(StorageBackend):
    """Device-resident torch.Tensors on one pilot's device.

    This is the Pilot-Data *Memory* tier: data put here is retained on the
    accelerator across Compute-Units (the paper's Spark-backend role) so
    iterative analytics never re-stage inputs (the 212x KMeans effect).

    torch has no read-only tensors, so the mutation contract (buf.py) is
    kept by copying at the edges: ``put`` copies the caller's array onto
    the device (``to_device``; ``torch.from_numpy`` would alias it), and
    ``get`` hands out a read-only host view on the CPU and an owned D2H
    copy for CUDA.  ``get_device`` returns the stored tensor itself, for
    kernels that read it in place; callers must not write into it.

    A 64-bit array is stored at 32 bits (float64 -> float32, int64 ->
    int32, uint64 -> uint32, complex128 -> complex64) and charged at its
    narrowed size, as the JAX package's ``jax.device_put`` stores it with
    x64 off.
    """
    tier = "device"

    def __init__(self, device=None,
                 profile: TierProfile = PROFILES["native"]):
        super().__init__(profile)
        self.device = resolve_device(device)
        self._store: Dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()

    def put(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            arr = value.detach().to(self.device, copy=True)
        else:
            arr = to_device(value, self.device)
        narrow = _NARROW_64.get(arr.dtype)
        if narrow is not None:
            arr = arr.to(narrow)
        self.profile.charge(int(arr.nbytes), write=True)
        with self._lock:
            self._store[name] = arr

    def get_device(self, name: str) -> torch.Tensor:
        with self._lock:
            return self._store[name]

    def get(self, name: str) -> np.ndarray:
        arr = self.get_device(name)
        self.profile.charge(int(arr.nbytes), write=False)
        if zero_copy_enabled():
            # dlpack: a read-only host view straight over the tensor when
            # it lives on the CPU; None means real HBM — that tier
            # crossing is a genuine copy and falls through
            v = device_view(arr)
            if v is not None:
                return v
        host = arr.cpu().numpy()
        if arr.device.type == "cpu":
            return as_view(materialize(host), count=False)
        # .cpu() already made the owned host copy for a CUDA tensor
        STATS.record_copy(host.nbytes)
        return as_view(host, count=False)

    def nbytes(self, name: str) -> int:
        # sized from the tensor: no D2H copy just to read a length
        return int(self.get_device(name).nbytes)

    def delete(self, name: str) -> None:
        with self._lock:
            self._store.pop(name, None)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._store


def make_backend(tier: str, *, root: Optional[str] = None,
                 profile: TierProfile = PROFILES["native"],
                 device=None) -> StorageBackend:
    if tier == "checkpoint":
        return checkpoint_store(root or ".pilot_checkpoint", profile)
    if tier == "file":
        return FileBackend(root or ".pilot_data", profile)
    if tier == "object":
        return ObjectStoreBackend(root or ".pilot_object", profile)
    if tier == "host":
        return HostMemoryBackend(profile)
    if tier == "device":
        return DeviceBackend(device=device, profile=profile)
    raise ValueError(f"unknown tier {tier!r}")
