"""Zero-copy buffer views for the Pilot-Data transport plane.

The paper's in-memory Pilot-Data argument (§4) only holds if the access
path is fast: retaining a partition in a hot tier buys nothing when every
hop through the replica/fetch plane re-materializes the bytes with a
memcpy.  This module is the data plane's view abstraction:

  * ``Buf`` — a read-only view over bytes some tier already owns
    (``memoryview``-style semantics for ndarrays: ``np.memmap`` over
    ``FileBackend``/``CheckpointBackend`` files, a plain aliasing view
    over ``HostMemoryBackend`` arrays, a dlpack view over device-tier
    ``torch.Tensor``s on the CPU), carrying provenance (``source`` tier) and ownership.
    ``get``/``fetch``/``replicate``/demote/promote move Bufs; bytes are
    copied only on mutation (``Buf.copy()``) or on a tier crossing that
    genuinely requires materialization;
  * the **mutation contract**: every view the plane hands out is
    read-only (``writeable=False``).  Writing into a fetched partition
    raises instead of silently corrupting a store; callers that need a
    scratch buffer take ``Buf.copy()`` (or ``DataUnit.partition_copy``).
    Internal moves are copy-first/delete-last, and a dropped source only
    loses the *store's* reference — a reader's live view pins the backing
    bytes (numpy base / mmap'd inode / dlpack capsule), so demotion,
    eviction, and repair can never mutate bytes under a reader;
  * ``TransportStats`` — the plane's global ``bytes_viewed`` /
    ``bytes_copied`` counters (plus per-codec encode/decode counts fed by
    repro_torch.core.codecs), surfaced through ``session.stats()["transport"]``
    so the view-vs-copy ratio is a first-class benchmark quantity;
  * a process-wide ``zero_copy`` switch with a ``copy_mode()`` context
    manager: benchmarks measure the copy baseline by flipping the same
    plane into materialize-always mode instead of forking the transport.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np


class TransportStats:
    """Global data-plane movement counters.

    Telemetry, not accounting: increments are plain (GIL-atomic in the
    repo's established sense — a racing pair may drop one count, never
    corrupt state), so the hot read path pays zero lock acquisitions for
    its counters — the same trade the TierManager's sharded access
    ledger and the WorkerPool's ``executed`` counter already make.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes_viewed = 0
        self.bytes_copied = 0
        self.views = 0
        self.copies = 0
        self.codec: Dict[str, int] = {}

    def record_view(self, nbytes: int) -> None:
        self.bytes_viewed += int(nbytes)
        self.views += 1

    def record_copy(self, nbytes: int) -> None:
        self.bytes_copied += int(nbytes)
        self.copies += 1

    def record_codec(self, name: str, op: str) -> None:
        k = f"{name}.{op}"
        self.codec[k] = self.codec.get(k, 0) + 1

    def snapshot(self) -> dict:
        return {"bytes_viewed": self.bytes_viewed,
                "bytes_copied": self.bytes_copied,
                "views": self.views, "copies": self.copies,
                "codec": dict(self.codec)}


STATS = TransportStats()

# process-wide switch: True (default) = the plane hands out views where
# the backing store allows it; False = every read materializes a fresh
# copy (the pre-PR-8 behavior, kept as the measurable baseline)
_zero_copy = True


def zero_copy_enabled() -> bool:
    return _zero_copy


def set_zero_copy(enabled: bool) -> None:
    global _zero_copy
    _zero_copy = bool(enabled)


@contextlib.contextmanager
def copy_mode():
    """Temporarily force materialize-always reads (benchmark baseline)."""
    global _zero_copy
    prev = _zero_copy
    _zero_copy = False
    try:
        yield
    finally:
        _zero_copy = prev


def as_view(arr: np.ndarray, count: bool = True) -> np.ndarray:
    """A read-only aliasing view of `arr` (no bytes move).  The caller's
    array is untouched — only the returned view is write-protected."""
    v = arr.view()
    v.setflags(write=False)
    if count:
        STATS.record_view(v.nbytes)
    return v


def materialize(arr, count: bool = True) -> np.ndarray:
    """An owned, writable host copy of `arr` (the explicit copy hop)."""
    out = np.array(arr)     # always copies, drops the mmap/dlpack base
    if count:
        STATS.record_copy(out.nbytes)
    return out


def device_view(arr) -> Optional[np.ndarray]:
    """Zero-copy host view of a device-tier array via dlpack, or None
    when the buffer is not host-addressable (real HBM: the tier crossing
    then genuinely requires a copy and the caller falls back)."""
    dev = getattr(arr, "device", None)
    if getattr(dev, "type", "cpu") != "cpu":
        # a CUDA tensor: decided here, not by whichever exception numpy
        # happens to raise for a non-host dlpack capsule
        return None
    try:
        v = np.from_dlpack(arr)
    except (TypeError, RuntimeError, BufferError, ValueError):
        return None
    if v.flags.writeable:       # defensive: exporters should mark RO
        v = v.view()
        v.setflags(write=False)
    STATS.record_view(v.nbytes)
    return v


class Buf:
    """A read-only view over partition bytes plus provenance.

    ``array`` is the zero-copy (or, in copy mode, materialized) ndarray;
    ``source`` names the tier/backend the bytes came from; ``owned`` says
    whether the bytes were materialized for this Buf (True) or alias a
    store's buffer (False).  ``np.asarray(buf)`` works directly via
    ``__array__``.
    """

    __slots__ = ("array", "source", "owned")

    def __init__(self, array: np.ndarray, source: str = "",
                 owned: bool = False):
        self.array = array
        self.source = source
        self.owned = owned

    # -- ndarray-shaped surface ------------------------------------------
    @property
    def nbytes(self) -> int:
        return int(self.array.nbytes)

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def shape(self):
        return self.array.shape

    def __array__(self, dtype=None, copy=None):
        a = self.array
        if dtype is not None and a.dtype != dtype:
            return a.astype(dtype)
        if copy:
            return np.array(a)
        return a

    def __len__(self) -> int:
        return len(self.array)

    # -- the mutation contract -------------------------------------------
    def view(self) -> np.ndarray:
        """The read-only ndarray (no bytes move)."""
        return self.array

    def copy(self) -> np.ndarray:
        """An owned, writable copy — the only sanctioned way to mutate a
        fetched partition (records bytes_copied)."""
        return materialize(self.array)

    def __repr__(self) -> str:
        kind = "owned" if self.owned else "view"
        return (f"Buf({self.array.shape}, {self.array.dtype}, "
                f"{kind} from {self.source or '?'})")
