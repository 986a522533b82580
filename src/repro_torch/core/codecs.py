"""Pluggable codec registry for the file-backed tiers.

Before PR 8 every file-backed tier baked in one implicit convention —
``np.save`` on write, a full ``np.load`` (header parse + memcpy of the
whole payload) on read — so fetch bandwidth was set by memcpy no matter
how fast the tier was.  This module makes the encode path a *registry*
(the RADICAL-Pilot ``serializer.py`` idiom: codecs register themselves,
the first one whose predicate accepts the value wins, and callers never
fork the transport to add a format):

  * ``RawCodec`` — the fast path for plain numeric ndarrays: the ``.npy``
    container (a self-describing header followed by the raw buffer), read
    back with ``mmap_mode="r"`` so decode is a page-table update, not a
    memcpy — the zero-copy read the ``Buf`` plane moves around.  Sizing
    (``file_nbytes``) is a header-only read;
  * ``PickleCodec`` — the compatibility tail for object-dtype arrays,
    which cannot be mmap'd; encodes via ``np.save(allow_pickle=True)``
    and decodes with a full (copying) load;
  * ``register_codec`` — prepend a custom codec (e.g. a compressing one)
    without touching any backend: both ``FileBackend`` and
    ``CheckpointBackend`` encode through ``encoder_for`` and decode
    through ``decode_file``, which sniffs the container and falls back
    down the chain.

Every encode/decode records a per-codec counter in
``repro_torch.core.buf.STATS`` (surfaced as ``session.stats()["transport"]
["codec"]``), so benchmarks can attribute bytes to the path that moved
them.
"""
from __future__ import annotations

from pathlib import Path
from typing import BinaryIO, List, Union

import numpy as np

from repro_torch.core.buf import STATS, as_view, zero_copy_enabled


class Codec:
    """One encode/decode format for partition files.

    ``accepts`` gates encoding (first matching codec in the registry
    wins); ``write`` lands the value into an open binary file object (the
    backends own atomicity: tmp + ``os.replace``); ``read`` returns the
    decoded array — a read-only view when ``prefer_view`` and the format
    allows it, else an owned copy; ``nbytes`` sizes a file without
    touching its payload.
    """

    name = "codec"

    def accepts(self, arr: np.ndarray) -> bool:
        raise NotImplementedError

    def write(self, f: BinaryIO, arr: np.ndarray) -> None:
        raise NotImplementedError

    def read(self, path: Path, prefer_view: bool = True) -> np.ndarray:
        raise NotImplementedError

    def nbytes(self, path: Path) -> int:
        raise NotImplementedError


class RawCodec(Codec):
    """Raw-header fast path: .npy container, mmap'd zero-copy decode."""

    name = "raw"

    def accepts(self, arr: np.ndarray) -> bool:
        return arr.dtype != object

    def write(self, f: BinaryIO, arr: np.ndarray) -> None:
        # np.save writes the raw buffer after a self-describing header;
        # a non-contiguous array is made contiguous by numpy internally
        # (that copy is the format's, not the transport's)
        np.save(f, arr)
        STATS.record_codec(self.name, "encode")

    def read(self, path: Path, prefer_view: bool = True) -> np.ndarray:
        if prefer_view and zero_copy_enabled():
            arr = np.load(path, mmap_mode="r")      # page map, no memcpy
            STATS.record_view(arr.nbytes)
        else:
            arr = np.load(path, mmap_mode=None)
            STATS.record_copy(arr.nbytes)
            arr = as_view(arr, count=False)     # the contract: reads are RO
        STATS.record_codec(self.name, "decode")
        return arr

    def nbytes(self, path: Path) -> int:
        # header-only: open the mmap (no payload pages touched) and size it
        return int(np.load(path, mmap_mode="r").nbytes)


class PickleCodec(Codec):
    """Object-dtype tail: pickled .npy, always a materializing decode."""

    name = "pickle"

    def accepts(self, arr: np.ndarray) -> bool:
        return True

    def write(self, f: BinaryIO, arr: np.ndarray) -> None:
        np.save(f, arr, allow_pickle=True)
        STATS.record_codec(self.name, "encode")

    def read(self, path: Path, prefer_view: bool = True) -> np.ndarray:
        arr = np.load(path, mmap_mode=None, allow_pickle=True)
        STATS.record_copy(arr.nbytes)
        STATS.record_codec(self.name, "decode")
        return as_view(arr, count=False)

    def nbytes(self, path: Path) -> int:
        return int(np.load(path, mmap_mode=None, allow_pickle=True).nbytes)


_REGISTRY: List[Codec] = [RawCodec(), PickleCodec()]


def register_codec(codec: Codec, front: bool = True) -> Codec:
    """Plug a codec into the chain (front=True: it is consulted first)."""
    if front:
        _REGISTRY.insert(0, codec)
    else:
        _REGISTRY.append(codec)
    return codec


def unregister_codec(codec: Codec) -> None:
    if codec in _REGISTRY:
        _REGISTRY.remove(codec)


def codecs() -> List[Codec]:
    return list(_REGISTRY)


def encoder_for(arr: np.ndarray) -> Codec:
    """The first registered codec accepting `arr` (PickleCodec accepts
    everything, so the chain never misses)."""
    for c in _REGISTRY:
        if c.accepts(arr):
            return c
    return _REGISTRY[-1]


def decode_file(path: Union[str, Path],
                prefer_view: bool = True) -> np.ndarray:
    """Decode a partition file down the registry chain: the raw mmap fast
    path first, falling back (e.g. pickled object arrays refuse to mmap)
    until a codec succeeds."""
    path = Path(path)
    last: Exception = KeyError(str(path))
    for c in _REGISTRY:
        try:
            return c.read(path, prefer_view=prefer_view)
        except FileNotFoundError:
            raise
        except (ValueError, OSError) as e:   # wrong format for this codec
            last = e
    raise last


def file_nbytes(path: Union[str, Path]) -> int:
    """Size a partition file without reading its payload (header-only on
    the raw fast path)."""
    path = Path(path)
    last: Exception = KeyError(str(path))
    for c in _REGISTRY:
        try:
            return c.nbytes(path)
        except FileNotFoundError:
            raise
        except (ValueError, OSError) as e:
            last = e
    raise last
