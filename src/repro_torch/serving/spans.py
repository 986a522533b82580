"""In-memory spans of the serving engine, on a clock that maps onto the
PyTorch profiler's.

Spans are off unless a caller starts a recording::

    rec = spans.start()
    ...                                  # deploy, serve
    spans.stop()                         # rec.records, rec.dropped

While off, ``span(name, key)`` returns one shared no-op context manager
after a single check of a module global: no allocation and no clock read.
While on, each span closed becomes a `Span` record: its id, its parent
(the innermost span open on the same thread when it opened; None at the
thread's top), its name, its key (a request's ``rid`` where there is one,
so that the spans of one request share it), its thread and its two times
from ``time.perf_counter_ns``, the clock of ``ServeRequest.t_submit`` and
``t_done``.  `start` reads one pair of clocks, ``Recording.anchor =
(perf_counter_ns, time_ns)``, through which a span's time maps onto the
Unix-epoch nanoseconds that the profiler stamps its events with
(``t - anchor[0] + anchor[1]``).  A recording keeps at most `CAP` records
and counts the rest in ``dropped``, so one left on cannot grow without
limit.  Nothing is written anywhere: the records are the caller's to
read.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

CAP = 1 << 18


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    key: Optional[int]
    tid: int
    t0_ns: int
    t1_ns: int


class Recording:
    """The spans of one recording, its clock anchor and its drop count."""

    def __init__(self):
        self.records: List[Span] = []
        self.dropped = 0
        self.anchor: Tuple[int, int] = (time.perf_counter_ns(),
                                        time.time_ns())
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: Span) -> None:
        with self._lock:
            if len(self.records) < CAP:
                self.records.append(rec)
            else:
                self.dropped += 1


class _Open:
    """One span of a recording, open between enter and exit."""

    __slots__ = ("rec", "name", "key", "id", "parent", "t0")

    def __init__(self, rec: Recording, name: str, key: Optional[int]):
        self.rec, self.name, self.key = rec, name, key

    def __enter__(self) -> "_Open":
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.rec._stack().pop()
        self.rec._keep(Span(self.id, self.parent, self.name, self.key,
                            threading.get_ident(), self.t0, t1))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_current: Optional[Recording] = None


def start() -> Recording:
    """Start recording spans; returns the recording."""
    global _current
    if _current is not None:
        raise RuntimeError("a span recording is already on")
    _current = Recording()
    return _current


def stop() -> Optional[Recording]:
    """Stop recording; returns the recording that was on, or None.  A span
    open at this moment still lands in its own recording when it closes."""
    global _current
    rec, _current = _current, None
    return rec


def span(name: str, key: Optional[int] = None):
    """A context manager that records one span while a recording is on."""
    rec = _current
    if rec is None:
        return _OFF
    return _Open(rec, name, key)
