"""The program's serving spans (``repro_torch.serving.spans``) read with
the traced slice (``harness/trace.py``) and the requests' stamps.

`spans` below is a span recording: ``records`` (each with ``id``,
``parent``, ``name``, ``key``, ``tid``, ``t0_ns``, ``t1_ns`` on
``time.perf_counter_ns``) and ``anchor``, its pair of clock reads
``(perf_counter_ns, time_ns)``, through which a span's time maps onto the
Unix-epoch clock the profiler stamps its events with.  `stamps` are the
window's completed requests' ``(t_submit, t_admit, t_first, t_done)``,
``time.perf_counter`` seconds.

The profiler's device times lie on the host's Unix clock to about 0.1 ms
in most sessions, but in some they drift from it at a steady rate (on an
H100, 1.2 to 2.6 ms a second, PERF.md §6), so each session is calibrated
with a line: the wrapper stamps each decode call on the host right after
its ``.cpu()``, so the call's range opens on a drained card at once, and
the line through the first and the last decode call's (stamp, range
start) places every host time of the session on its device timeline.

The alignment check tests the line on points it was not fitted to, each
a limit that causality sets: the card cannot run what the host has not
yet issued, nor the host read what the card has not yet done.
  * Every other decode range, paired with the engine's ``decode`` span
    that issued it (the span that holds the wrapper's record of its
    call), starts on the device no earlier than `EARLY_NS` before that
    span opened; and the least such lag in the session is at most
    `LAG_NS` (each decode is issued on a drained card).
  * Every prefill range starts no earlier than `EARLY_NS` before the
    wrapper stamped its call, which it does before the range's marker.
  * Every decode range ends no later than `EARLY_NS` after the loop
    thread's next ``sample`` span closed: that span's ``.cpu()`` waits
    for the step's logits.
A session that fails one of them, that has fewer than `MIN_POINTS`
tested points or fewer than three decode ranges, or whose ranges and
calls or spans do not pair, makes the idle split None.

The idle split cuts each idle gap of a session at the edges of the loop
thread's ``pass`` children and gives each piece to the child it falls
in, grouped as `PHASES`, or to ``unspanned`` where it falls in none; the
four parts add up to the slice's idle time.
"""
from __future__ import annotations

import bisect
import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

EARLY_NS = 50_000
LAG_NS = 1_000_000
MIN_POINTS = 2
PHASES = {"admit": "refill", "refill": "refill", "sample": "retire",
          "retire": "retire", "decode": "decode"}
PARTS = ("refill", "retire", "decode", "unspanned")
ROUNDTRIP = ("deploy.shard", "deploy.place", "deploy.pin", "runtime.build")


def profiler_ns(spans, t_ns: int) -> int:
    """A span's ``perf_counter_ns`` time on the profiler's clock."""
    perf, unix = spans.anchor
    return t_ns - perf + unix


def _named(spans, name: str) -> list:
    return [r for r in spans.records if r.name == name]


def _holding(spans_sorted: list, starts: List[int], t_ns: int):
    i = bisect.bisect_right(starts, t_ns) - 1
    if i >= 0 and t_ns <= spans_sorted[i].t1_ns:
        return spans_sorted[i]
    return None


class Alignment(NamedTuple):
    """A session that passed the check: its least decode lag (ns), the
    points tested, the loop thread, and the placement, which maps a
    span's ``perf_counter_ns`` time onto the session's device
    timeline."""
    lag_ns: int
    points: int
    tid: int
    place: Callable[[int], int]


def _ns(call) -> int:
    return round(call[1] * 1e9)


def session_alignment(part, spans) -> Optional[Alignment]:
    """The session's `Alignment`, or None where it fails the check.  Its
    decode and prefill ranges pair one to one with the wrapper's records
    of their calls, and each decode call with the loop thread's decode
    span that holds it (the thread's whose span holds the first)."""
    ranges = [r for r in part.ranges if r[0] == "decode"]
    calls = part.slice_calls("decode")
    fills = [r for r in part.ranges if r[0] == "prefill"]
    fill_calls = part.slice_calls("prefill")
    if (len(ranges) < 3 or len(ranges) != len(calls)
            or len(fills) != len(fill_calls)):
        return None
    at = [_ns(c) for c in calls]
    first = [r for r in _named(spans, "decode")
             if r.t0_ns <= at[0] <= r.t1_ns]
    if len(first) != 1:
        return None
    tid = first[0].tid
    decodes = sorted((r for r in _named(spans, "decode") if r.tid == tid),
                     key=lambda r: r.t0_ns)
    starts = [r.t0_ns for r in decodes]
    issued = [_holding(decodes, starts, t) for t in at]
    if None in issued or len({d.id for d in issued}) != len(issued):
        return None
    (h0, d0), (h1, d1) = [(profiler_ns(spans, at[i]), ranges[i][1])
                          for i in (0, -1)]
    if h1 <= h0:
        return None
    rate = (d1 - d0) / (h1 - h0)

    def place(t_ns: int) -> int:
        return round(d0 + (profiler_ns(spans, t_ns) - h0) * rate)

    lags = [a - place(d.t0_ns) for (_, a, _), d in zip(ranges[1:-1],
                                                       issued[1:-1])]
    early = lags + [a - place(_ns(c)) for (_, a, _), c in zip(fills,
                                                              fill_calls)]
    samples = sorted((r for r in _named(spans, "sample") if r.tid == tid),
                     key=lambda r: r.t0_ns)
    sample_starts = [r.t0_ns for r in samples]
    late = []
    for (_, _, b), d in zip(ranges, issued):
        i = bisect.bisect_left(sample_starts, d.t1_ns)
        if i < len(samples):
            late.append(place(samples[i].t1_ns) - b)
    if (len(early) + len(late) < MIN_POINTS or min(early) < -EARLY_NS
            or min(late, default=0) < -EARLY_NS or min(lags) > LAG_NS):
        return None
    return Alignment(min(lags), len(early) + len(late), tid, place)


def _children(spans, tid: int, place: Callable) -> List[Tuple[int, int, str]]:
    """The loop thread's pass children on a session's device timeline, by
    start: (start, end, part)."""
    passes = {r.id for r in spans.records
              if r.name == "pass" and r.tid == tid}
    return sorted((place(r.t0_ns), place(r.t1_ns),
                   PHASES.get(r.name, "unspanned"))
                  for r in spans.records if r.parent in passes)


def _split_gap(lo: int, hi: int, kids, starts, out: Dict[str, int]) -> None:
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    covered = 0
    while i < len(kids) and kids[i][0] < hi:
        x, y = max(lo, kids[i][0]), min(hi, kids[i][1])
        if y > x:
            out[kids[i][2]] += y - x
            covered += y - x
        i += 1
    out["unspanned"] += hi - lo - covered


def idle_split(slices, spans) -> Optional[Dict[str, float]]:
    """The slice's idle seconds by the host phase they fall under
    (`PARTS`); None without a slice or spans, or where a session fails
    the alignment check."""
    if slices is None or spans is None:
        return None
    out = dict.fromkeys(PARTS, 0)
    for part in slices.parts:
        got = session_alignment(part, spans)
        if got is None:
            return None
        kids = _children(spans, got.tid, got.place)
        starts = [k[0] for k in kids]
        t = part.start_ns
        for a, b in part.busy() + [(part.end_ns, part.end_ns)]:
            if a > t:
                _split_gap(t, a, kids, starts, out)
            t = max(t, b)
    return {k: v / 1e9 for k, v in out.items()}


def idle_shares(slices, spans) -> Optional[Dict[str, float]]:
    """`idle_split` as percent of the slice's window."""
    split = idle_split(slices, spans)
    if split is None or not slices.window_s:
        return None
    return {k: 100.0 * v / slices.window_s for k, v in split.items()}


def alignments(slices, spans) -> Optional[List[Alignment]]:
    """Each session's `Alignment`, where every one passes the check."""
    got = [session_alignment(p, spans) for p in slices.parts]
    return None if not got or None in got else got


def min_lag_ns(slices, spans) -> Optional[int]:
    """The least lag over the slice's sessions, where every one passes."""
    got = alignments(slices, spans)
    return None if got is None else min(g.lag_ns for g in got)


def weights_roundtrip_s(spans) -> Optional[float]:
    """Seconds of the weights' round trip at deploy (host numpy, placed
    and pinned in Pilot-Data, read back and copied to the card): the
    time in which one of its spans is open, so a later pilot's pin that
    overlaps an earlier pilot's build counts once."""
    got = sorted((r.t0_ns, r.t1_ns) for r in spans.records
                 if r.name in ROUNDTRIP) if spans else []
    if not got:
        return None
    total, end = 0, got[0][0]
    for a, b in got:
        total += max(0, b - max(a, end))
        end = max(end, b)
    return total / 1e9


def _in_window(spans, name: str, w0: float, w1: float) -> list:
    lo, hi = round(w0 * 1e9), round(w1 * 1e9)
    return [r for r in _named(spans, name) if lo <= r.t0_ns <= r.t1_ns <= hi]


def flush_ms_per_pass(spans, w0: float, w1: float,
                      passes: int) -> Optional[float]:
    """ms of the ``flush_pages`` spans inside the window [w0, w1]
    (perf_counter seconds) over the window's decode passes."""
    if spans is None or not passes:
        return None
    got = _in_window(spans, "flush_pages", w0, w1)
    return sum(r.t1_ns - r.t0_ns for r in got) / 1e6 / passes


def decode_host_ms(spans, w0: float, w1: float) -> Optional[float]:
    """The mean ``decode`` span inside the window: the host's enqueue of
    one step."""
    got = _in_window(spans, "decode", w0, w1) if spans else []
    return (sum(r.t1_ns - r.t0_ns for r in got) / 1e6 / len(got)
            if got else None)


def queue_wait_ms(stamps: Sequence[tuple]) -> Optional[float]:
    """The mean of admit - submit (ms) over the window's completions."""
    waits = [s[1] - s[0] for s in stamps if s[1] is not None]
    return 1e3 * sum(waits) / len(waits) if waits else None


def ttft_p95_s(stamps: Sequence[tuple]) -> Optional[float]:
    """The 95th percentile (nearest rank) of first token - submit."""
    firsts = sorted(s[2] - s[0] for s in stamps if s[2] is not None)
    return firsts[math.ceil(0.95 * len(firsts)) - 1] if firsts else None
