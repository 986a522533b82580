"""The traced run's profiler slice and what is read from it.

`profiler_ready` and the retry of an empty session are copied from
``chip_smoke.py`` (``profiler_ready``, ``device_trace(retries=)``): a
process's first profiler session may hold no device event while CUPTI
starts, so the first session is preceded by a few small kernels traced
until one is seen, and a session that holds no device event is taken
again.

The slice is a few short profiler sessions (device activity only), each
over a few passes, read together (`Slices`): a session of some 100k
device events has lost its last records, and every session after it in
the process held only the first few thousand.  The model wrapper cuts
each session on the engine's loop thread (``cell.Wrapper``), from one
decode call to a later one, so it holds whole passes, and holds the loop
at both ends while the main thread starts or stops the profiler, so that
no kernel is launched meanwhile.  While a session is on, the wrapper
launches a marker kernel (``torch.cuda._sleep``, a spin of `SPIN_CYCLES`
cycles) at its two ends and at the start and end of every prefill and
decode call, naming each marker in order on the host.  The program's work
and the markers run in the order they were issued on the one stream, so
the device's own timeline gives each call's range and the session's
bounds, with no clock shared between host and device and no
synchronisation added inside the session: a kernel belongs to the range
whose markers hold it, an idle gap to the range it falls in, or to
neither ("outside": sampling, bookkeeping, admission).
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import sys
import time
from typing import List, Optional, Tuple

import torch

SPIN_CYCLES = 1000
# seconds between the profiler's start and the session's, for CUPTI to
# settle (the loop is held meanwhile)
START_S = 0.5
SPIN = re.compile(r"spin_kernel")


def profiler_ready(tries: int = 5) -> int:
    """Trace a few small kernels until the profiler delivers device
    events; returns the sessions it took, raises if none of `tries`
    did."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                x.mul_(1.0)
            torch.cuda.synchronize()
        if _device_events(prof):
            return attempt
        print(f"profiler session {attempt} held no device event",
              file=sys.stderr)
    raise RuntimeError(f"the profiler recorded no device event in {tries} "
                       f"sessions")


def mark() -> None:
    """One marker kernel on the current stream."""
    torch.cuda._sleep(SPIN_CYCLES)


def _device_events(prof) -> List[Tuple[str, int, int]]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            a = e.start_ns()
            out.append((e.name(), a, a + e.duration_ns()))
    return out


@dataclasses.dataclass
class Slice:
    """What one profiled slice holds (device times, ns)."""
    start_ns: int
    end_ns: int
    device: List[Tuple[str, int, int]]            # (name, start, end)
    ranges: List[Tuple[str, int, int]]            # (label, start, end)
    calls: list                                   # the wrapper's records

    def __post_init__(self):
        self.ranges.sort(key=lambda r: r[1])
        self._starts = [r[1] for r in self.ranges]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def slice_calls(self, kind: str) -> list:
        return [c for c in self.calls if c[0] == kind]

    def busy(self) -> List[Tuple[int, int]]:
        """The device's busy intervals, merged."""
        out: List[List[int]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def _range_at(self, t: int) -> Optional[int]:
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.ranges[i][2]:
            return i
        return None

    def label(self, t: int) -> str:
        i = self._range_at(t)
        return "outside" if i is None else self.ranges[i][0]

    def gaps(self) -> List[Tuple[str, float]]:
        """Each idle gap (seconds), cut where a range starts or ends, each
        piece named for the range it lies in."""
        cuts = sorted({t for _, a, b in self.ranges for t in (a, b)})
        out, t = [], self.start_ns
        for a, b in self.busy() + [(self.end_ns, self.end_ns)]:
            if a > t:
                lo = bisect.bisect_right(cuts, t)
                hi = bisect.bisect_left(cuts, a)
                edges = [t] + cuts[lo:hi] + [a]
                out += [(self.label((x + y) // 2), (y - x) / 1e9)
                        for x, y in zip(edges, edges[1:]) if y > x]
            t = max(t, b)
        return out

    def kernel_s(self, pattern) -> float:
        """Device seconds of the kernels whose names match `pattern`."""
        return sum(b - a for name, a, b in self.device
                   if pattern.search(name)) / 1e9

    def range_device_s(self, label: str) -> float:
        """Device seconds of the activity inside the ranges of `label`."""
        total = 0
        for _, a, b in self.device:
            i = self._range_at(a)
            if i is not None and self.ranges[i][0] == label \
                    and b <= self.ranges[i][2]:
                total += b - a
        return total / 1e9

    def breakdown(self) -> dict:
        return breakdown(self.device, self.gaps())


def breakdown(device, gaps) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the range they fall in: ten of each."""
    ops = {}
    for name, a, b in device:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


@dataclasses.dataclass
class Slices:
    """The sessions of one traced run, read as one slice: times and
    calls add up, gaps and operations are pooled."""
    parts: List[Slice]

    @property
    def window_s(self) -> float:
        return sum(p.window_s for p in self.parts)

    @property
    def busy_s(self) -> float:
        return sum(p.busy_s for p in self.parts)

    def slice_calls(self, kind: str) -> list:
        return [c for p in self.parts for c in p.slice_calls(kind)]

    def gaps(self) -> List[Tuple[str, float]]:
        return [g for p in self.parts for g in p.gaps()]

    def kernel_s(self, pattern) -> float:
        return sum(p.kernel_s(pattern) for p in self.parts)

    def range_device_s(self, label: str) -> float:
        return sum(p.range_device_s(label) for p in self.parts)

    def breakdown(self) -> dict:
        return breakdown([e for p in self.parts for e in p.device],
                         self.gaps())


def take(wrap, calls: int, timeout: float,
         ready: bool = False) -> Optional[Slice]:
    """One profiler session over the passes of the next `calls` decode
    calls, the loop held while the profiler starts and stops (and, with
    `ready`, while `profiler_ready` runs first); None where the session
    held no device event or the markers do not match."""
    from torch.profiler import ProfilerActivity, profile
    first = len(wrap.calls)
    prof = profile(activities=[ProfilerActivity.CUDA])
    running = False
    wrap.arm(calls)
    try:
        if not wrap.held.wait(timeout):
            raise TimeoutError(f"no decode call in {timeout} s")
        torch.cuda.synchronize()
        if ready:
            print(f"profiler ready after {profiler_ready()} session(s)",
                  file=sys.stderr)
        prof.start()
        running = True
        time.sleep(START_S)
        wrap.release()
        if not wrap.held.wait(timeout):
            raise TimeoutError(f"the session did not end in {timeout} s")
        torch.cuda.synchronize()
        prof.stop()
        running = False
    finally:
        if running:
            prof.stop()
        wrap.disarm()
    events = _device_events(prof)
    spins = sorted((e for e in events if SPIN.search(e[0])),
                   key=lambda e: e[1])
    names = list(wrap.marks)
    if not events or len(spins) != len(names):
        span = ((max(e[2] for e in events) - min(e[1] for e in events)) / 1e6
                if events else 0.0)
        print(f"the session held {len(events)} device events over "
              f"{span:.1f} ms and {len(spins)} markers for {len(names)} "
              f"marks", file=sys.stderr)
        return None
    ranges, opened = [], {}
    for (_, a, b), name in zip(spins, names):
        label, end = name.rsplit(".", 1)
        if end == "start":
            opened[label] = b
        else:
            ranges.append((label, opened.pop(label), a))
    lo, hi = spins[0][2], spins[-1][1]
    device = [e for e in events if not SPIN.search(e[0])
              and lo <= e[1] and e[2] <= hi]
    body = [r for r in ranges if r[0] != "slice"]
    print(f"session: {len(events)} device events, {len(names)} markers",
          file=sys.stderr)
    return Slice(lo, hi, device, body,
                 [c for c in wrap.calls[first:] if c[3]])


def take_all(wrap, sessions: int, calls: int, retries: int,
             timeout: float) -> Optional[Slices]:
    """`sessions` sessions of `calls` decode calls each, a failed one
    taken again up to `retries` times in all; None where they run out."""
    parts: List[Slice] = []
    failed = 0
    while len(parts) < sessions:
        got = take(wrap, calls, timeout, ready=not parts and not failed)
        if got is not None:
            parts.append(got)
            continue
        failed += 1
        if failed > retries:
            return None
        print("the session is taken again", file=sys.stderr)
    return Slices(parts)
