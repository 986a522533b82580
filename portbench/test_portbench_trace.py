"""The traced slice's sessions on the CPU: the engine's loop held while
the profiler starts and stops, and sessions taken, retried and read as
one, with the profiler and the marker kernel stood in for."""
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import cell, trace


class FakeProfiler:
    """Records when it starts and stops, and whether the loop was held
    then; holds no events of its own."""
    log: list = []
    wrap = None

    def __init__(self, activities):
        pass

    def start(self):
        FakeProfiler.log.append(("start", FakeProfiler.wrap.held.is_set()))

    def stop(self):
        FakeProfiler.log.append(("stop", FakeProfiler.wrap.held.is_set()))


@pytest.fixture
def loop(monkeypatch):
    """A wrapper whose 'engine loop' is a thread making decode calls."""
    monkeypatch.setattr(trace, "mark", lambda: None)
    monkeypatch.setattr(trace, "START_S", 0.0)
    monkeypatch.setattr(trace, "profiler_ready", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfiler)
    FakeProfiler.log = []
    wrap = FakeProfiler.wrap = cell.Wrapper(SimpleNamespace(), traced=True)
    state = SimpleNamespace(calls=0, stop=False)

    def run():
        while not state.stop:
            wrap._slice()
            wrap.calls.append(("decode", 0.0, False, wrap.slicing, None,
                               None))
            wrap._call("decode", lambda: None)
            state.calls += 1
            time.sleep(0.001)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    yield wrap, state
    state.stop = True
    wrap.disarm()
    t.join(5)


def events_of(marks, lose=0):
    """Device events for a session's marks: a spin for each, and a kernel
    of work after each; the last `lose` spins missing."""
    out = []
    for i, _ in enumerate(marks):
        out.append(("spin_kernel", 100 * i, 100 * i + 10))
        out.append(("gemm", 100 * i + 20, 100 * i + 60))
    return out[:len(out) - 2 * lose] if lose else out


def test_the_loop_holds_while_the_profiler_starts_and_stops(loop):
    wrap, state = loop
    wrap.arm(3)
    assert wrap.held.wait(5)
    n = state.calls
    time.sleep(0.05)
    assert state.calls == n            # held at the session's first call
    wrap.release()
    assert wrap.held.wait(5)
    n = state.calls
    time.sleep(0.05)
    assert state.calls == n            # held at its last
    assert wrap.marks[0] == "slice.start" and wrap.marks[-1] == "slice.end"
    assert wrap.marks.count("decode.start") == 3
    wrap.disarm()
    time.sleep(0.05)
    assert state.calls > n and wrap.phase == "idle" and not wrap.slicing


def test_sessions_are_taken_retried_and_read_as_one(loop, monkeypatch):
    wrap, state = loop
    lose = iter([0, 1, 0, 0])          # the second session loses a marker
    monkeypatch.setattr(trace, "_device_events",
                        lambda prof: events_of(wrap.marks, next(lose)))
    sl = trace.take_all(wrap, 3, 2, 1, 5.0)
    assert isinstance(sl, trace.Slices) and len(sl.parts) == 3
    # four sessions, each started and stopped while the loop was held
    assert FakeProfiler.log == [("start", True), ("stop", True)] * 4
    assert len(sl.slice_calls("decode")) == 3 * 2
    assert sl.kernel_s(trace.re.compile("gemm")) == pytest.approx(
        sum(p.kernel_s(trace.re.compile("gemm")) for p in sl.parts))
    assert sl.breakdown()["device_ops"][0][0] == "gemm"


def test_sessions_that_keep_failing_give_no_slice(loop, monkeypatch):
    wrap, _ = loop
    monkeypatch.setattr(trace, "_device_events", lambda prof: [])
    assert trace.take_all(wrap, 2, 2, 2, 5.0) is None
    assert [k for k, _ in FakeProfiler.log] == ["start", "stop"] * 3
    assert wrap.phase == "idle"
