"""The program's spans read against a synthetic slice: the alignment
check, the idle split by host phase, and the readers of the spans and the
requests' stamps."""
import json
from types import SimpleNamespace

import pytest

from portbench.harness import spans as sp
from portbench.harness import spec, trace
from repro_torch.serving.spans import Span

MS = 1_000_000                   # ns
# the recording's anchor: the profiler's clock reads 4 s ahead of
# perf_counter_ns (the device's, `skew` more)
ANCHOR = (1000 * MS, 5000 * MS)
SHIFT = ANCHOR[1] - ANCHOR[0]

# the nine per-layer metrics the spans and stamps feed, both cells each
CELLS = ["starcoder2-7b.long-prompt-r32", "falcon-mamba-7b.long-prompt"]
ENTRIES = [
    dict(name=n, unit=u, better="lower", source="program_span", layer=l,
         moves=m, workloads=CELLS) for n, u, l, m in [
        ("weights_roundtrip_s", "s", "Pilot session and Pilot-Data",
         "setup_s"),
        ("queue_wait_ms", "ms", "Serving engine", "gen_tok_s"),
        ("ttft_p95_s", "s", "Serving engine", "gen_tok_s"),
        ("flush_ms_per_pass", "ms", "Pilot session and Pilot-Data",
         "gen_tok_s"),
        ("decode_host_ms", "ms", "Model step", "gen_tok_s"),
        ("idle_share.refill", "%", "Device", "gen_tok_s"),
        ("idle_share.retire", "%", "Device", "gen_tok_s"),
        ("idle_share.decode", "%", "Device", "gen_tok_s"),
        ("idle_share.unspanned", "%", "Device", "gen_tok_s")]]


def host(ms: float) -> int:
    """A time (ms) as perf_counter_ns."""
    return round(ms * MS) - SHIFT


def recording(decode_at: float = 16.0, tid: int = 7, sample: bool = True):
    """Pass A, -0.5-1 ms, ends with a decode span -0.2-1; pass B, 1-31:
    admit 1-2, refill 2-9, sample 9-11 (left out without `sample`),
    retire 11-15 (a flush 12-13), decode `decode_at`-26; pass C, 31-34,
    a decode span 31-33.5.  And a second loop thread's pass, left out."""
    spans = [("pass", None, -0.5, 1), ("decode", 1, -0.2, 1),
             ("pass", None, 1, 31), ("admit", 3, 1, 2), ("refill", 3, 2, 9),
             ("sample", 3, 9, 11), ("retire", 3, 11, 15),
             ("flush_pages", 7, 12, 13), ("decode", 3, decode_at, 26),
             ("pass", None, 31, 34), ("decode", 10, 31, 33.5)]
    recs = [Span(i, p, name, None, tid, host(a), host(b))
            for i, (name, p, a, b) in enumerate(spans, 1)
            if sample or name != "sample"]
    recs += [Span(20, None, "pass", None, 8, host(0), host(30)),
             Span(21, 20, "decode", None, 8, host(3), host(30))]
    return SimpleNamespace(records=recs, anchor=ANCHOR)


def session(decode_b_at: float = 16.2, skew: float = 0.0,
            drift: float = 0.0, prefill_at: float = 2.5,
            decode_a_end: float = 0.9):
    """The device timeline 0-34 ms of the host's, `skew` ms off and
    drifting `drift` ms a ms: busy 0-0.8 (decode A), 3-8 (a prefill),
    10.5-11 (sampling), 17-25 (decode B), 32-33 (decode C).  Decodes A
    and C open their ranges at their calls' stamps, 0 and 32; decode B,
    stamped at 16.1, at `decode_b_at`; the prefill, stamped at 2.4, at
    `prefill_at`.  Decode A's range ends at `decode_a_end`."""
    def dev(ms):
        return round((ms * (1 + drift) + skew) * MS)
    device = [("decode", dev(0), dev(0.8)), ("gemm", dev(3), dev(8)),
              ("argmax", dev(10.5), dev(11)), ("decode", dev(17), dev(25)),
              ("decode", dev(32), dev(33))]
    ranges = [("decode", dev(0), dev(decode_a_end)),
              ("prefill", dev(prefill_at), dev(8.5)),
              ("decode", dev(decode_b_at), dev(25.5)),
              ("decode", dev(32), dev(33.2))]
    calls = [("decode", host(t) / 1e9, False, True, None, None)
             for t in (0.0, 16.1, 32.0)]
    calls.insert(1, ("prefill", host(2.4) / 1e9, False, True, 1, 4096))
    return trace.Slice(dev(0), dev(34), device, ranges, calls)


@pytest.mark.parametrize("skew,drift", [(0.0, 0.0), (-2.5, 0.0),
                                        (40.0, 0.0), (-0.3, 0.0025)])
def test_gaps_are_cut_at_the_pass_children_and_attributed(skew, drift):
    split = sp.idle_split(trace.Slices([session(skew=skew, drift=drift)]),
                          recording())
    # idle 0.8-3, 8-10.5, 11-17, 25-32, 33-34 (host ms)
    want = {"refill": 3.0, "retire": 5.5, "decode": 3.7, "unspanned": 6.5}
    assert split == pytest.approx(
        {k: v * (1 + drift) / 1e3 for k, v in want.items()})


def test_the_four_shares_add_up_to_idle_share():
    sl = trace.Slices([session(), session(skew=-2.5, drift=0.0012)])
    shares = sp.idle_shares(sl, recording())
    idle = 100.0 * (1.0 - sl.busy_s / sl.window_s)
    assert sum(shares.values()) == pytest.approx(idle)
    assert shares["unspanned"] == pytest.approx(100.0 * 6.5 / 34.0)


@pytest.mark.parametrize("range_at,lag", [
    (16.2, 0.2), (15.96, -0.04),     # early by less than 50 us: kept
    (15.9, None),                    # the card before the host: refused
    (17.2, None)])                   # no decode within 1 ms: refused
def test_a_session_that_fails_alignment_gives_none(range_at, lag):
    sl = trace.Slices([session(skew=1.5),
                       session(range_at, skew=-2.5, drift=0.002)])
    got = sp.min_lag_ns(sl, recording())
    if lag is None:
        assert got is None and sp.idle_split(sl, recording()) is None
        assert sp.idle_shares(sl, recording()) is None
    else:
        assert got == pytest.approx(min(lag, lag * 1.002) * MS, abs=2)
        assert sp.idle_split(sl, recording()) is not None


@pytest.mark.parametrize("prefill_at,decode_a_end,passes", [
    (2.5, 0.9, True),
    (2.36, 0.9, True),      # a prefill 40 us before its stamp: kept
    (2.3, 0.9, False),      # 100 us before: the card before the host
    (2.5, 11.04, True),     # decode A ends 40 us after the sample read it
    (2.5, 11.1, False)])    # 100 us after: the host read it first
def test_points_the_line_was_not_fitted_to(prefill_at, decode_a_end,
                                           passes):
    sl = trace.Slices([session(skew=-2.5, drift=0.002),
                       session(prefill_at=prefill_at, skew=1.5,
                               drift=-0.0015, decode_a_end=decode_a_end)])
    got = sp.alignments(sl, recording())
    if passes:
        # decode B's start, the prefill's start and decode A's end
        assert [g.points for g in got] == [3, 3]
        assert sp.idle_split(sl, recording()) is not None
    else:
        assert got is None and sp.min_lag_ns(sl, recording()) is None
        assert sp.idle_split(sl, recording()) is None


def test_a_session_needs_two_tested_points():
    no_prefill = session()
    del no_prefill.ranges[1], no_prefill.calls[1]
    no_prefill.__post_init__()
    for sl, rec, points in [
            (session(), recording(sample=False), 2),    # decode B, prefill
            (no_prefill, recording(), 2),               # decode B, drain A
            (no_prefill, recording(sample=False), None)]:
        got = sp.alignments(trace.Slices([sl]), rec)
        assert (None if got is None else got[0].points) == points


def test_ranges_without_their_spans_give_none():
    # decode B's span opens after the wrapper recorded its call
    assert sp.idle_split(trace.Slices([session()]),
                         recording(decode_at=16.15)) is None
    extra = session()
    extra.ranges.append(("decode", 35 * MS, 36 * MS))   # 4 ranges, 3 calls
    extra.__post_init__()
    assert sp.idle_split(trace.Slices([extra]), recording()) is None
    short = session()
    del short.ranges[-1], short.calls[-1]          # two decodes: no check
    short.__post_init__()
    assert sp.idle_split(trace.Slices([short]), recording()) is None
    unstamped = session()
    del unstamped.calls[1]                         # a prefill, no call
    assert sp.idle_split(trace.Slices([unstamped]), recording()) is None


def test_every_reader_gives_none_without_spans_or_stamps():
    sl = trace.Slices([session()])
    assert sp.idle_split(None, recording()) is None
    assert sp.idle_split(sl, None) is None
    assert sp.idle_shares(sl, None) is None
    assert sp.weights_roundtrip_s(None) is None
    assert sp.flush_ms_per_pass(None, 0.0, 1.0, 10) is None
    assert sp.decode_host_ms(None, 0.0, 1.0) is None
    assert sp.queue_wait_ms([]) is None and sp.ttft_p95_s([]) is None
    empty = SimpleNamespace(records=[], anchor=ANCHOR)
    assert sp.weights_roundtrip_s(empty) is None
    assert sp.decode_host_ms(empty, 0.0, 1.0) is None


def test_the_readers_of_spans_and_stamps():
    # a second pilot's pin, 8-9.5 ms, overlaps the first's build: the
    # round trip is the time in which one of its spans is open, 0-9.5
    recs = [Span(1, None, "deploy", None, 1, 0, 10 * MS),
            Span(2, 1, "deploy.shard", None, 1, 0, 4 * MS),
            Span(3, 1, "deploy.place", None, 1, 4 * MS, 5 * MS),
            Span(4, 1, "deploy.pin", None, 1, 5 * MS, 7 * MS),
            Span(5, None, "runtime.build", None, 2, 7 * MS, 9 * MS),
            Span(6, 1, "deploy.pin", None, 1, 8 * MS, 9 * MS + MS // 2)]
    recs += [Span(10 + i, 5, "flush_pages", i, 2, (100 + i) * MS,
                  (100 + i) * MS + MS // 2) for i in range(4)]
    recs += [Span(20 + i, 6, "decode", None, 2, (200 + 10 * i) * MS,
                  (200 + 10 * i + 2 + i) * MS) for i in range(3)]
    rec = SimpleNamespace(records=recs, anchor=ANCHOR)
    assert sp.weights_roundtrip_s(rec) == pytest.approx(0.0095)
    # the window 0.1-0.22 s holds the four flushes and two decodes
    assert sp.flush_ms_per_pass(rec, 0.1, 0.22, 4) == pytest.approx(0.5)
    assert sp.decode_host_ms(rec, 0.1, 0.215) == pytest.approx(2.5)
    stamps = [(0.0, 0.5 * i, 0.5 * i + 0.1, 9.0) for i in range(20)]
    assert sp.queue_wait_ms(stamps) == pytest.approx(4750.0)
    assert sp.ttft_p95_s(stamps) == pytest.approx(9.1)   # 19th of 20


def test_check_names_accepts_the_nine_entries():
    bench = spec.load()
    bench = dict(bench, per_layer=bench["per_layer"] + ENTRIES)
    assert spec.check_names(bench) == []
    assert len(json.dumps(bench)) < 64 * 1024
    layers = {m["layer"] for m in spec.load()["per_layer"]}
    assert {m["layer"] for m in ENTRIES} <= layers
