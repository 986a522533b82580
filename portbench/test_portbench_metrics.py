"""The metric readers and the slice's arithmetic on a synthetic slice."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.harness import roofline, spec, trace
from portbench.harness.cell import load_module

MS = 1_000_000            # ns


def _reader(name):
    return load_module(spec.PACKAGE / "metrics" / f"{name}.py", f"m_{name}")


def _slice(calls):
    # 0-10 ms: a prefill range holding two kernels (2 ms flash, 3 ms gemm)
    # 12-20 ms: a decode range holding one 1 ms decode kernel
    device = [("flash_tc_kernel<128>", 1 * MS, 3 * MS),
              ("nvjet_gemm", 3 * MS, 6 * MS),
              ("decode_attn_kernel<bf16>", 14 * MS, 15 * MS),
              ("elementwise", 21 * MS, 22 * MS)]
    ranges = [("decode", 12 * MS, 20 * MS), ("prefill", 0, 10 * MS)]
    return trace.Slice(0, 25 * MS, device, ranges, calls)


CFG = spec.read_json(spec.PACKAGE / "configs" / "starcoder2-7b.json")
MIX = {"max_len": 4096}


def test_slice_busy_gaps_and_ranges():
    sl = _slice([])
    assert sl.busy() == [(1 * MS, 6 * MS), (14 * MS, 15 * MS),
                         (21 * MS, 22 * MS)]
    assert math.isclose(sl.busy_s, 0.007)
    gaps = [(n, round(s * 1e3, 6)) for n, s in sl.gaps()]
    assert gaps == [("prefill", 1.0), ("prefill", 4.0), ("outside", 2.0),
                    ("decode", 2.0), ("decode", 5.0), ("outside", 1.0),
                    ("outside", 3.0)]
    assert math.isclose(sl.range_device_s("prefill"), 0.005)
    assert math.isclose(sl.range_device_s("decode"), 0.001)
    bd = sl.breakdown()
    assert bd["device_ops"][0] == ["nvjet_gemm", 0.003]
    assert bd["idle_gaps"][:2] == [["decode", 0.005], ["prefill", 0.004]]
    run = SimpleNamespace(slice=sl)
    assert math.isclose(_reader("idle_share").read(run), 100 * (1 - 7 / 25))


def test_sessions_read_as_one_slice():
    one = _slice([("decode", 0.0, True, True, np.array([3]), None)])
    two = trace.Slices([one, _slice([])])
    assert math.isclose(two.window_s, 0.050)
    assert math.isclose(two.busy_s, 0.014)
    assert two.gaps() == one.gaps() * 2
    assert len(two.slice_calls("decode")) == 1
    assert math.isclose(two.range_device_s("prefill"), 0.010)
    bd = two.breakdown()
    assert bd["device_ops"][0] == ["nvjet_gemm", 0.006]
    assert bd["idle_gaps"][:2] == [["decode", 0.005], ["decode", 0.005]]
    run = SimpleNamespace(slice=two)
    assert math.isclose(_reader("idle_share").read(run), 100 * (1 - 14 / 50))


def test_kernel_rooflines_and_prefill_time():
    pos = np.array([2047, 0, 4095])
    calls = [("prefill", 0.0, True, True, 1, 2048),
             ("decode", 0.0, True, True, pos, np.array([1, 0, 1], bool))]
    run = SimpleNamespace(slice=_slice(calls), config=CFG, mix=MIX)
    f, b, p, _ = roofline.flash_cost(1, 2048, 2048, 36, 4, 128, 2, True,
                                     4096)
    want = 32 * roofline.bound(f, b, p)[0] / 0.002 * 100
    assert math.isclose(_reader("flash_attention_roofline").read(run), want)
    f, b, p = roofline.attention_cost(3, 4096, 36, 4, 128, 2,
                                      2048 + 1 + 4096)
    want = 32 * roofline.bound(f, b, p)[0] / 0.001 * 100
    assert math.isclose(_reader("decode_attention_roofline").read(run), want)
    assert _reader("selective_scan_roofline").read(run) is None
    assert math.isclose(_reader("prefill_ms_per_ktok").read(run),
                        5.0 / 2.048)


def test_window_metrics():
    pos = np.array([100, 7, 3000])
    moved = np.array([True, False, True])
    run = SimpleNamespace(
        config=CFG, mix=MIX, window_s=2.0, setup_s=40.0, deploy_s=9.0,
        latencies=list(np.arange(1.0, 21.0)),
        delta={"tokens_served": 640, "decode_passes": 10},
        calls=[("prefill", 0.0, True, False, 1, 1000),
               ("decode", 0.0, True, False, pos, moved)])
    assert _reader("gen_tok_s").read(run) == 320.0
    assert _reader("latency_p95_s").read(run) == 19.0
    assert _reader("request_p95_s").read(run) == 19.0
    assert _reader("pass_ms").read(run) == 200.0
    assert _reader("rows_per_pass").read(run) == 64.0
    flops = (roofline.prefill_flops(CFG, 1, 1000)
             + roofline.decode_flops(CFG, [100, 3000]))
    assert math.isclose(_reader("mfu.serve").read(run),
                        100 * flops / (2.0 * 989e12))
    assert _reader("setup_s").read(run) == 40.0
    assert _reader("deploy_s").read(run) == 9.0


@pytest.mark.parametrize("name", [
    "prefill_ms_per_ktok", "flash_attention_roofline",
    "decode_attention_roofline", "selective_scan_roofline", "idle_share"])
def test_a_reader_with_nothing_to_read_gives_nothing(name):
    run = SimpleNamespace(slice=None, config=CFG, mix=MIX, calls=[])
    assert _reader(name).read(run) is None
