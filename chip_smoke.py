#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA card (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, then drives the port's
main path -- the paper's KMeans over points retained in pilot device
memory (PilotSession -> add_pilots -> data -> replicate_to_pilot ->
kmeans) -- at the paper's three scenario sizes, and checks the result
against the same run on the CPU.  Any failed check raises, so the script
exits non-zero; it also exits non-zero, printing no result, without CUDA
or outside a checkout of the repository.  It imports nothing of JAX or
of the JAX package.

Output: progress lines, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SOURCE = "src/repro_torch/kernels/kmeans/csrc/kmeans.cu"
REPLACES = "src/repro/kernels/kmeans/kmeans.py:47"
PARTS, ITERS, D = 8, 5, 8


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(n: int, k: int, d: int, esize: int):
    """Least time for the function on an H100 SXM (s) and what bounds it:
    2NKD fp32 FLOP for the distances, and the inputs read once plus the
    outputs written once."""
    flops = 2.0 * n * k * d
    nbytes = (n * d + k * d) * esize + (k * d + k + 1) * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def event_ms(torch, fn, reps: int) -> float:
    """Mean time per call on the card (CUDA events around `reps` eager
    calls, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device time per call with the host out of the way: `reps`
    calls captured into one CUDA graph and replayed between events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_trace(torch, fn):
    """Run fn() under torch.profiler (CUDA activity only).  Returns fn's
    result, the host wall seconds, and the device microseconds summed per
    kernel (or copy) name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out, wall, per


def kernel_stages(per: dict, calls: int) -> dict:
    """Device us per call of each of kmeans.cu's launches."""
    out = {}
    for name, us in per.items():
        m = re.search(r"(\w+)_kernel", name)
        if m and m.group(1) in ("assign", "accumulate", "finalize"):
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / calls
    return out


def check_kernel(torch, make_blobs, kernel_mod, op, n, k, d, dtype,
                 exact_counts: bool) -> dict:
    """Kernel vs plain version on the same card-resident inputs.

    Tolerances: sums rtol 1e-4 / atol 1e-3 (bf16: 5e-2 both), sse rtol
    1e-4, counts exact on the ragged shape; at the paper shapes an fp32
    near-tie may fall the other way under another summation order, so
    sum|dcounts| <= 1e-5*N, and each cluster's sums may then move by the
    largest |x| per point that changed sides."""
    pts, _ = make_blobs(n, min(k, 256), d=d, seed=11)
    cen = np.random.default_rng(12).normal(size=(k, d)).astype(np.float32)
    x = torch.from_numpy(pts).to("cuda", dtype)
    c = torch.from_numpy(cen).to("cuda", dtype)
    ks, kc, k_sse = op(x, c, impl="cuda")
    torch.cuda.synchronize()
    rs, rc, r_sse = op(x, c, impl="ref")
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    atol = 1e-3 if dtype == torch.float32 else 5e-2
    dcounts = (kc - rc).abs()
    moved = float(dcounts.sum())
    assert float(kc.sum()) == n, ("counts do not sum to N", float(kc.sum()))
    if exact_counts:
        assert moved == 0.0, f"counts differ by {moved} on a ragged shape"
    else:
        assert moved <= 1e-5 * n, f"sum|dcounts| = {moved} > 1e-5*N"
    xmax = float(x.float().abs().max())
    allow = atol + tol * rs.abs() + dcounts[:, None] * xmax
    err = (ks - rs).abs()
    assert bool((err <= allow).all()), (
        f"sums differ: max |err| {float(err.max())}")
    sse_err = abs(float(k_sse) - float(r_sse))
    assert sse_err <= 1e-4 * abs(float(r_sse)), (
        f"sse {float(k_sse)} vs plain {float(r_sse)}")
    ms = graph_ms(torch, lambda: op(x, c, impl="cuda"), reps=20)
    eager = event_ms(torch, lambda: op(x, c, impl="cuda"), reps=20)
    plain = event_ms(torch, lambda: op(x, c, impl="ref"), reps=5)
    _, _, per = device_trace(torch, lambda: [op(x, c, impl="cuda")
                                             for _ in range(5)])
    stages = kernel_stages(per, 5)
    assert set(stages) == {"assign", "accumulate", "finalize"}, per
    b_s, b_by = bound(n, k, d, x.element_size())
    row = {"n": n, "k": k, "d": d, "dtype": str(dtype).split(".")[-1],
           "kernel_ms": ms, "kernel_eager_ms": eager, "plain_ms": plain,
           "bound_us": b_s * 1e6, "bound_by": b_by,
           "max_abs_err": max(float(err.max()), sse_err),
           "sum_abs_dcounts": moved, "stage_us": stages}
    log(f"kernel check {row['dtype']} N={n} K={k} D={d}: "
        f"kernel_ms={ms:.6f} kernel_eager_ms={eager:.6f} "
        f"plain_ms={plain:.6f} bound_us={b_s * 1e6:.4f} ({b_by}) "
        f"max_abs_err={row['max_abs_err']:.3e} sum|dcounts|={moved} "
        f"stage_us={ {k_: round(v, 3) for k_, v in stages.items()} }")
    return row


def session_kmeans(core, pts, k: int, device, kernel_mod, tracer=None):
    """README Quickstart: two pilots, eight partitions replicated half to
    each, `iters` Lloyd iterations.  Returns the result, the kernel
    launches counted across the kmeans call, the residency check, and,
    with `tracer` (device_trace bound to torch), the kmeans call's
    (wall seconds, device us per kernel name)."""
    kw = {} if device is None else {"device": device}
    with core.PilotSession(**kw) as s:
        pilots = s.add_pilots(2, memory_gb=1)
        du = s.data("points", pts, parts=PARTS)
        du.replicate_to_pilot(pilots[0], parts=range(0, PARTS // 2))
        du.replicate_to_pilot(pilots[1], parts=range(PARTS // 2, PARTS))
        kernel_mod.LAUNCHES = 0
        if tracer is None:
            res, traced = s.kmeans(du, k=k, iters=ITERS), None
        else:
            res, *traced = tracer(lambda: s.kmeans(du, k=k, iters=ITERS))
        launches = kernel_mod.LAUNCHES
        resident = []
        for pilot, idxs in ((pilots[0], range(0, PARTS // 2)),
                            (pilots[1], range(PARTS // 2, PARTS))):
            tm = pilot.tier_manager
            for i in idxs:
                key = du._key(i)
                t = tm.backends["device"].get_device(key)
                resident.append((tm.tier_of(key), t.device.type))
    return res, launches, resident, traced


def main() -> int:
    import torch

    from repro_torch.core import (DataUnit, PilotComputeDescription,
                                  PilotComputeService, kmeans, make_backend)
    import repro_torch.core as core
    from repro_torch.core.analytics import PAPER_SCENARIOS, make_blobs
    from repro_torch.kernels.kmeans import kmeans as kernel_mod
    from repro_torch.kernels.kmeans.ops import kmeans_assign_op

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    # -- 1. setup -----------------------------------------------------------
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernel_mod.load()
    log(f"build: kmeans_assign from {SOURCE} in "
        f"{time.perf_counter() - t0:.3f} s")

    # -- 2. kernel vs its plain version on the card --------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(1_000_000, 50, 8, f32, False), (100_000, 500, 8, f32, False),
              (10_000, 5_000, 8, f32, False), (100_000, 500, 8, bf16, False),
              (1_037, 64, 32, f32, True)]
    # the shapes the main path hands the kernel: one partition of each
    shapes += [(n // PARTS, k, 8, f32, False)
               for n, k in PAPER_SCENARIOS.values()]
    rows = [check_kernel(torch, make_blobs, kernel_mod, kmeans_assign_op,
                         n, k, d, dt, exact) for n, k, d, dt, exact in shapes]
    torch.cuda.synchronize()

    # -- 3. the main path through PilotSession -------------------------------
    launches_total = 0
    for name, (n, k) in PAPER_SCENARIOS.items():
        pts, _ = make_blobs(n, min(k, 256), d=D, seed=3)
        gpu, launches, resident, _ = session_kmeans(core, pts, k, None,
                                                    kernel_mod)
        torch.cuda.synchronize()
        launches_total += launches
        assert launches == ITERS * PARTS, (
            f"scenario {name}: {launches} kernel launches, expected "
            f"{ITERS * PARTS}")
        assert all(r == ("device", "cuda") for r in resident), resident
        sse = gpu.sse_history
        for a, b in zip(sse[1:], sse[2:]):
            assert b <= a * (1 + 1e-5), f"scenario {name}: sse rose {sse}"
        cpu, cpu_launches, _, _ = session_kmeans(core, pts, k, "cpu",
                                                 kernel_mod)
        assert cpu_launches == 0, "the CPU run launched the CUDA kernel"
        np.testing.assert_allclose(gpu.sse_history, cpu.sse_history,
                                   rtol=1e-4)
        np.testing.assert_allclose(gpu.centroids, cpu.centroids, atol=1e-3)
        log(f"main path scenario {name} N={n} K={k} D={D}: "
            f"launches={launches} resident=device/cuda x{len(resident)} "
            f"sse={sse} iter_s={gpu.iter_seconds} "
            f"cpu_iter_s={cpu.iter_seconds} "
            f"max|dcentroids| vs cpu="
            f"{float(np.abs(gpu.centroids - cpu.centroids).max()):.3e}")

    # where an iteration's time goes: scenario i again, under the profiler
    n, k = PAPER_SCENARIOS["i"]
    pts, _ = make_blobs(n, min(k, 256), d=D, seed=3)
    _, launches, _, (wall, per) = session_kmeans(
        core, pts, k, None, kernel_mod,
        tracer=lambda fn: device_trace(torch, fn))
    assert launches == ITERS * PARTS, launches
    busy = sum(per.values())
    stages = kernel_stages(per, ITERS * PARTS)
    log(f"trace scenario i ({ITERS} iterations, profiler on): "
        f"wall_s={wall:.6f} device_busy_us={busy:.3f} "
        f"device_busy_share={busy / (wall * 1e6):.6f} "
        f"kmeans_assign_us={sum(stages.values()) * ITERS * PARTS:.3f} "
        f"other_device_us={busy - sum(stages.values()) * ITERS * PARTS:.3f}")

    # the v1 device-tier path: DataUnit on the device tier + kmeans(pilot=)
    n, k = PAPER_SCENARIOS["i"]
    pts, _ = make_blobs(n, min(k, 256), d=D, seed=3)
    svc = PilotComputeService()
    try:
        pilot = svc.submit_pilot(PilotComputeDescription(backend="inprocess"))
        backends = {"host": make_backend("host"),
                    "device": make_backend("device")}
        du = DataUnit.from_array("points-v1", pts, PARTS, backends,
                                 tier="device")
        kernel_mod.LAUNCHES = 0
        v1 = kmeans(du, k=k, iters=ITERS, pilot=pilot)
        launches = kernel_mod.LAUNCHES
        torch.cuda.synchronize()
    finally:
        svc.cancel_all()
    launches_total += launches
    assert launches == ITERS * PARTS, (
        f"v1 device path: {launches} launches, expected {ITERS * PARTS}")
    assert all(backends["device"].get_device(du._key(i)).is_cuda
               for i in range(PARTS))
    log(f"main path v1 device tier N={n} K={k}: launches={launches} "
        f"sse={v1.sse_history} iter_s={v1.iter_seconds}")

    # -- 4. the kernels line -----------------------------------------------
    head = rows[len(rows) - len(PAPER_SCENARIOS)]      # scenario i partition
    log(card)
    log(json.dumps({"kernels": [{
        "name": "kmeans_assign", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches_total, "checked": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_us"] / 1e3, "bound_by": head["bound_by"],
        "library_ms": None, "shapes": rows}]}))
    # -- 5. the last line ---------------------------------------------------
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
