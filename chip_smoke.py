#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA card (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, started together), holds each against its plain
PyTorch version on the card, then drives the port's paths, each with its
kernels' launch counts set to 0 just before and read just after:

- KMeans: the paper's KMeans over points retained in pilot device memory
  (PilotSession -> add_pilots -> data -> replicate_to_pilot -> kmeans) at
  the paper's three scenario sizes, checked against the same run on the
  CPU (kernel kmeans_assign);
- serving Llama-3.2-1B at its published widths (random weights from a
  seed) by ServingEngine on a PilotSession pilot, 16 requests at batch 8
  (kernels flash_attention in each prefill, on the tensor cores since the
  model runs bf16, decode_attention in each decode step), after a
  model-level check of the kernel decode path against the plain one and
  an fp32 run;
- serving Hymba-1.5B at its published widths (32 layers of parallel
  attention and Mamba heads, sliding window 1024 but for 3 global layers)
  the same way, 16 requests of 512-2048 prompt tokens at batch 8 (kernels
  flash_attention and selective_scan in each prefill, decode_attention in
  each decode step), after a model-level check of the kernel path against
  the plain path and an fp32 run on prompts longer than the window.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, without CUDA or outside a checkout of the
repository.  It imports nothing of JAX or of the JAX package.

Output: progress lines, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
SOURCE = "src/repro_torch/kernels/kmeans/csrc/kmeans.cu"
REPLACES = "src/repro/kernels/kmeans/kmeans.py:47"
ATTN_SOURCE = ("src/repro_torch/kernels/decode_attention/csrc/"
               "decode_attention.cu")
ATTN_REPLACES = "src/repro/kernels/decode_attention/decode_attention.py:66"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention_sm90.cu")        # bf16: every model path
FLASH_FP32_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu")
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:82"
SCAN_SOURCE = ("src/repro_torch/kernels/selective_scan/csrc/"
               "selective_scan.cu")
SCAN_REPLACES = "src/repro/kernels/selective_scan/selective_scan.py:55"
PEAK_BF16_FLOPS = 989e12          # dense tensor-core bf16
# the SFUs' exp rate: 16 per clock per SM, 132 SMs at the 1.98 GHz boost
PEAK_EXP_PER_S = 16 * 132 * 1.98e9
PARTS, ITERS, D = 8, 5, 8
# the serving phase: Llama-3.2-1B, batch 8, 1024-slot cache, 16 requests
SERVE_BATCH, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_GEN = 8, 1024, 16, 64
PROMPT_LENS = (96, 128, 160)
# the Hymba phases: 4 prompts of 1536 (past the 1024 window) for the model
# check; 16 requests of 512/1280/2048 tokens into a 4096-slot cache
HYMBA_CHECK_LEN, HYMBA_MAX_LEN = 1536, 4096
HYMBA_PROMPT_LENS = (512, 1280, 2048)


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


# the kernels kmeans.cu launches per call (profiler names, "<stage>_kernel")
KMEANS_STAGES = ("kmeans_fused",)


def kernel_stages(per: dict, calls: int) -> dict:
    """Device us per call of each of kmeans.cu's launches."""
    out = {}
    for name, us in per.items():
        m = re.search(r"(\w+)_kernel", name)
        if m and m.group(1) in KMEANS_STAGES:
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
    again = op(x, c, impl="cuda")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((ks, kc, k_sse), again)), (
        "two calls on the same inputs differ")
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
    assert set(stages) == set(KMEANS_STAGES), per
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


def valid_slots(torch, cpos, pos, window: int) -> int:
    """Slots that pass the kernel's slot_ok, over all batch rows."""
    rel = pos[:, None] - cpos
    valid = (cpos >= 0) & (rel >= 0)
    if window:
        valid &= rel < window
    return int(valid.sum())


def attention_bound(b: int, sc: int, nq: int, nkv: int, h: int, esize: int,
                    valid: int):
    """Least time for decode attention on an H100 SXM (s) and what bounds
    it: the K and V rows of the `valid` slots read once (no kernel needs
    an empty slot's row), cache_pos and positions read once, q read and
    the output written once; 4*H fp32 FLOP per valid slot and query head
    (the two products).  With valid = b*sc it counts every row, empty
    slots too (the bound_all_rows_us of the log line)."""
    nbytes = (2 * valid * nkv * h * esize + 2 * b * nq * h * esize
              + 4 * b * sc + 4 * b)
    flops = 4.0 * valid * (nq // nkv) * h
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def rotating(sets, fn):
    """A callable that runs fn on the next input set each call: with the
    sets' bytes well past the 50 MB L2, every call reads device memory
    cold, as a layer of the decode loop does."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def attention_inputs(torch, b, sc, nq, nkv, h, dtype, fill=1.0, first=None,
                     seed=0):
    """q, k, v (dtype) and cache_pos, positions (int32) on the card.  With
    `first`, a rolling cache: row i is at position first+i and holds the
    last sc positions, position p in slot p % sc; else slots 0..fill*sc-1
    hold positions 0.. and the rest are empty (-1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, nq, h), (b, sc, nkv, h), (b, sc, nkv, h)))
    slot = torch.arange(sc, device="cuda", dtype=torch.int32)
    if first is None:
        n = max(1, int(sc * fill))
        cpos = torch.where(slot < n, slot, -1).expand(b, sc).contiguous()
        pos = torch.full((b,), n - 1, dtype=torch.int32, device="cuda")
    else:
        pos = first + torch.arange(b, device="cuda", dtype=torch.int32)
        # the newest position p <= cur held in slot s: cur - (cur - s) % sc
        cpos = pos[:, None] - (pos[:, None] - slot[None]) % sc
        cpos = cpos.to(torch.int32).contiguous()
    return q, k, v, cpos, pos


def sdpa_attention(torch, q, k, v, cpos, pos, window):
    """The library call: scaled_dot_product_attention over the same cache
    tensors, with the boolean mask built from cache_pos and GQA."""
    import torch.nn.functional as F
    rel = pos[:, None] - cpos
    valid = (cpos >= 0) & (rel >= 0)
    if window:
        valid &= rel < window
    out = F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True)
    return out[:, :, 0]


def check_attention(torch, op, ref, name, b, sc, nq, nkv, h, dtype,
                    window=0, **kind) -> dict:
    """decode_attention kernel vs its plain version on the same
    card-resident inputs.  Tolerances: fp32 atol/rtol 2e-5 (as
    tests/test_kernels.py); bf16 atol 1e-2 against the fp32 plain result
    cast to bf16.  Then times: kernel (CUDA-graph replay and eager),
    plain version and SDPA, each over enough input copies to exceed L2."""
    from repro_torch.kernels.decode_attention import decode_attention as mod
    args = attention_inputs(torch, b, sc, nq, nkv, h, dtype, **kind)
    routes = (mod.TC_LAUNCHES, mod.CORE_LAUNCHES)
    got = op(*args, window=window, impl="cuda")
    again = op(*args, window=window, impl="cuda")
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16          # bf16 on the tensor cores
    assert (mod.TC_LAUNCHES, mod.CORE_LAUNCHES) == (
        routes[0] + 2 * tc, routes[1] + 2 * (not tc)), (
        f"decode_attention {name}: not on the {dtype} route")
    assert torch.equal(got, again), (
        f"decode_attention {name}: two calls on the same inputs differ")
    q, k, v, cpos, pos = args
    want = ref(q.float(), k.float(), v.float(), cpos, pos, window=window)
    if dtype == torch.float32:
        tol, rtol = 2e-5, 2e-5
    else:
        tol, rtol, want = 1e-2, 0.0, want.to(dtype)
    err = (got.float() - want.float()).abs()
    allow = tol + rtol * want.float().abs()
    assert bool((err <= allow).all()), (
        f"decode_attention {name}: max |err| {float(err.max())}")
    lib = sdpa_attention(torch, *args, window)
    lib_err = float((lib.float() - want.float()).abs().max())
    assert lib_err <= 2e-2, f"SDPA disagrees on {name}: {lib_err}"
    esize = q.element_size()
    nbytes = 2 * b * sc * nkv * h * esize
    copies = max(2, math.ceil(3 * L2_BYTES / nbytes))
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]
    ms = graph_ms(torch, rotating(sets, lambda *a: op(
        *a, window=window, impl="cuda")), reps=4 * copies)
    eager = event_ms(torch, rotating(sets, lambda *a: op(
        *a, window=window, impl="cuda")), reps=2 * copies)
    plain = event_ms(torch, rotating(sets, lambda *a: op(
        *a, window=window, impl="ref")), reps=copies)
    library = event_ms(torch, rotating(sets, lambda *a: sdpa_attention(
        torch, *a, window)), reps=copies)
    valid = valid_slots(torch, cpos, pos, window)
    b_s, b_by = attention_bound(b, sc, nq, nkv, h, esize, valid)
    all_s, _ = attention_bound(b, sc, nq, nkv, h, esize, b * sc)
    row = {"shape": name, "b": b, "sc": sc, "nq": nq, "nkv": nkv, "h": h,
           "window": window, "dtype": str(dtype).split(".")[-1],
           "valid_slots": valid, "kernel_ms": ms, "kernel_eager_ms": eager,
           "plain_ms": plain, "library_ms": library, "bound_us": b_s * 1e6,
           "bound_by": b_by, "bound_all_rows_us": all_s * 1e6,
           "max_abs_err": float(err.max()), "library_max_abs_err": lib_err}
    log(f"decode_attention check {name} B={b} Sc={sc} {nq}/{nkv} H={h} "
        f"{row['dtype']} window={window} valid_slots={valid}: "
        f"kernel_ms={ms:.6f} kernel_eager_ms={eager:.6f} plain_ms={plain:.6f} "
        f"sdpa_ms={library:.6f} bound_us={b_s * 1e6:.4f} ({b_by}) "
        f"bound_all_rows_us={all_s * 1e6:.4f} "
        f"max_abs_err={row['max_abs_err']:.3e} sdpa_err={lib_err:.3e}")
    return row


def check_empty_slots(torch, op, ref) -> float:
    """Empty slots may hold anything, NaN included: the kernel's output
    must not change, bit for bit, and must match the plain version."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, cpos, pos = attention_inputs(torch, 2, 512, 8, 2, 64, dtype,
                                              fill=0.3, seed=9)
        clean = op(q, k, v, cpos, pos, impl="cuda")
        for junk in ("+100", "nan"):              # slots 153.. are empty
            k2, v2 = k.clone(), v.clone()
            for t in (k2, v2):
                if junk == "nan":
                    t[:, 153:] = float("nan")
                else:
                    t[:, 153:] += 100.0
            dirty = op(q, k2, v2, cpos, pos, impl="cuda")
            torch.cuda.synchronize()
            assert torch.equal(clean, dirty), (
                f"empty-slot garbage {junk} changed the {dtype} output")
        want = ref(q.float(), k.float(), v.float(), cpos, pos)
        worst = max(worst, float((clean.float() - want).abs().max()))
        assert worst <= (2e-5 if dtype == torch.float32 else 1e-2), worst
    log(f"decode_attention empty-slot check: +100 and NaN in empty slots "
        f"leave the output bit for bit; max |err| vs plain {worst:.3e}")
    return worst


def decode_logits(torch, model, params, cache, feed, first_pos):
    """Decode len(feed) steps teaching `feed`; returns the logits of every
    step (fp32 on the card) and the host ms of each (synchronised) step."""
    pos = torch.full((SERVE_BATCH,), first_pos, dtype=torch.int32,
                     device="cuda")
    out, ms = [], []
    for tok in feed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode(params, cache, tok[:, None], pos)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float())
        pos = pos + 1
    return out, ms


# the profiler names of decode_attention.cu's kernels
DECODE_ATTN_KERNELS = r"decode_attn_kernel"


def breakdown(per: dict) -> dict:
    """Device us of a traced prefill or decode step by kind: the attention
    and scan kernels' launches, GEMMs (cuBLAS/cuBLASLt names), everything
    else."""
    out = {"flash_attention": 0.0, "selective_scan": 0.0,
           "decode_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for name, us in per.items():
        if re.search(r"flash_tc_kernel|flash_kernel", name):
            out["flash_attention"] += us
        elif "scan_chunk_kernel" in name:
            out["selective_scan"] += us
        elif re.search(DECODE_ATTN_KERNELS, name):
            out["decode_attention"] += us
        elif re.search(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitK", name,
                       re.I):
            out["gemm"] += us
        else:
            out["other"] += us
    return out


def model_phase(torch, cfg, params) -> dict:
    """Kernel vs plain at model level, full width: prefill 8 prompts of 128
    tokens, then 8 decode steps with decode_kernel=True (the config's
    default), with decode_kernel=False and with the fp32 model (params
    cast to fp32), all
    fed the fp32 model's greedy tokens.  Tolerance: the kernel path may lie
    no further from the plain bf16 path than the plain bf16 path lies from
    the fp32 model on the same params and tokens (PERF.md)."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    kern = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, decode_kernel=False))
    m32 = build_model(dataclasses.replace(cfg, decode_kernel=False,
                                          dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE_BATCH, 128)).astype(np.int32)).cuda()
    l32, c32 = m32.prefill(p32, {"tokens": prompts}, SERVE_MAX_LEN)
    feed, cur = [], l32
    _, cache_k = kern.prefill(params, {"tokens": prompts}, SERVE_MAX_LEN)
    cache_p = tree_map(torch.clone, cache_k)
    # the fp32 model's greedy tokens, taught to all three
    want32 = []
    pos = torch.full((SERVE_BATCH,), 128, dtype=torch.int32, device="cuda")
    for _ in range(8):
        tok = cur.argmax(-1).to(torch.int32)
        feed.append(tok)
        cur, c32 = m32.decode(p32, c32, tok[:, None], pos)
        want32.append(cur.float())
        pos = pos + 1
    del p32, c32
    got_k, ms_k = decode_logits(torch, kern, params, cache_k, feed, 128)
    got_p, ms_p = decode_logits(torch, plain, params, cache_p, feed, 128)
    d = max(float((a - b).abs().max()) for a, b in zip(got_k, got_p))
    d_plain = max(float((a - b).abs().max()) for a, b in zip(got_p, want32))
    d_kernel = max(float((a - b).abs().max()) for a, b in zip(got_k, want32))
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(got_k, got_p))
    scale = max(float(a.abs().max()) for a in got_p)
    log(f"model check llama3.2-1b full width, 8 prompts x 128, 8 decode "
        f"steps: max|dlogits| kernel vs plain = {d:.6f} (bound: plain vs "
        f"fp32 = {d_plain:.6f}); kernel vs fp32 = {d_kernel:.6f}; "
        f"max|logits| {scale:.4f}; greedy agree {agree}/{8 * SERVE_BATCH}; "
        f"ms/step kernel {[round(x, 3) for x in ms_k]} plain "
        f"{[round(x, 3) for x in ms_p]}")
    assert all(bool(torch.isfinite(a).all()) for a in got_k + got_p)
    assert d <= d_plain, (f"kernel decode differs from the plain decode by "
                          f"{d}, more than the plain bf16 path's own error "
                          f"{d_plain} against fp32")
    # one decode step under the profiler: where its device time goes
    pos = torch.full((SERVE_BATCH,), 136, dtype=torch.int32, device="cuda")
    _, wall, per = device_trace(torch, lambda: kern.decode(
        params, cache_k, feed[-1][:, None], pos))
    parts = breakdown(per)
    assert parts["decode_attention"] > 0, (
        f"the decode step launched decode_attention but no traced kernel "
        f"matched {DECODE_ATTN_KERNELS!r}: {sorted(per)}")
    busy = sum(parts.values())
    log(f"trace of one decode step (kernel path, B=8, Sc=1024, profiler "
        f"on): wall_us={wall * 1e6:.3f} device_busy_us={busy:.3f} "
        f"device_busy_share={busy / (wall * 1e6):.6f} "
        f"decode_attention_us={parts['decode_attention']:.3f} "
        f"gemm_us={parts['gemm']:.3f} other_us={parts['other']:.3f} "
        f"kernels={len(per)}")
    return {"max_abs_dlogits": d, "plain_vs_fp32": d_plain,
            "kernel_vs_fp32": d_kernel, "greedy_agree": agree,
            "ms_per_step_kernel": ms_k, "ms_per_step_plain": ms_p,
            "step_us": parts, "step_wall_us": wall * 1e6}


def zero_counts(kernels: dict) -> None:
    """`kernels` maps a name to (kernel module, launch counter attribute)."""
    for mod, attr in kernels.values():
        setattr(mod, attr, 0)


def read_counts(kernels: dict) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernels.items()}


def serve(torch, core, cfg, params, prompts, kernels: dict, *, max_len: int,
          memory_gb: float):
    """ServingEngine on a one-pilot PilotSession on the card: greedy
    SERVE_GEN tokens for each prompt at batch SERVE_BATCH.  `kernels` maps
    a name to (kernel module, counter): each count is set to 0 just before
    the requests go in and read just after they drained.  Returns the engine's
    stats, the launches, the wall seconds, the deploy+load seconds and the
    device types the runtime's params and cache were seen on."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServingEngine

    model = build_model(cfg)
    seen = set()
    inner = model.decode

    def probe(params, cache, tokens, positions):
        # where the runtime's params and cache live, at every decode call
        seen.update(t.device.type for t in tree_leaves(params))
        seen.update(t.device.type for t in tree_leaves(cache))
        return inner(params, cache, tokens, positions)

    model = dataclasses.replace(model, decode=probe)
    with core.PilotSession() as s:
        (pilot,) = s.add_pilots(1, memory_gb=memory_gb)
        with ServingEngine(s, model, params=params, batch_size=SERVE_BATCH,
                           max_len=max_len, page_tokens=16) as eng:
            t0 = time.perf_counter()
            eng.deploy()
            # the resident loop rebuilds the params on the card from the
            # pilot's shard replicas first; serve once that is done
            deadline = time.monotonic() + 300
            while (eng.name, "runtime") not in pilot._jit_cache:
                if time.monotonic() > deadline:
                    raise RuntimeError("the serving runtime was not built "
                                       "within 300 s")
                time.sleep(0.01)
            setup = time.perf_counter() - t0
            zero_counts(kernels)
            t0 = time.perf_counter()
            reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
            eng.drain(timeout=900)
            wall = time.perf_counter() - t0
            launches = read_counts(kernels)
            outs = [r.result(timeout=10) for r in reqs]
            st = eng.stats()
    n = len(prompts)
    assert st["completed"] == n, st
    assert all(len(o) == SERVE_GEN for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert st["tokens_served"] == n * SERVE_GEN, st
    assert st["refills"] >= SERVE_BATCH, st
    assert seen == {"cuda"}, f"runtime params/cache on {seen}"
    return {"stats": st, "wall_s": wall, "launches": launches,
            "setup_s": setup}


def serve_line(name, cfg, res) -> str:
    st, wall = res["stats"], res["wall_s"]
    steps = st["decode_steps"]
    return (f"serving {name} full width on 1 pilot: "
            f"{st['completed']} requests, {st['tokens_served']} tokens in "
            f"{wall:.6f} s ({st['tokens_served'] / wall:.3f} tok/s), "
            f"{steps} decode steps ({wall / steps * 1e3:.4f} ms per step, "
            f"refills included), refills={st['refills']} "
            f"waves={st['waves']} p50_latency_s={st['p50_latency_s']:.6f} "
            f"p99_latency_s={st['p99_latency_s']:.6f} launches="
            f"{res['launches']} ({cfg.num_layers} layers); params+cache on "
            f"cuda; deploy+load {res['setup_s']:.3f} s")


def serving_phase(torch, core, cfg, params, kernels: dict) -> dict:
    """The Llama serving path at full width: 16 greedy requests of 96-160
    prompt tokens into a 1024-slot cache.  flash_attention runs once per
    layer in each prefill (a wave or a refill), decode_attention once per
    layer in each decode step."""
    rng = np.random.default_rng(0)
    lens = itertools.islice(itertools.cycle(PROMPT_LENS), SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    res = serve(torch, core, cfg, params, prompts, kernels,
                max_len=SERVE_MAX_LEN, memory_gb=4)
    st, launches = res["stats"], res["launches"]
    prefills = st["waves"] + st["refills"]
    assert launches["decode_attention"] == (
        cfg.num_layers * st["decode_steps"]), (launches, st)
    assert launches["decode_attention_tc"] == launches["decode_attention"], (
        launches)                               # bf16: the tensor cores
    assert launches["flash_attention"] == cfg.num_layers * prefills, (
        launches, st)
    assert launches["flash_attention_fp32"] == 0, launches   # bf16 model
    log(serve_line("llama3.2-1b", cfg, res))
    return res


def hymba_inputs(torch, cfg, b: int, s: int, seed: int):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()


def flash_bound(b, sq, skv, nq, nkv, h, esize, causal, window):
    """Least time for flash attention on an H100 SXM (s), what bounds it and
    the valid (q, kv) pairs: 4*H FLOP per valid pair and query head against
    the tensor-core peak of the input type (bf16; fp32 runs outside the
    tensor cores, at the fp32 peak), and q, k, v read and the output
    written once."""
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    flops = 4.0 * b * nq * h * pairs
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_FP32_FLOPS
    nbytes = (2 * b * sq * nq * h + 2 * b * skv * nkv * h) * esize
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), pairs


def sdpa_prefill(torch, q, k, v, causal, window):
    """The library call: scaled_dot_product_attention with the boolean
    causal/window mask and enable_gqa, in the (B,S,N,H) layout."""
    import torch.nn.functional as F
    sq, skv = q.shape[1], k.shape[1]
    rel = (torch.arange(sq, device=q.device)[:, None]
           - torch.arange(skv, device=q.device)[None, :])
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rel >= 0
    if window:
        mask &= rel < window
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def check_flash(torch, op, name, b, s, nq, nkv, h, dtype, window,
                causal=True, timed=True) -> dict:
    """flash_attention kernel vs its plain version on the same
    card-resident inputs (bf16 runs on the tensor-core kernel, fp32 on the
    CUDA-core one).  Tolerances: fp32 atol/rtol 2e-5 (as
    tests/test_kernels.py); bf16 atol/rtol 2e-2 against the fp32 plain
    result cast to bf16.  With `timed`, times: kernel (CUDA-graph replay
    and eager), plain version and SDPA, each over enough input copies to
    exceed L2."""
    g = torch.Generator(device="cuda").manual_seed(5)
    args = tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, s, nq, h), (b, s, nkv, h), (b, s, nkv, h)))
    got = op(*args, causal=causal, window=window, impl="cuda")
    torch.cuda.synchronize()
    want = op(*(t.float() for t in args), causal=causal, window=window,
              impl="ref")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    want = want.to(dtype).float()
    err = (got.float() - want).abs()
    assert bool((err <= tol + tol * want.abs()).all()), (
        f"flash_attention {name}: max |err| {float(err.max())}")
    route = "tensor cores" if dtype == torch.bfloat16 else "cuda cores"
    if not timed:
        log(f"flash_attention check {name} B={b} S={s} {nq}/{nkv} H={h} "
            f"{str(dtype).split('.')[-1]} window={window} causal={causal} "
            f"({route}): max_abs_err={float(err.max()):.3e}")
        return {"shape": name, "b": b, "s": s, "nq": nq, "nkv": nkv, "h": h,
                "window": window, "causal": causal, "route": route,
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": float(err.max())}
    lib = sdpa_prefill(torch, *args, causal, window)
    lib_err = float((lib.float() - want).abs().max())
    assert lib_err <= 5e-2, f"SDPA disagrees on {name}: {lib_err}"
    esize = args[0].element_size()
    nbytes = sum(t.numel() for t in args) * esize
    copies = max(2, math.ceil(3 * L2_BYTES / nbytes))
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]
    kw = {"causal": causal, "window": window}
    ms = graph_ms(torch, rotating(sets, lambda *a: op(
        *a, impl="cuda", **kw)), reps=2 * copies)
    eager = event_ms(torch, rotating(sets, lambda *a: op(
        *a, impl="cuda", **kw)), reps=copies)
    plain = event_ms(torch, rotating(sets, lambda *a: op(
        *a, impl="ref", **kw)), reps=copies)
    library = event_ms(torch, rotating(sets, lambda *a: sdpa_prefill(
        torch, *a, causal, window)), reps=copies)
    b_s, b_by, pairs = flash_bound(b, s, s, nq, nkv, h, esize, causal,
                                   window)
    row = {"shape": name, "b": b, "s": s, "nq": nq, "nkv": nkv, "h": h,
           "window": window, "causal": causal, "route": route,
           "dtype": str(dtype).split(".")[-1], "kernel_ms": ms,
           "kernel_eager_ms": eager, "plain_ms": plain,
           "library_ms": library, "bound_us": b_s * 1e6, "bound_by": b_by,
           "pairs": pairs, "max_abs_err": float(err.max()),
           "library_max_abs_err": lib_err}
    log(f"flash_attention check {name} B={b} S={s} {nq}/{nkv} H={h} "
        f"{row['dtype']} window={window} ({route}): kernel_ms={ms:.6f} "
        f"kernel_eager_ms={eager:.6f} plain_ms={plain:.6f} "
        f"sdpa_ms={library:.6f} bound_us={b_s * 1e6:.4f} ({b_by}) "
        f"max_abs_err={row['max_abs_err']:.3e} sdpa_err={lib_err:.3e}")
    return row


def scan_bound(b, s, di, n, esize):
    """Least time for the selective scan on an H100 SXM (s) and what
    bounds it: x, B, C read and y written in the input type, dt read and
    h_end written in fp32, once each; 7 fp32 operations per (b, t, d, n)
    (the exp counted as one) at the fp32 peak."""
    nbytes = (2 * b * s * di + 2 * b * s * n) * esize + (b * s * di
                                                         + b * di * n) * 4
    flops = 7.0 * b * s * di * n
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_scan(torch, op, name, b, s, di, n, dtype, h0=False) -> dict:
    """selective_scan kernel vs its plain version on the same card-resident
    inputs (drawn as tests/test_kernels.py draws them).  Tolerances: y
    atol/rtol 1e-4 in fp32 and 2e-2 in bf16 (one rounding of the same fp32
    sum), h_end atol/rtol 1e-4.  Times as check_flash; no PyTorch call
    computes the scan, so there is no library time."""
    g = torch.Generator(device="cuda").manual_seed(6)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    args = [(0.5 * rnd(b, s, di)).to(dtype),
            torch.nn.functional.softplus(rnd(b, s, di)),
            -torch.exp(0.3 * rnd(di, n)),
            (0.5 * rnd(b, s, n)).to(dtype), (0.5 * rnd(b, s, n)).to(dtype),
            torch.ones(di, device="cuda")]
    args.append(rnd(b, di, n) if h0 else None)
    y, h = op(*args, impl="cuda")
    torch.cuda.synchronize()
    wy, wh = op(*args, impl="ref")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ey = (y.float() - wy.float()).abs()
    eh = (h - wh).abs()
    assert bool((ey <= tol + tol * wy.float().abs()).all()), (
        f"selective_scan {name}: y max |err| {float(ey.max())}")
    assert bool((eh <= 1e-4 + 1e-4 * wh.abs()).all()), (
        f"selective_scan {name}: h_end max |err| {float(eh.max())}")
    esize = args[0].element_size()
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None)
    copies = max(2, math.ceil(3 * L2_BYTES / nbytes))
    sets = [args] + [[None if t is None else t.clone() for t in args]
                     for _ in range(copies - 1)]
    ms = graph_ms(torch, rotating(sets, lambda *a: op(*a, impl="cuda")),
                  reps=2 * copies)
    eager = event_ms(torch, rotating(sets, lambda *a: op(*a, impl="cuda")),
                     reps=copies)
    plain = event_ms(torch, rotating(sets, lambda *a: op(*a, impl="ref")),
                     reps=2)
    b_s, b_by = scan_bound(b, s, di, n, esize)
    sfu_us = b * s * di * n / PEAK_EXP_PER_S * 1e6   # one exp per (b,t,d,n)
    row = {"shape": name, "b": b, "s": s, "di": di, "n": n, "h0": h0,
           "dtype": str(dtype).split(".")[-1], "kernel_ms": ms,
           "kernel_eager_ms": eager, "plain_ms": plain, "library_ms": None,
           "bound_us": b_s * 1e6, "bound_by": b_by,
           "max_abs_err": float(ey.max()), "h_end_max_abs_err":
           float(eh.max())}
    log(f"selective_scan check {name} B={b} S={s} Di={di} N={n} "
        f"{row['dtype']} h0={h0}: kernel_ms={ms:.6f} "
        f"kernel_eager_ms={eager:.6f} plain_ms={plain:.6f} "
        f"bound_us={b_s * 1e6:.4f} ({b_by}) sfu_floor_us={sfu_us:.4f} "
        f"y_err={row['max_abs_err']:.3e} "
        f"h_end_err={row['h_end_max_abs_err']:.3e}")
    return row


def hymba_model_phase(torch, cfg, params, kernels: dict) -> dict:
    """Kernel vs plain at model level, full width: prefill 4 prompts of
    1536 tokens (past the 1024 window: SWA masking in prefill and the
    rolled cache in decode), then 8 decode steps, three ways: the kernel
    path; the plain path (decode_kernel=False, and prefill attention and
    scan patched to their plain versions here); the fp32 model (params
    cast to fp32) on the plain path.  All are fed the fp32 model's greedy
    tokens.  Tolerance, as for Llama (PERF.md): max|dlogits| of kernel vs
    plain <= max|dlogits| of plain bf16 vs fp32, prefill logits
    included."""
    import functools

    import repro_torch.models.attention as attn_models
    import repro_torch.models.ssm as ssm_models
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model

    b, s = 4, HYMBA_CHECK_LEN
    kern = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, decode_kernel=False))
    m32 = build_model(dataclasses.replace(cfg, decode_kernel=False,
                                          dtype="float32"))
    prompts = hymba_inputs(torch, cfg, b, s, seed=1)
    pos0 = torch.full((b,), s, dtype=torch.int32, device="cuda")

    def run(model, p, feed=None):
        logits, cache = model.prefill(p, {"tokens": prompts},
                                      HYMBA_MAX_LEN)
        outs, toks, pos = [logits.float()], [], pos0
        for t in range(8):
            tok = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[t])
            toks.append(tok)
            logits, cache = model.decode(p, cache, tok[:, None], pos)
            outs.append(logits.float())
            pos = pos + 1
        return outs, toks

    real = (attn_models.flash_attention_op, ssm_models.selective_scan_op)
    attn_models.flash_attention_op = functools.partial(real[0], impl="ref")
    ssm_models.selective_scan_op = functools.partial(real[1], impl="ref")
    try:
        zero_counts(kernels)
        p32 = tree_map(lambda t: t.float(), params)
        want32, feed = run(m32, p32)
        del p32
        got_p, _ = run(plain, params, feed)
        plain_launches = read_counts(kernels)
    finally:
        attn_models.flash_attention_op, ssm_models.selective_scan_op = real
    assert not any(plain_launches.values()), (
        f"the plain path launched kernels: {plain_launches}")
    zero_counts(kernels)
    got_k, _ = run(kern, params, feed)
    launches = read_counts(kernels)
    assert launches["flash_attention"] == cfg.num_layers, launches
    assert launches["flash_attention_fp32"] == 0, launches
    assert launches["selective_scan"] == cfg.num_layers, launches
    assert launches["decode_attention"] == 8 * cfg.num_layers, launches
    assert launches["decode_attention_tc"] == 8 * cfg.num_layers, launches
    d = max(float((a - c).abs().max()) for a, c in zip(got_k, got_p))
    d_plain = max(float((a - c).abs().max()) for a, c in zip(got_p, want32))
    d_kernel = max(float((a - c).abs().max()) for a, c in zip(got_k, want32))
    agree = sum(int((a.argmax(-1) == c.argmax(-1)).sum())
                for a, c in zip(got_k, got_p))
    scale = max(float(a.abs().max()) for a in got_p)
    log(f"model check hymba-1.5b full width, {b} prompts x {s}, 8 decode "
        f"steps: max|dlogits| kernel vs plain = {d:.6f} (bound: plain vs "
        f"fp32 = {d_plain:.6f}); kernel vs fp32 = {d_kernel:.6f}; "
        f"max|logits| {scale:.4f}; greedy agree {agree}/{9 * b}; "
        f"kernel-path launches {launches}, plain-path launches "
        f"{plain_launches}")
    assert all(bool(torch.isfinite(a).all()) for a in got_k + got_p)
    assert d <= d_plain, (f"the kernel path differs from the plain path by "
                          f"{d}, more than the plain bf16 path's own error "
                          f"{d_plain} against fp32")
    return {"max_abs_dlogits": d, "plain_vs_fp32": d_plain,
            "kernel_vs_fp32": d_kernel, "greedy_agree": agree,
            "kernel_launches": launches}


def hymba_trace(torch, cfg, params) -> dict:
    """Where Hymba's time goes: one refill prefill (B=1, 2048 tokens) and
    one decode step at B=8 over a 4096-slot cache, each under the
    profiler, kernel path."""
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    out = {}
    prompt = hymba_inputs(torch, cfg, 1, 2048, seed=2)
    model.prefill(params, {"tokens": prompt}, HYMBA_MAX_LEN)   # warm
    _, wall, per = device_trace(torch, lambda: model.prefill(
        params, {"tokens": prompt}, HYMBA_MAX_LEN))
    out["prefill"] = (wall, per)
    prompts = hymba_inputs(torch, cfg, SERVE_BATCH, 512, seed=3)
    _, cache = model.prefill(params, {"tokens": prompts}, HYMBA_MAX_LEN)
    tok = prompts[:, -1:]
    pos = torch.full((SERVE_BATCH,), 512, dtype=torch.int32, device="cuda")
    model.decode(params, cache, tok, pos)                        # warm
    _, wall, per = device_trace(torch, lambda: model.decode(
        params, cache, tok, pos + 1))
    out["decode"] = (wall, per)
    res = {}
    shape = {"prefill": "B=1, S=2048", "decode": "step, B=8, S=513"}
    for what, (wall, per) in out.items():
        parts = breakdown(per)
        assert what != "decode" or parts["decode_attention"] > 0, (
            f"the hymba decode step launched decode_attention but no traced "
            f"kernel matched {DECODE_ATTN_KERNELS!r}: {sorted(per)}")
        busy = sum(parts.values())
        res[what] = {"wall_us": wall * 1e6, "busy_us": busy,
                     "busy_share": busy / (wall * 1e6), "device_us": parts}
        log(f"trace of one hymba {what} ({shape[what]}, 4096-slot cache, "
            f"kernel path, profiler on): wall_us={wall * 1e6:.3f} "
            f"device_busy_us={busy:.3f} device_busy_share="
            f"{busy / (wall * 1e6):.6f} "
            + " ".join(f"{k}_us={v:.3f}" for k, v in parts.items()))
    return res


def hymba_serving_phase(torch, core, cfg, params, kernels: dict) -> dict:
    """The Hymba serving path at full width: 16 greedy requests whose
    prompt lengths are drawn from 512/1280/2048 into a 4096-slot cache
    (1024-slot rolling caches on the sliding-window layers).
    flash_attention and selective_scan run once per layer in each prefill,
    decode_attention once per layer in each decode step."""
    rng = np.random.default_rng(0)
    lens = rng.choice(HYMBA_PROMPT_LENS, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    res = serve(torch, core, cfg, params, prompts, kernels,
                max_len=HYMBA_MAX_LEN, memory_gb=8)
    st, launches = res["stats"], res["launches"]
    prefills = st["waves"] + st["refills"]
    assert launches["flash_attention"] == cfg.num_layers * prefills, (
        launches, st)
    assert launches["selective_scan"] == cfg.num_layers * prefills, (
        launches, st)
    assert launches["decode_attention"] == (
        cfg.num_layers * st["decode_steps"]), (launches, st)
    assert launches["decode_attention_tc"] == launches["decode_attention"], (
        launches)
    assert launches["flash_attention_fp32"] == 0, launches   # bf16 model
    res["prompt_lens"] = [int(n) for n in lens]
    log(serve_line("hymba-1.5b", cfg, res) + f"; prompt lengths "
        f"{res['prompt_lens']}")
    return res


def main() -> int:
    import torch

    from repro_torch.core import (DataUnit, PilotComputeDescription,
                                  PilotComputeService, kmeans, make_backend)
    import repro_torch.core as core
    from repro_torch.core.analytics import PAPER_SCENARIOS, make_blobs
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import \
        decode_attention as attn_mod
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import \
        flash_attention as flash_mod
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.kmeans import kmeans as kernel_mod
    from repro_torch.kernels.kmeans.ops import kmeans_assign_op
    from repro_torch.kernels.selective_scan import \
        selective_scan as scan_mod
    from repro_torch.kernels.selective_scan.ops import selective_scan_op
    from repro_torch.models.model import build_model

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
    builds = (kernel_mod.build, attn_mod.build, flash_mod.build_tc,
              flash_mod.build, scan_mod.build)
    loads = (kernel_mod.load, attn_mod.load, flash_mod.load_tc,
             flash_mod.load, scan_mod.load)
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source
        list(pool.map(lambda build: build(), builds))
    for load in loads:
        load()
    log(f"build: kmeans_assign from {SOURCE}, decode_attention from "
        f"{ATTN_SOURCE}, flash_attention from {FLASH_SOURCE} (bf16) and "
        f"{FLASH_FP32_SOURCE} (fp32), selective_scan from {SCAN_SOURCE} in "
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

    # -- 4. decode_attention vs its plain version on the card ---------------
    attn_shapes = [
        ("serving fill 0.25", 8, 1024, 32, 8, 64, bf16, 0, {"fill": 0.25}),
        ("serving fill 1.0", 8, 1024, 32, 8, 64, bf16, 0, {"fill": 1.0}),
        ("hymba decode, window", 8, 1024, 25, 5, 64, bf16, 1024,
         {"first": 2048}),
        ("hymba decode, global", 8, 4096, 25, 5, 64, bf16, 0, {"fill": 0.5}),
        ("rolling window", 8, 256, 32, 8, 64, bf16, 256, {"first": 1000}),
        ("ragged G=2", 3, 1000, 6, 3, 32, f32, 0, {"fill": 1.0}),
        ("G=1", 2, 512, 8, 8, 64, f32, 0, {"fill": 1.0}),
        ("long row", 1, 32768, 32, 8, 64, bf16, 0, {"fill": 1.0})]
    attn_rows = [check_attention(torch, decode_attention_op,
                                 decode_attention_ref, name, b, sc, nq, nkv,
                                 h, dt, window=w, **kind)
                 for name, b, sc, nq, nkv, h, dt, w, kind in attn_shapes]
    empty_err = check_empty_slots(torch, decode_attention_op,
                                  decode_attention_ref)

    # -- 5. flash_attention and selective_scan vs their plain versions -------
    flash_shapes = [
        ("hymba refill, window", 1, 2048, 25, 5, 64, bf16, 1024),
        ("hymba refill, global", 1, 2048, 25, 5, 64, bf16, 0),
        ("hymba wave, window", 8, 512, 25, 5, 64, bf16, 1024),
        ("llama wave", 8, 128, 32, 8, 64, bf16, 0),
        ("ragged G=2", 3, 1000, 6, 3, 32, f32, 0)]
    flash_rows = [check_flash(torch, flash_attention_op, *shape)
                  for shape in flash_shapes]
    # the tensor-core kernel's other widths and edges, checked untimed
    flash_rows += [check_flash(torch, flash_attention_op, *shape, timed=False)
                   for shape in (
        ("starcoder2 H=128 G=9", 2, 384, 36, 4, 128, bf16, 0),
        ("H=32", 2, 256, 8, 2, 32, bf16, 0),
        ("ragged, window 100", 2, 1000, 6, 3, 64, bf16, 100),
        ("G=1", 2, 300, 8, 8, 64, bf16, 0),
        ("non-causal", 2, 200, 4, 2, 64, bf16, 0, False),
        ("Sq=1", 4, 1, 8, 2, 64, bf16, 0),
        ("H=20 rows of 40 bytes", 2, 200, 4, 4, 20, bf16, 0, False))]
    scan_shapes = [("hymba refill", 1, 2048, 3200, 16, bf16),
                   ("hymba wave", 8, 512, 3200, 16, bf16),
                   ("ragged, h0", 2, 1000, 96, 4, f32, True)]
    scan_rows = [check_scan(torch, selective_scan_op, *shape)
                 for shape in scan_shapes]

    # -- 6. the serving path: Llama-3.2-1B at full width ----------------------
    cfg = get_config("llama3_2_1b")
    assert cfg.decode_kernel, "the port's config must decode with the kernel"
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"params: {cfg.name} {cfg.num_params()} parameters drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    model_row = model_phase(torch, cfg, params)
    llama_kernels = {"decode_attention": (attn_mod, "LAUNCHES"),
                     "decode_attention_tc": (attn_mod, "TC_LAUNCHES"),
                     "flash_attention": (flash_mod, "TC_LAUNCHES"),
                     "flash_attention_fp32": (flash_mod, "LAUNCHES")}
    lserve = serving_phase(torch, core, cfg, params, llama_kernels)
    del params
    torch.cuda.empty_cache()

    # -- 7. the serving path: Hymba-1.5B at full width ------------------------
    hcfg = get_config("hymba_1_5b")
    t0 = time.perf_counter()
    hparams = build_model(hcfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"params: {hcfg.name} {hcfg.num_params()} parameters drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    hymba_kernels = {"flash_attention": (flash_mod, "TC_LAUNCHES"),
                     "flash_attention_fp32": (flash_mod, "LAUNCHES"),
                     "selective_scan": (scan_mod, "LAUNCHES"),
                     "decode_attention": (attn_mod, "LAUNCHES"),
                     "decode_attention_tc": (attn_mod, "TC_LAUNCHES")}
    hymba_row = hymba_model_phase(torch, hcfg, hparams, hymba_kernels)
    hymba_steps = hymba_trace(torch, hcfg, hparams)
    hserve = hymba_serving_phase(torch, core, hcfg, hparams, hymba_kernels)

    # -- 8. the kernels line -----------------------------------------------
    head = rows[len(rows) - len(PAPER_SCENARIOS)]      # scenario i partition
    ahead = attn_rows[1]                                # the serving shape
    fhead, shead = flash_rows[0], scan_rows[0]          # the hymba refill
    served = lambda res: {k: res["stats"][k] for k in (
        "completed", "tokens_served", "decode_steps", "refills", "waves",
        "p50_latency_s", "p99_latency_s")} | {
        "wall_s": res["wall_s"], "setup_s": res["setup_s"]}
    by_path = lambda name: {"llama3_2_1b serving": lserve["launches"].get(
        name, 0), "hymba_1_5b serving": hserve["launches"].get(name, 0)}
    log(card)
    log(json.dumps({"kernels": [{
        "name": "kmeans_assign", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches_total, "checked": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_us"] / 1e3, "bound_by": head["bound_by"],
        "library_ms": None, "shapes": rows}, {
        "name": "decode_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES,
        "launches": sum(by_path("decode_attention").values()),
        "launches_by_path": by_path("decode_attention"), "checked": True,
        "tc_launches": sum(by_path("decode_attention_tc").values()),
        "max_abs_err": max([r["max_abs_err"] for r in attn_rows]
                           + [empty_err]),
        "ms": ahead["kernel_ms"], "plain_ms": ahead["plain_ms"],
        "bound_ms": ahead["bound_us"] / 1e3, "bound_by": ahead["bound_by"],
        "library_ms": ahead["library_ms"], "shapes": attn_rows,
        "model_check": model_row, "serving": served(lserve)}, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": sum(by_path("flash_attention").values()),
        "launches_by_path": by_path("flash_attention"), "checked": True,
        "fp32_source": FLASH_FP32_SOURCE,
        "fp32_launches": sum(by_path("flash_attention_fp32").values()),
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": fhead["kernel_ms"], "plain_ms": fhead["plain_ms"],
        "bound_ms": fhead["bound_us"] / 1e3, "bound_by": fhead["bound_by"],
        "library_ms": fhead["library_ms"], "shapes": flash_rows,
        "model_check": hymba_row, "traces": hymba_steps,
        "serving": served(hserve)}, {
        "name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES,
        "launches": hserve["launches"]["selective_scan"],
        "launches_by_path": by_path("selective_scan"), "checked": True,
        "max_abs_err": max(r["max_abs_err"] for r in scan_rows),
        "ms": shead["kernel_ms"], "plain_ms": shead["plain_ms"],
        "bound_ms": shead["bound_us"] / 1e3, "bound_by": shead["bound_by"],
        "library_ms": None, "shapes": scan_rows}]}))
    # -- 9. the last line ---------------------------------------------------
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
