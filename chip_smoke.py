#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA card (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, started together), holds each against its plain
PyTorch version on the card, then drives the port's two paths, each with
its kernel's launch count set to 0 just before and read just after:

- KMeans: the paper's KMeans over points retained in pilot device memory
  (PilotSession -> add_pilots -> data -> replicate_to_pilot -> kmeans) at
  the paper's three scenario sizes, checked against the same run on the
  CPU (kernel kmeans_assign);
- serving: Llama-3.2-1B at its published widths (random weights from a
  seed) served by ServingEngine on a PilotSession pilot, 16 requests at
  batch 8 (kernel decode_attention), after a model-level check of the
  kernel decode path against the plain one and an fp32 run.

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
PARTS, ITERS, D = 8, 5, 8
# the serving phase: Llama-3.2-1B, batch 8, 1024-slot cache, 16 requests
SERVE_BATCH, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_GEN = 8, 1024, 16, 64
PROMPT_LENS = (96, 128, 160)


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


def attention_bound(b: int, sc: int, nq: int, nkv: int, h: int, esize: int):
    """Least time for decode attention on an H100 SXM (s) and what bounds
    it: K and V read once, q read and the output written once, cache_pos
    and positions read once; 4*B*Nq*Sc*H fp32 FLOP (the two products)."""
    nbytes = (2 * b * sc * nkv * h * esize + 2 * b * nq * h * esize
              + 4 * b * sc + 4 * b)
    flops = 4.0 * b * nq * sc * h
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
    args = attention_inputs(torch, b, sc, nq, nkv, h, dtype, **kind)
    got = op(*args, window=window, impl="cuda")
    torch.cuda.synchronize()
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
    b_s, b_by = attention_bound(b, sc, nq, nkv, h, esize)
    row = {"shape": name, "b": b, "sc": sc, "nq": nq, "nkv": nkv, "h": h,
           "window": window, "dtype": str(dtype).split(".")[-1],
           "kernel_ms": ms, "kernel_eager_ms": eager, "plain_ms": plain,
           "library_ms": library, "bound_us": b_s * 1e6, "bound_by": b_by,
           "max_abs_err": float(err.max()), "library_max_abs_err": lib_err}
    log(f"decode_attention check {name} B={b} Sc={sc} {nq}/{nkv} H={h} "
        f"{row['dtype']} window={window}: kernel_ms={ms:.6f} "
        f"kernel_eager_ms={eager:.6f} plain_ms={plain:.6f} "
        f"sdpa_ms={library:.6f} bound_us={b_s * 1e6:.4f} ({b_by}) "
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


def step_breakdown(per: dict) -> dict:
    """Device us of one decode step by kind: the decode_attention kernel's
    two launches, GEMMs (cuBLAS/cuBLASLt names), everything else."""
    out = {"decode_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for name, us in per.items():
        if re.search(r"split_kernel|combine_kernel", name):
            out["decode_attention"] += us
        elif re.search(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitK", name,
                       re.I):
            out["gemm"] += us
        else:
            out["other"] += us
    return out


def model_phase(torch, cfg, params) -> dict:
    """Kernel vs plain at model level, full width: prefill 8 prompts of 128
    tokens, then 8 decode steps with decode_kernel=True, with
    decode_kernel=False and with the fp32 model (params cast to fp32), all
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
    parts = step_breakdown(per)
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


def serving_phase(torch, core, cfg, params, attn_mod) -> dict:
    """The serving path at full width: ServingEngine on a one-pilot
    PilotSession on the card, 16 greedy requests.  Returns the engine's
    stats, the kernel launches of the run and the host measurements."""
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
    rng = np.random.default_rng(0)
    lens = itertools.islice(itertools.cycle(PROMPT_LENS), SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    with core.PilotSession() as s:
        (pilot,) = s.add_pilots(1, memory_gb=4)
        with ServingEngine(s, model, params=params, batch_size=SERVE_BATCH,
                           max_len=SERVE_MAX_LEN, page_tokens=16) as eng:
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
            attn_mod.LAUNCHES = 0
            t0 = time.perf_counter()
            reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
            eng.drain(timeout=600)
            wall = time.perf_counter() - t0
            launches = attn_mod.LAUNCHES
            outs = [r.result(timeout=10) for r in reqs]
            st = eng.stats()
    steps = st["decode_steps"]
    assert st["completed"] == SERVE_REQUESTS, st
    assert all(len(o) == SERVE_GEN for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert st["tokens_served"] == SERVE_REQUESTS * SERVE_GEN, st
    assert st["refills"] >= SERVE_BATCH, st
    assert launches == cfg.num_layers * steps, (
        f"decode_attention launched {launches} times in {steps} decode "
        f"steps of {cfg.num_layers} layers")
    assert seen == {"cuda"}, f"runtime params/cache on {seen}"
    log(f"serving llama3.2-1b full width on 1 pilot: "
        f"{st['completed']}/{SERVE_REQUESTS} requests, "
        f"{st['tokens_served']} tokens in {wall:.6f} s "
        f"({st['tokens_served'] / wall:.3f} tok/s), {steps} decode steps "
        f"({wall / steps * 1e3:.4f} ms per step, refills included), "
        f"refills={st['refills']} waves={st['waves']} "
        f"p50_latency_s={st['p50_latency_s']:.6f} "
        f"p99_latency_s={st['p99_latency_s']:.6f} "
        f"decode_attention launches={launches} (= {cfg.num_layers} x "
        f"{steps}); params+cache on {sorted(seen)}; deploy+load "
        f"{setup:.3f} s")
    return {"stats": st, "wall_s": wall, "launches": launches,
            "setup_s": setup}


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
    from repro_torch.kernels.kmeans import kmeans as kernel_mod
    from repro_torch.kernels.kmeans.ops import kmeans_assign_op
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
    with ThreadPoolExecutor(2) as pool:         # one nvcc per source at once
        list(pool.map(lambda mod: mod.build(), (kernel_mod, attn_mod)))
    kernel_mod.load()
    attn_mod.load()
    log(f"build: kmeans_assign from {SOURCE} and decode_attention from "
        f"{ATTN_SOURCE} in {time.perf_counter() - t0:.3f} s")

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

    # -- 5. the serving path: Llama-3.2-1B at full width ----------------------
    cfg = dataclasses.replace(get_config("llama3_2_1b"), decode_kernel=True)
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"params: {cfg.name} {cfg.num_params()} parameters drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    model_row = model_phase(torch, cfg, params)
    serve = serving_phase(torch, core, cfg, params, attn_mod)

    # -- 6. the kernels line -----------------------------------------------
    head = rows[len(rows) - len(PAPER_SCENARIOS)]      # scenario i partition
    ahead = attn_rows[1]                                # the serving shape
    log(card)
    log(json.dumps({"kernels": [{
        "name": "kmeans_assign", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches_total, "checked": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_us"] / 1e3, "bound_by": head["bound_by"],
        "library_ms": None, "shapes": rows}, {
        "name": "decode_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": serve["launches"],
        "checked": True,
        "max_abs_err": max([r["max_abs_err"] for r in attn_rows]
                           + [empty_err]),
        "ms": ahead["kernel_ms"], "plain_ms": ahead["plain_ms"],
        "bound_ms": ahead["bound_us"] / 1e3, "bound_by": ahead["bound_by"],
        "library_ms": ahead["library_ms"], "shapes": attn_rows,
        "model_check": model_row,
        "serving": {k: serve["stats"][k] for k in (
            "completed", "tokens_served", "decode_steps", "refills",
            "p50_latency_s", "p99_latency_s")} | {
            "wall_s": serve["wall_s"], "setup_s": serve["setup_s"]}}]}))
    # -- 7. the last line ---------------------------------------------------
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
