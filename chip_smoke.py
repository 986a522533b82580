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
- KMeans elastic: scenario (i) over the device tiers of three simulated
  slurm pilots (two replicas a partition) in a supervised, rebalancing
  session; the second pilot's node is lost after iteration 1 (its device
  memory freed), the supervisor respawns it and restores the replication,
  a pilot added by hand gives the rebalancer skew to move; held to an
  undisturbed run of the same seed; then one pilot on each simulated
  substrate for the paper's Fig. 6 provisioning ratios;
- the decode step as one CUDA graph (``models/decode_graphs.py``) against
  the eager step: StarCoder2-7B and Falcon-Mamba-7B at their published
  widths, 2 layers, 8 rows, 64 greedy steps with a ``splice_row`` refill
  at step 20; the tokens identical, the last logits and every cache and
  state leaf bit-equal, 1 capture and 63 replays, the launch counts of
  both runs equal, the graph's kernels seen by the profiler; every
  one-card serving phase below then decodes through the graph (one
  capture a replica, a replay every other step), the (1, 1) pilot mesh's
  eagerly;
- serving Llama-3.2-1B at its published widths (random weights from a
  seed) by ServingEngine on a PilotSession pilot, 16 requests at batch 8
  (kernels flash_attention in each prefill, on the tensor cores since the
  model runs bf16, decode_attention in each decode step), after a
  model-level check of the kernel decode path against the plain one and
  an fp32 run;
- serving Llama-3.2-1B over a one-rank (1, 1) NCCL pilot mesh (the
  multi-device pilot's path: a DeviceMesh over the process group, the
  engine's rank-0 admission broadcasts, prefill and decode under the
  sharding context of the mesh's model sub-mesh; a batch dim of 1 splits
  no rows), token for token the tokens of the serving phase above on the
  same params;
- serving Llama-3.2-1B elastically: a burst of 32 requests on one pilot
  of a supervised, autoscaled session (at most 3 pilots on the card); the
  autoscaler scales out on the queue wait, the engine adopts each new
  pilot as a replica, and the first replica is scaled in by hand while it
  holds rows: its requests are handed off and re-prefilled on the
  survivors (flash_attention), each held to the same request on one
  undisturbed replica up to the handoff;
- serving Hymba-1.5B at its published widths (32 layers of parallel
  attention and Mamba heads, sliding window 1024 but for 3 global layers)
  the same way, 16 requests of 512-2048 prompt tokens at batch 8 (kernels
  flash_attention and selective_scan in each prefill, decode_attention in
  each decode step), after a model-level check of the kernel path against
  the plain path and an fp32 run on prompts longer than the window;
- serving InternVL2-2B (vision) at full size and Mixtral-8x22B (MoE) at
  its published widths, 8 of its 56 layers, the same way;
- a (1, 4) rank's share (before Mixtral's serving): Mixtral's MoE FFN
  (a prefill wave of 8 x 512, 2 of 8 experts a rank) and DeepSeek-V3's
  MLA (a prefill of 8 x 512 and a decode step, 32 of 128 heads a rank)
  at their published widths, one layer, each of the four model ranks run
  in turn on this card over a one-rank NCCL group (``RankView``); the
  four partial sums held to the whole layer's output in fp32 (1e-5 of
  its largest magnitude), reported in bf16, with each rank's device ms
  against the whole layer's; no kernel (cuBLAS products);
- serving Whisper-base (enc-dec) at full size: flash_attention non-causal
  in the encoder (1500 frames) and in cross attention (the prompt, then
  each decode token, against the 1500 frames), causal in the decoder's
  prefill, decode_attention at one query head per kv head in each decode
  step, after a model-level check on frames from a seed;
- serving Falcon-Mamba-7B (the SSM family: 64 Mamba-1 layers, no
  attention) at its published widths and full depth, 16 requests of
  512-2048 prompt tokens (kernel selective_scan in every layer of each
  prefill, on the chunked route at a one-row refill and in one pass at
  the batch-8 wave; the decode step's recurrence is PyTorch), after a
  model-level check at 4 of its layers;
- serving StarCoder2-7B (GQA at 36/4: 9 query heads a kv head, two head
  groups of decode_attention's blocks) at its published widths and full
  depth, 16 requests of 1024-4096 prompt tokens into 8192 slots, after a
  model-level check at 4 of its 32 layers;
- serving DeepSeek-V3 (MLA + MoE) at its published widths, 5 of its 61
  layers, last: its path runs none of the port's kernels (MLA and the
  experts are PyTorch products, as the JAX package runs them in jnp); its
  model check holds the bf16 logits to an fp32 run and the absorbed decode
  to the expanded prefill.
- training Llama-3.2-1B at its published config (after the Llama
  serving phase, its memory freed before Hymba's): 30 steps of 8 x 1024
  tokens through ``launch.train.run`` (the training CLI's body: a pilot,
  one compute unit per step, bf16 params, fp32 AdamW, remat "full"),
  after 3 steps of reduced(llama3_2_1b) in fp32 held card against CPU and
  the first full-width step held bf16 against fp32; its median step,
  tokens per second, model-FLOP share, peak memory, a traced step's
  forward/backward/optimizer split, its checkpoint (bytes, write seconds,
  a bit-for-bit restore), the 100m preset's failure recovery and options,
  and the training scan's time.  Training launches none of the four
  kernels (they are forward-only, and the JAX package trains through none
  of its Pallas kernels): each count is 0, and is asserted so.
- sharded training (after training): the same Llama-3.2-1B run through
  ``launch.train.run`` under a one-rank NCCL process group, so over a
  ("data", "model") mesh of (1, 1): the state as DTensors placed by the
  logical-axis rules, the sharded step (gather, the same forward and
  backward, reduce-scatter, AdamW on the shards); its losses and grad
  norms held bit for bit to the unsharded run's, its ms per step and
  peak memory beside that run's, its gathered checkpoint restored through
  ``restore(shardings=)`` bit for bit, and ``compressed_pod_mean`` run on
  a step's gradients over a pod axis of 1 (relative error under 0.02,
  nonzero residual); no kernel, each count asserted 0; the group is
  destroyed before the next phase.
- the dry-run (after sharded training): ``launch.dryrun`` plans the
  sharded training cell on fake tensors over a fake one-rank group in a
  CPU subprocess; its roofline time must not exceed the measured median
  step and its planned peak must lie within 25% of the measured peak;
  ``roofline.analysis.HBM_PER_CHIP`` must equal the card's total memory.
  No kernel.
- resilient training: the 100m preset's train step through
  ``runtime.fault_tolerance.ResilientRunner``, 12 steps on a simulated
  pilot lost after 7 (one recovery from the step-4 checkpoint), held to
  an uninterrupted run; no kernel.
- the ported examples (last): each ``examples/torch/*.py`` at its
  defaults on the card, in a process of its own, all started together;
  each must exit 0 having printed its closing line.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, without CUDA or outside a checkout of the
repository.  It imports nothing of JAX or of the JAX package.

Output: progress lines, then the card's name and power limit, a
``{"rank_split": {...}}`` line, an ``{"examples": {...}}`` line, a
``{"decode_graphs": {...}}`` line, a
``{"training": {...}}`` line, an
``{"elastic": {...}}`` line, a ``{"kernels": [...]}`` line, and as the
last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100's peaks and the kernels' bounds, shared with the dry-run
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_PER_CHIP, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_EXP_PER_S,
    attention_bound, flash_bound, kmeans_bound, scan_bound, train_flops)

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
PARTS, ITERS, D = 8, 5, 8
# the serving phase: Llama-3.2-1B, batch 8, 1024-slot cache, 16 requests
SERVE_BATCH, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_GEN = 8, 1024, 16, 64
PROMPT_LENS = (96, 128, 160)
# the Hymba phases: 4 prompts of 1536 (past the 1024 window) for the model
# check; 16 requests of 512/1280/2048 tokens into a 4096-slot cache
HYMBA_CHECK_LEN, HYMBA_MAX_LEN = 1536, 4096
HYMBA_PROMPT_LENS = (512, 1280, 2048)
# the InternVL2-2B phases: 16 requests of 128/256/384 text tokens after the
# 256 vision tokens, into 1024 slots
VLM_MAX_LEN, VLM_PROMPT_LENS = 1024, (128, 256, 384)
# the Mixtral-8x22B phases, at its published widths: the model check at 2
# of its 56 layers on 2 prompts of 4608 (past the 4096 window), serving at
# 8 layers (40.9 GB of bf16), 16 requests of 1024/2048/4608 tokens into a
# 4096-slot rolling cache (max_len 8192)
MIXTRAL_CHECK_LAYERS, MIXTRAL_LAYERS = 2, 8
MIXTRAL_CHECK_LEN, MIXTRAL_MAX_LEN = 4608, 8192
MIXTRAL_PROMPT_LENS = (1024, 2048, 4608)
# the Whisper-base phases, at full size: 16 requests of 4/16/64 prompt
# tokens (a few task tokens) into its 448-token text context
WHISPER_MAX_LEN, WHISPER_PROMPT_LENS = 448, (4, 16, 64)
# the DeepSeek-V3 phases, at its published widths: the model check at its
# 3 leading (dense) layers, serving at 5 of its 61 layers (3 dense + 2
# MoE), 16 requests of 256/512/1024 tokens into 2048 slots
DEEPSEEK_CHECK_LAYERS, DEEPSEEK_LAYERS = 3, 5
DEEPSEEK_MAX_LEN, DEEPSEEK_PROMPT_LENS = 2048, (256, 512, 1024)
# the Falcon-Mamba-7B phases (the SSM family), at its published widths: the
# model check at 4 of its 64 layers on 4 prompts of 1024, serving all 64
# layers (14.54 GB of bf16), 16 requests of 512/1024/2048 tokens
# (max_len 4096; the cache is each layer's conv history and state)
FALCON_CHECK_LAYERS, FALCON_CHECK_LEN, FALCON_MAX_LEN = 4, 1024, 4096
FALCON_PROMPT_LENS = (512, 1024, 2048)
# the StarCoder2-7B phases (36/4 heads of 128: G = 9), at its published
# widths: the model check at 4 of its 32 layers on 8 prompts of 1024,
# serving all 32 layers (14.80 GB of bf16), 16 requests of 1024/2048/4096
# tokens into 8192 slots (a 4.3 GB cache at batch 8)
STARCODER_CHECK_LAYERS, STARCODER_CHECK_LEN = 4, 1024
STARCODER_MAX_LEN, STARCODER_PROMPT_LENS = 8192, (1024, 2048, 4096)
# the decode step as one CUDA graph against the eager step: StarCoder2-7B
# and Falcon-Mamba-7B at their published widths, 2 layers each, 8 rows of
# 512-token prompts, 64 greedy steps, row 3 refilled at step 20 with a
# 300-token prompt (``splice_row``), 1024 slots
GRAPH_CHECK_LAYERS, GRAPH_CHECK_STEPS, GRAPH_CHECK_REFILL = 2, 64, 20
GRAPH_CHECK_LEN, GRAPH_CHECK_REFILL_LEN, GRAPH_CHECK_MAX_LEN = 512, 300, 1024


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def device_trace(torch, fn, retries: int = 0):
    """Run fn() under torch.profiler (CUDA activity only).  Returns fn's
    result, the host wall seconds, and the device microseconds summed per
    kernel (or copy) name.  A trace that holds no device event is taken
    again up to `retries` times: only for an fn that may run twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(retries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
        if per:
            break
        if attempt < retries:
            log(f"device trace held no device event; tracing again "
                f"({attempt + 1} of {retries})")
    return out, wall, per


def profiler_ready(torch, tries: int = 5) -> int:
    """Trace a few small kernels until the profiler delivers device
    events, before any trace is read: a process's first profiler session
    may come back with none while CUPTI starts.  Returns the sessions it
    took; raises if none of `tries` held a device event."""
    x = torch.ones(1 << 20, device="cuda")
    for attempt in range(1, tries + 1):
        _, _, per = device_trace(torch, lambda: [x.mul_(1.0)
                                                 for _ in range(8)])
        if per:
            return attempt
    raise RuntimeError(f"the profiler recorded no device event in "
                       f"{tries} sessions")


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
                                             for _ in range(5)], retries=2)
    stages = kernel_stages(per, 5)
    assert set(stages) == set(KMEANS_STAGES), per
    b_s, b_by = kmeans_bound(n, k, d, x.element_size())
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
    pos = torch.full((len(feed[0]),), first_pos, dtype=torch.int32,
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


def model_batch(torch, cfg, tokens) -> dict:
    """A prefill batch: the tokens, and for a vision config the zero patch
    embeddings the serving engine feeds (the ViT is a stub)."""
    batch = {"tokens": tokens}
    if cfg.vision_tokens:
        batch["patch_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.vision_tokens, cfg.vision_embed_dim),
            dtype=torch.float32, device=tokens.device)
    return batch


def spec_bytes(cfg):
    """(parameters, bytes) of a config's parameter tree, counted from its
    ParamSpecs (the MTP module included; ``cfg.num_params`` counts the
    dense layers of an MoE config at the expert width)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_specs
    specs = tree_leaves(model_specs(cfg))
    n = [math.prod(sp.shape) for sp in specs]
    return sum(n), sum(k * sp.dtype.itemsize for k, sp in zip(n, specs))


def kernel_kind(name: str) -> str:
    """The kind of a traced kernel, by name: the attention and scan
    kernels, GEMMs (cuBLAS/cuBLASLt names), everything else."""
    if re.search(r"flash_tc_kernel|flash_kernel", name):
        return "flash_attention"
    if "scan_chunk_kernel" in name:
        return "selective_scan"
    if re.search(DECODE_ATTN_KERNELS, name):
        return "decode_attention"
    if re.search(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitK", name, re.I):
        return "gemm"
    return "other"


def breakdown(per: dict) -> dict:
    """Device us of a traced prefill or decode step by kernel kind."""
    out = {"flash_attention": 0.0, "selective_scan": 0.0,
           "decode_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for name, us in per.items():
        out[kernel_kind(name)] += us
    return out


def decode_graph_phase(torch, kernels: dict) -> dict:
    """The decode step as one CUDA graph against the eager step
    (``decode_graphs.step``) on the card, for StarCoder2-7B (GQA at 36/4,
    decode_attention) and Falcon-Mamba-7B (the conv and state updates,
    which are not idempotent) at their published widths and
    GRAPH_CHECK_LAYERS layers: a wave of 8 prompts, GRAPH_CHECK_STEPS
    greedy steps, row 3 refilled at step GRAPH_CHECK_REFILL by
    ``splice_row`` as the engine does.  The graph run must give the eager
    run's tokens, its last logits and every cache and state leaf bit for
    bit, count one capture and the other steps as replays, and count the
    eager run's launches; one replay under the profiler must show the
    graph's kernels.  Returns, by model, the ms a step of each run
    (synchronised at the end of the 64) and the counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import splice_row

    out = {}
    for arch in ("starcoder2_7b", "falcon_mamba_7b"):
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=GRAPH_CHECK_LAYERS)
        model = build_model(cfg)
        graphs = model.decode_graphs
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        b, s = SERVE_BATCH, GRAPH_CHECK_LEN
        prompts = hymba_inputs(torch, cfg, b, s, seed=7)
        refill = hymba_inputs(torch, cfg, 1, GRAPH_CHECK_REFILL_LEN, seed=8)

        @torch.inference_mode()     # the engine's loop splices in place
        def run(decode):
            logits, cache = model.prefill(params, {"tokens": prompts},
                                          GRAPH_CHECK_MAX_LEN)
            pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
            toks = []
            zero_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(GRAPH_CHECK_STEPS):
                if t == GRAPH_CHECK_REFILL:
                    row_logits, row_cache = model.prefill(
                        params, {"tokens": refill}, GRAPH_CHECK_MAX_LEN)
                    cache = splice_row(cache, row_cache, 3)
                    logits[3] = row_logits[0]
                    pos[3] = GRAPH_CHECK_REFILL_LEN
                tok = logits.argmax(-1).to(torch.int32)
                toks.append(tok)
                logits, cache = decode(params, cache, tok[:, None], pos)
                pos = pos + 1
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / GRAPH_CHECK_STEPS
            return (torch.stack(toks), logits, cache, read_counts(kernels),
                    ms, (tok, pos))

        e_tok, e_logits, e_cache, e_launch, e_ms, _ = run(graphs.step)
        assert (graphs.captures, graphs.replays) == (0, 0), (
            graphs.captures, graphs.replays)
        g_tok, g_logits, g_cache, g_launch, g_ms, last = run(model.decode)
        counts = (graphs.captures, graphs.replays)
        assert counts == (1, GRAPH_CHECK_STEPS - 1), counts
        assert torch.equal(g_tok, e_tok), (
            f"{arch}: the graph's tokens differ from the eager step's at "
            f"{int((g_tok != e_tok).sum())} of {g_tok.numel()}")
        assert torch.equal(g_logits, e_logits), (
            f"{arch}: last logits differ by "
            f"{float((g_logits.float() - e_logits.float()).abs().max())}")
        leaves = list(zip(tree_leaves(g_cache), tree_leaves(e_cache)))
        bad = [i for i, (a, c) in enumerate(leaves) if not torch.equal(a, c)]
        assert not bad, f"{arch}: cache leaves {bad} of {len(leaves)} differ"
        assert g_launch == e_launch, (g_launch, e_launch)
        # one replay (the cache advances once more) under the profiler
        tok, pos = last
        _, wall, per = device_trace(torch, lambda: model.decode(
            params, g_cache, tok[:, None], pos))
        parts = breakdown(per)
        assert graphs.replays == GRAPH_CHECK_STEPS, graphs.replays
        assert parts["gemm"] > 0, sorted(per)
        if cfg.attention == "gqa":
            assert parts["decode_attention"] > 0, sorted(per)
        out[arch] = {"eager_ms_per_step": e_ms, "graph_ms_per_step": g_ms,
                     "launches": g_launch, "leaves": len(leaves),
                     "replay_wall_us": wall * 1e6,
                     "replay_device_us": sum(parts.values()),
                     "replay_kernels": len(per)}
        log(f"decode graph check {arch} ({cfg.num_layers} layers, published "
            f"widths, B={b}, {GRAPH_CHECK_STEPS} steps, refill at step "
            f"{GRAPH_CHECK_REFILL}): tokens, last logits and {len(leaves)} "
            f"cache leaves bit-equal to the eager step's; 1 capture, "
            f"{GRAPH_CHECK_STEPS - 1} replays; launches {g_launch} both "
            f"runs; ms a step eager {e_ms:.4f} graph {g_ms:.4f}; one traced "
            f"replay: wall_us={wall * 1e6:.3f} device_us="
            f"{sum(parts.values()):.3f} kernels={len(per)}")
        del params, e_cache, g_cache, model, graphs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def model_phase(torch, cfg, params, *, name="llama3.2-1b", b=SERVE_BATCH,
                s=128, max_len=SERVE_MAX_LEN, trace=True) -> dict:
    """Kernel vs plain at model level: prefill `b` prompts of `s` tokens
    (after the zero patch embeddings of a vision config), then 8 decode
    steps with decode_kernel=True (the config's default), with
    decode_kernel=False and with the fp32 model (params cast to fp32), all
    fed the fp32 model's greedy tokens.  Tolerance: the kernel path may lie
    no further from the plain bf16 path than the plain bf16 path lies from
    the fp32 model on the same params and tokens (PERF.md).  With `trace`,
    one decode step of the kernel path under the profiler."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    kern = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, decode_kernel=False))
    m32 = build_model(dataclasses.replace(cfg, decode_kernel=False,
                                          dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    batch = model_batch(torch, cfg, prompts)
    first = s + cfg.vision_tokens            # the first decode position
    l32, c32 = m32.prefill(p32, batch, max_len)
    feed, cur = [], l32
    _, cache_k = kern.prefill(params, batch, max_len)
    cache_p = tree_map(torch.clone, cache_k)
    # the fp32 model's greedy tokens, taught to all three
    want32 = []
    pos = torch.full((b,), first, dtype=torch.int32, device="cuda")
    for _ in range(8):
        tok = cur.argmax(-1).to(torch.int32)
        feed.append(tok)
        cur, c32 = m32.decode(p32, c32, tok[:, None], pos)
        want32.append(cur.float())
        pos = pos + 1
    del p32, c32
    got_k, ms_k = decode_logits(torch, kern, params, cache_k, feed, first)
    got_p, ms_p = decode_logits(torch, plain, params, cache_p, feed, first)
    d = max(float((a - c).abs().max()) for a, c in zip(got_k, got_p))
    d_plain = max(float((a - c).abs().max()) for a, c in zip(got_p, want32))
    d_kernel = max(float((a - c).abs().max()) for a, c in zip(got_k, want32))
    agree = sum(int((a.argmax(-1) == c.argmax(-1)).sum())
                for a, c in zip(got_k, got_p))
    scale = max(float(a.abs().max()) for a in got_p)
    log(f"model check {name}, {b} prompts x {s}"
        + (f" after {cfg.vision_tokens} vision tokens"
           if cfg.vision_tokens else "")
        + f", {cfg.num_layers} layers, 8 decode steps: max|dlogits| kernel "
        f"vs plain = {d:.6f} (bound: plain vs fp32 = {d_plain:.6f}); kernel "
        f"vs fp32 = {d_kernel:.6f}; max|logits| {scale:.4f}; greedy agree "
        f"{agree}/{8 * b}; ms/step kernel {[round(x, 3) for x in ms_k]} "
        f"plain {[round(x, 3) for x in ms_p]}")
    assert all(bool(torch.isfinite(a).all()) for a in got_k + got_p)
    assert d <= d_plain, (f"{name}: kernel decode differs from the plain "
                          f"decode by {d}, more than the plain bf16 path's "
                          f"own error {d_plain} against fp32")
    row = {"max_abs_dlogits": d, "plain_vs_fp32": d_plain,
           "kernel_vs_fp32": d_kernel, "greedy_agree": agree,
           "ms_per_step_kernel": ms_k, "ms_per_step_plain": ms_p}
    if not trace:
        return row
    # one decode step under the profiler: where its device time goes
    pos = torch.full((b,), first + 8, dtype=torch.int32, device="cuda")
    _, wall, per = device_trace(torch, lambda: kern.decode(
        params, cache_k, feed[-1][:, None], pos))
    parts = breakdown(per)
    assert parts["decode_attention"] > 0, (
        f"the decode step launched decode_attention but no traced kernel "
        f"matched {DECODE_ATTN_KERNELS!r}: {sorted(per)}")
    busy = sum(parts.values())
    slots = cache_k["main"]["kv"]["k"].shape[2]
    log(f"trace of one {name} decode step (kernel path, B={b}, Sc={slots}, "
        f"profiler on): wall_us={wall * 1e6:.3f} device_busy_us={busy:.3f} "
        f"device_busy_share={busy / (wall * 1e6):.6f} "
        f"decode_attention_us={parts['decode_attention']:.3f} "
        f"gemm_us={parts['gemm']:.3f} other_us={parts['other']:.3f} "
        f"kernels={len(per)}")
    return row | {"step_us": parts, "step_wall_us": wall * 1e6}


def zero_counts(kernels: dict) -> None:
    """`kernels` maps a name to (kernel module, launch counter attribute)."""
    for mod, attr in kernels.values():
        setattr(mod, attr, 0)


def read_counts(kernels: dict) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernels.items()}


def serve(torch, core, cfg, params, prompts, kernels: dict, *, max_len: int,
          memory_gb: float, after=None, mesh_shape=()):
    """ServingEngine on a one-pilot PilotSession on the card: greedy
    SERVE_GEN tokens for each prompt at batch SERVE_BATCH.  `kernels` maps
    a name to (kernel module, counter): each count is set to 0 just before
    the requests go in and read just after they drained.  With params
    None the engine draws them on the card from its seed (0), so that the
    caller holds no copy of them.  `after(runtime params)`, if given, runs
    once the requests drained, before the session closes.  Returns the
    engine's stats, the launches, the wall seconds, the deploy+load
    seconds, the peak device memory from deploy on, and what `after`
    returned; it checks the device types the runtime's params and cache
    were seen on.  With `mesh_shape`, the pilot's mesh spans the process
    group's ranks (data x model)."""
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
        pilot = s.add_pilot(memory_gb=memory_gb,
                            mesh_axes=("data", "model"),
                            mesh_shape=mesh_shape)
        assert (pilot.mesh is not None) == bool(mesh_shape), pilot.mesh
        with ServingEngine(s, model, params=params, batch_size=SERVE_BATCH,
                           max_len=max_len, page_tokens=16) as eng:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng.deploy()
            # the resident loop rebuilds the params on the card from the
            # pilot's shard replicas first; serve once that is done
            eng.wait_ready(timeout=300)
            setup = time.perf_counter() - t0
            zero_counts(kernels)
            t0 = time.perf_counter()
            reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
            eng.drain(timeout=900)
            wall = time.perf_counter() - t0
            launches = read_counts(kernels)
            outs = [r.result(timeout=10) for r in reqs]
            st = eng.stats()
            peak = torch.cuda.max_memory_allocated()
            extra = (None if after is None else
                     after(pilot._jit_cache[(eng.name, "runtime")].params))
    n = len(prompts)
    assert st["completed"] == n, st
    assert all(len(o) == SERVE_GEN for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert st["tokens_served"] == n * SERVE_GEN, st
    assert st["refills"] >= SERVE_BATCH, st
    assert seen == {"cuda"}, f"runtime params/cache on {seen}"
    graphs = (st["decode_graph_captures"], st["decode_graph_replays"])
    if mesh_shape:      # a pilot mesh decodes eagerly
        assert graphs == (0, 0), graphs
    else:               # a capture a replica's cache, then replays
        assert graphs[0] >= 1 and sum(graphs) == st["decode_steps"], (
            graphs, st)
    return {"stats": st, "wall_s": wall, "launches": launches,
            "setup_s": setup, "peak_bytes": peak, "after": extra,
            "outs": outs}


def serve_line(name, cfg, res, width="full width") -> str:
    st, wall = res["stats"], res["wall_s"]
    steps = st["decode_steps"]
    return (f"serving {name} {width} on 1 pilot: "
            f"{st['completed']} requests, {st['tokens_served']} tokens in "
            f"{wall:.6f} s ({st['tokens_served'] / wall:.3f} tok/s), "
            f"{steps} decode steps ({wall / steps * 1e3:.4f} ms per step, "
            f"refills included), refills={st['refills']} "
            f"waves={st['waves']} p50_latency_s={st['p50_latency_s']:.6f} "
            f"p99_latency_s={st['p99_latency_s']:.6f} launches="
            f"{res['launches']} ({cfg.num_layers} layers); decode graphs "
            f"{st['decode_graph_captures']} captured "
            f"{st['decode_graph_replays']} replayed; params+cache on "
            f"cuda; deploy+load {res['setup_s']:.3f} s; peak device memory "
            f"{res['peak_bytes'] / 1e9:.3f} GB")


def serving_prompts(cfg) -> list:
    """The Llama serving phases' 16 prompts of 96-160 tokens."""
    rng = np.random.default_rng(0)
    lens = itertools.islice(itertools.cycle(PROMPT_LENS), SERVE_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def serving_phase(torch, core, cfg, params, kernels: dict,
                  mesh_shape=()) -> dict:
    """The Llama serving path at full width: 16 greedy requests of 96-160
    prompt tokens into a 1024-slot cache.  flash_attention runs once per
    layer in each prefill (a wave or a refill), decode_attention once per
    layer in each decode step."""
    res = serve(torch, core, cfg, params, serving_prompts(cfg), kernels,
                max_len=SERVE_MAX_LEN, memory_gb=4, mesh_shape=mesh_shape)
    st, launches = res["stats"], res["launches"]
    prefills = st["waves"] + st["refills"]
    assert launches["decode_attention"] == (
        cfg.num_layers * st["decode_steps"]), (launches, st)
    assert launches["decode_attention_tc"] == launches["decode_attention"], (
        launches)                               # bf16: the tensor cores
    assert launches["flash_attention"] == cfg.num_layers * prefills, (
        launches, st)
    assert launches["flash_attention_fp32"] == 0, launches   # bf16 model
    log(serve_line("llama3.2-1b", cfg, res, "full width" + (
        f" over a {mesh_shape} pilot mesh" if mesh_shape else "")))
    return res


def pilot_mesh_serving_phase(torch, core, cfg, params, kernels: dict,
                             unsharded: dict) -> dict:
    """`serving_phase` again over a one-rank (1, 1) NCCL pilot mesh: a
    one-rank process group (tcp://127.0.0.1, a free port), a pilot whose
    description asks for ``mesh_shape=(1, 1)``, so that its DeviceMesh
    spans the group, and the engine's SPMD loop (rank 0's admissions
    broadcast every pass, prefill and decode under the mesh's sharding
    context, greedy tokens by ``vocab_argmax``).  Its tokens must be the
    unsharded phase's, token for token, on the same params and prompts;
    its launches follow the same rule."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=600))
    try:
        res = serving_phase(torch, core, cfg, params, kernels,
                            mesh_shape=(1, 1))
    finally:
        dist.destroy_process_group()
    same = sum(a == b for a, b in zip(res["outs"], unsharded["outs"]))
    log(f"serving over the (1, 1) pilot mesh: {same} of "
        f"{len(res['outs'])} requests token for token the unsharded "
        f"phase's")
    assert res["outs"] == unsharded["outs"], (
        "the (1, 1) pilot mesh must serve the unsharded tokens")
    return res


# -- a (1, 4) rank's share of MoE and MLA, one rank at a time ---------------
# Mixtral-8x22B's MoE FFN and DeepSeek-V3's MLA at their published widths,
# one layer: each of a (1, 4) mesh's model ranks runs on its leaves (2 of 8
# experts, 32 of 128 heads) in turn, on one card, and the four partial sums
# must add up to the whole layer's output (fp32 at SPLIT_RTOL of the
# output's largest magnitude; bf16 reported); the device ms of each rank's
# share and of the whole layer.  A Mixtral prefill wave of 8 x 512; MLA's
# prefill of 8 x 512 and one decode step against that prefill's latents.
SPLIT_RANKS, SPLIT_RTOL = 4, 1e-5
SPLIT_BATCH, SPLIT_SEQ, SPLIT_MAX_LEN = 8, 512, 1024


class RankView:
    """Model rank `rank` of a (1, `ranks`) data x model mesh, as the models
    read a mesh (axes, sizes, coordinate), over a one-rank process group:
    each "all-reduce" over its model axis sums one rank, so the model code
    computes exactly that rank's partial result on this card."""

    def __init__(self, ranks: int, rank: int):
        self.mesh_dim_names = ("data", "model")
        self.shape = (1, ranks)
        self.coord = [0, rank]

    def size(self, dim=None):
        return self.shape[dim] if dim is not None else math.prod(self.shape)

    def get_coordinate(self):
        return self.coord

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]

    def get_group(self, name):
        return None               # the default (one-rank) process group


def rank_leaves(params: dict, specs: dict, block: str, cfg, view,
                rules) -> dict:
    """A rank's leaves of a flat dict of one `block`'s params ("moe",
    "attn"), each by its layout in the models (``transformer.tp_layouts``)."""
    from repro_torch.models.transformer import local_leaf, tp_layouts
    lays = tp_layouts({block: specs}, cfg)[block]
    return {k: local_leaf(v, specs[k], lays[k], view, rules)
            for k, v in params.items()}


def split_sum(torch, name, whole_fn, rank_fn, dtype, timed: bool) -> dict:
    """Runs `rank_fn(view)` for each model rank of a (1, SPLIT_RANKS) mesh
    and holds the sum of their outputs to `whole_fn()`; the device ms of
    each and of the whole where `timed`."""
    from repro_torch.parallel.sharding import AxisRules, sharding_context
    rules = AxisRules()
    views = [RankView(SPLIT_RANKS, m) for m in range(SPLIT_RANKS)]

    def in_rank(view):
        with sharding_context(view, rules):
            return rank_fn(view)

    with torch.inference_mode():
        want = whole_fn().float()
        got = sum(in_rank(v).float() for v in views)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        row = {"name": name, "dtype": str(dtype).split(".")[-1],
               "ranks": SPLIT_RANKS, "max_abs_err": err,
               "max_abs_out": scale, "rel_err": err / max(scale, 1e-30)}
        if timed:
            row["whole_ms"] = event_ms(torch, whole_fn, 5)
            row["rank_ms"] = [event_ms(torch, lambda v=v: in_rank(v), 5)
                              for v in views]
    assert math.isfinite(err) and math.isfinite(scale), row
    if dtype == torch.float32:
        assert err <= SPLIT_RTOL * scale, (
            f"{name}: the {SPLIT_RANKS} ranks' partial sums differ from the "
            f"whole layer's output by {err} (bound {SPLIT_RTOL} x {scale})")
    log(f"{name} split {SPLIT_RANKS} ways ({row['dtype']}): max |sum of "
        f"partials - whole| {err:.3e} of max |out| {scale:.3e}"
        + (f"; device ms whole {row['whole_ms']:.4f}, a rank "
           + ", ".join(f"{t:.4f}" for t in row["rank_ms"]) if timed else ""))
    return row


def rank_split_phase(torch) -> dict:
    """Mixtral's MoE FFN and DeepSeek-V3's MLA split over a (1, 4) mesh's
    model ranks, each rank's share run in turn on this card (`RankView`,
    a one-rank NCCL group): their sums against the whole layers, in fp32
    (held) and bf16 (reported), and their device ms.  No kernel: the
    experts and MLA are cuBLAS products."""
    import datetime
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import moe_ffn, moe_specs
    from repro_torch.models.model import _mla_cache_from_prefill
    from repro_torch.parallel.sharding import AxisRules
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    rules = AxisRules()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=600))
    rows = []
    try:
        mcfg = get_config("mixtral_8x22b")
        specs = moe_specs(mcfg)
        params = init_params(specs, gen(), torch.device("cuda"))
        x = torch.randn(SPLIT_BATCH, SPLIT_SEQ, mcfg.d_model,
                        generator=gen(), device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            rows.append(split_sum(
                torch, "mixtral moe_ffn (1 layer, 8 x 512)",
                lambda: moe_ffn(params, xd, mcfg)[0],
                lambda v: moe_ffn(rank_leaves(params, specs, "moe", mcfg, v,
                                              rules), xd, mcfg)[0],
                dt, timed=dt == torch.bfloat16))
        del params, x, xd
        gc.collect()
        torch.cuda.empty_cache()
        dcfg = get_config("deepseek_v3_671b")
        specs = attn.mla_specs(dcfg)
        params = init_params(specs, gen(), torch.device("cuda"))
        x = torch.randn(SPLIT_BATCH, SPLIT_SEQ, dcfg.d_model,
                        generator=gen(), device="cuda")
        xt = torch.randn(SPLIT_BATCH, 1, dcfg.d_model, generator=gen(),
                         device="cuda")
        pos = torch.arange(SPLIT_SEQ, dtype=torch.int32,
                           device="cuda").expand(SPLIT_BATCH, SPLIT_SEQ)
        step_pos = torch.full((SPLIT_BATCH,), SPLIT_SEQ, dtype=torch.int32,
                              device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            xd, xtd = x.to(dt), xt.to(dt)
            prefill = lambda p: attn.mla_forward(
                p, xd, cfg=dcfg, positions=pos, return_cache=True)
            rows.append(split_sum(
                torch, "deepseek-v3 mla_forward (1 layer, 8 x 512)",
                lambda: prefill(params)[0],
                lambda v: prefill(rank_leaves(params, specs, "attn", dcfg,
                                              v, rules))[0],
                dt, timed=dt == torch.bfloat16))
            with torch.inference_mode():
                _, (c_kv, k_rope) = prefill(params)
                cache = {k: t[0] for k, t in _mla_cache_from_prefill(
                    (c_kv[None], k_rope[None]), pos,
                    SPLIT_MAX_LEN).items()}
            fresh = lambda: {k: t.clone() for k, t in cache.items()}
            rows.append(split_sum(
                torch, "deepseek-v3 mla_decode (1 layer, 8 rows, 512 "
                "cached)",
                lambda: attn.mla_decode(params, xtd, fresh(), cfg=dcfg,
                                        positions=step_pos)[0],
                lambda v: attn.mla_decode(
                    rank_leaves(params, specs, "attn", dcfg, v, rules), xtd,
                    fresh(),
                    cfg=dcfg, positions=step_pos)[0],
                dt, timed=dt == torch.bfloat16))
        del params, x, xt, cache
        dist.barrier()
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return {"rows": rows}


def hymba_inputs(torch, cfg, b: int, s: int, seed: int):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()


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
                causal=True, timed=True, skv=None) -> dict:
    """flash_attention kernel vs its plain version on the same
    card-resident inputs (bf16 runs on the tensor-core kernel, fp32 on the
    CUDA-core one): s query rows against `skv` kv rows (default s).
    Tolerances: fp32 atol/rtol 2e-5 (as tests/test_kernels.py); bf16
    atol/rtol 2e-2 against the fp32 plain result cast to bf16.  With
    `timed`, times: kernel (CUDA-graph replay and eager), plain version
    and SDPA, each over enough input copies to exceed L2."""
    skv = s if skv is None else skv
    g = torch.Generator(device="cuda").manual_seed(5)
    args = tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, s, nq, h), (b, skv, nkv, h),
                               (b, skv, nkv, h)))
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
        log(f"flash_attention check {name} B={b} S={s} Skv={skv} {nq}/{nkv} "
            f"H={h} {str(dtype).split('.')[-1]} window={window} "
            f"causal={causal} ({route}): max_abs_err={float(err.max()):.3e}")
        return {"shape": name, "b": b, "s": s, "skv": skv, "nq": nq,
                "nkv": nkv, "h": h,
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
    b_s, b_by, pairs = flash_bound(b, s, skv, nq, nkv, h, esize, causal,
                                   window)
    row = {"shape": name, "b": b, "s": s, "skv": skv, "nq": nq, "nkv": nkv,
           "h": h,
           "window": window, "causal": causal, "route": route,
           "dtype": str(dtype).split(".")[-1], "kernel_ms": ms,
           "kernel_eager_ms": eager, "plain_ms": plain,
           "library_ms": library, "bound_us": b_s * 1e6, "bound_by": b_by,
           "pairs": pairs, "max_abs_err": float(err.max()),
           "library_max_abs_err": lib_err}
    log(f"flash_attention check {name} B={b} S={s} Skv={skv} {nq}/{nkv} "
        f"H={h} {row['dtype']} window={window} causal={causal} ({route}): "
        f"kernel_ms={ms:.6f} "
        f"kernel_eager_ms={eager:.6f} plain_ms={plain:.6f} "
        f"sdpa_ms={library:.6f} bound_us={b_s * 1e6:.4f} ({b_by}) "
        f"max_abs_err={row['max_abs_err']:.3e} sdpa_err={lib_err:.3e}")
    return row


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


def ssm_model_phase(torch, cfg, params, kernels: dict, *, name: str,
                    s: int, max_len: int, expect: dict) -> dict:
    """Kernel vs plain at model level for the SSM family and the hybrid
    (Hymba), full width: prefill 4 prompts of `s` tokens (for Hymba past
    its 1024 window: SWA masking in prefill and the rolled cache in
    decode), then 8 decode steps, three ways: the kernel path; the plain
    path (decode_kernel=False, and prefill attention and scan patched to
    their plain versions here); the fp32 model (params cast to fp32) on
    the plain path.  All are fed the fp32 model's greedy tokens.  The
    kernel path must count `expect` launches, by kernel.  Tolerance, as
    for Llama (PERF.md): max|dlogits| of kernel vs plain <= max|dlogits|
    of plain bf16 vs fp32, prefill logits included."""
    import functools

    import repro_torch.models.attention as attn_models
    import repro_torch.models.ssm as ssm_models
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model

    b = 4
    kern = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, decode_kernel=False))
    m32 = build_model(dataclasses.replace(cfg, decode_kernel=False,
                                          dtype="float32"))
    prompts = hymba_inputs(torch, cfg, b, s, seed=1)
    pos0 = torch.full((b,), s, dtype=torch.int32, device="cuda")

    def run(model, p, feed=None):
        logits, cache = model.prefill(p, {"tokens": prompts}, max_len)
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
    for kernel, n in expect.items():
        assert launches[kernel] == n, (kernel, n, launches)
    d = max(float((a - c).abs().max()) for a, c in zip(got_k, got_p))
    d_plain = max(float((a - c).abs().max()) for a, c in zip(got_p, want32))
    d_kernel = max(float((a - c).abs().max()) for a, c in zip(got_k, want32))
    agree = sum(int((a.argmax(-1) == c.argmax(-1)).sum())
                for a, c in zip(got_k, got_p))
    scale = max(float(a.abs().max()) for a in got_p)
    log(f"model check {name}, {b} prompts x {s}, 8 decode "
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


def family_serving_phase(torch, core, name, cfg, params, kernels: dict,
                         lens, max_len, *, memory_gb=8, after=None,
                         width="full width", expect=None) -> dict:
    """A family's serving path (InternVL2, Mixtral, Whisper, Falcon-Mamba,
    StarCoder2, DeepSeek-V3):
    16 greedy requests whose prompt lengths are drawn from `lens`
    (np.random.default_rng(0)).  `expect(stats)` gives the launches the
    path must count, by kernel; by default (a GQA decoder)
    flash_attention runs on the tensor cores once per layer in each
    prefill, decode_attention once per layer in each decode step.  Every
    decode_attention launch is on the tensor-core route and no fp32 flash
    launch is made (the models run bf16)."""
    rng = np.random.default_rng(0)
    lens = rng.choice(lens, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    res = serve(torch, core, cfg, params, prompts, kernels, max_len=max_len,
                memory_gb=memory_gb, after=after)
    st, launches = res["stats"], res["launches"]
    prefills = st["waves"] + st["refills"]
    want = (expect(st) if expect is not None else {
        "flash_attention": cfg.num_layers * prefills,
        "decode_attention": cfg.num_layers * st["decode_steps"]})
    for kernel, n in want.items():
        assert launches[kernel] == n, (kernel, n, launches, st)
    assert launches["decode_attention_tc"] == launches["decode_attention"], (
        launches)
    assert launches["flash_attention_fp32"] == 0, launches   # bf16 model
    assert res["peak_bytes"] < 80e9, res["peak_bytes"]
    res["prompt_lens"] = [int(n) for n in lens]
    log(serve_line(name, cfg, res, width) + f"; prompt lengths "
        f"{res['prompt_lens']}")
    return res


def op_kernels(e) -> list:
    """(name, us) of the kernels a profiled CPU op and its children
    launched."""
    out = [(k.name, float(k.duration)) for k in e.kernels]
    for ch in e.cpu_children:
        out += op_kernels(ch)
    return out


def mixtral_step(torch, cfg, params) -> dict:
    """Where a Mixtral decode step's time goes, on the serving runtime's
    params (the one device copy): 8 prompts of 1024 prefilled into the
    4096-slot cache, 5 synchronised decode steps timed on the host clock
    (the decode graph's replays), then one eager step under the profiler
    (CPU and CUDA activity): the expert products (the kernels of aten::bmm,
    which only moe_ffn calls in a decode step), the other GEMMs,
    decode_attention and the rest, beside the weight-read floor (every
    weight but the embedding table read once: under the capacity dispatch
    each decode step runs all 8 experts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    prompts = hymba_inputs(torch, cfg, SERVE_BATCH, 1024, seed=4)
    _, cache = model.prefill(params, {"tokens": prompts}, MIXTRAL_MAX_LEN)
    tok = prompts[:, -1:]
    pos = torch.full((SERVE_BATCH,), 1024, dtype=torch.int32, device="cuda")
    ms = []
    for i in range(6):                      # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode(params, cache, tok, pos + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    # the eager step under the profiler: a graph's replay launches its
    # kernels under no op, and the expert products are read by theirs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_graphs.step(params, cache, tok, pos + 6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per, bmm = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif e.name == "aten::bmm":
            bmm += op_kernels(e)
    parts = breakdown(per)
    busy = sum(parts.values())
    # the expert products' kernels leave the kind their name gave them
    for kname, us in bmm:
        parts[kernel_kind(kname)] -= us
    experts = sum(us for _, us in bmm)
    parts = {"expert_products": experts} | parts
    assert parts["decode_attention"] > 0, sorted(per)
    assert experts > 0, f"no kernel of aten::bmm traced: {sorted(per)}"
    layers = params["layers"]
    expert_bytes = sum(int(layers["moe"][k].nbytes)
                       for k in ("w_gate", "w_up", "w_down"))
    weight_bytes = sum(int(t.nbytes) for t in tree_leaves(params)) - int(
        params["embed"].nbytes)
    floor_ms = weight_bytes / PEAK_BYTES_PER_S * 1e3
    row = {"wall_us": wall * 1e6, "busy_us": busy,
           "busy_share": busy / (wall * 1e6), "device_us": parts,
           "step_ms": ms[1:], "expert_bytes": expert_bytes,
           "weight_bytes": weight_bytes, "weight_floor_ms": floor_ms}
    log(f"trace of one mixtral-8x22b decode step ({cfg.num_layers} layers, "
        f"B={SERVE_BATCH}, 4096 slots, position 1030, kernel path, profiler "
        f"on): wall_us={wall * 1e6:.3f} device_busy_us={busy:.3f} "
        f"device_busy_share={busy / (wall * 1e6):.6f} "
        + " ".join(f"{k}_us={v:.3f}" for k, v in parts.items())
        + f" (gemm_us: the other GEMMs); device busy us over the fastest "
        f"synchronised step {busy / (min(ms[1:]) * 1e3):.6f}; synchronised "
        f"steps ms "
        f"{[round(x, 3) for x in ms[1:]]}; weight-read floor "
        f"{floor_ms:.4f} ms ({weight_bytes} bytes of weights, "
        f"{expert_bytes} of them the experts', at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s)")
    return row


def host_memory(when: str) -> dict:
    """The machine's `free -g` and this process's peak resident set."""
    import resource
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    log(f"free -g on the card's machine, {when}:\n" + free
        + f"\npeak resident set of this process {rss_gb:.3f} GB")
    return {"free_g": free, "max_rss_gb": rss_gb}


def fan_in_params(torch, cfg, seed: int):
    """Params for a model check, drawn on the card from `seed` at a
    1/sqrt(fan-in) scale, the fan-in of a "scaled" leaf being its input
    width: the axis after a leading layer (and expert) axis, times the
    head width where it starts with the heads (an output projection).
    The JAX package's init, which the port copies, takes a stacked leaf's
    first axis, its layer count, as the fan-in: the residual stream then
    grows until the bf16 path lies about half the logits' scale from fp32
    (the Llama check's own numbers, PERF.md), and a bound taken from that
    gap holds little.  The serving phases keep the engine's own draw."""
    from repro_torch.models.common import _init_leaf, tree_map
    from repro_torch.models.transformer import model_specs
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def leaf(sp):
        if sp.init != "scaled":
            return _init_leaf(sp, g, dev)
        lead = 0
        while sp.logical[lead] in ("layers", "expert"):
            lead += 1
        fan = sp.shape[lead] * (sp.shape[lead + 1]
                                if sp.logical[lead] == "heads" else 1)
        x = torch.randn(sp.shape, generator=g, device=dev)
        return x.mul_(fan ** -0.5).to(sp.dtype)
    return tree_map(leaf, model_specs(cfg))


# Two bf16 computations of one function whose roundings are independent
# lie about sqrt(2) times as far from each other as each lies from fp32.
# The Llama rule (kernel vs plain <= plain vs fp32) holds on the engine's
# init, where both paths share the residual stream's large roundings; on
# `fan_in_params` the attention's own roundings weigh as much, and the
# new model checks bound the gap between two bf16 paths by this factor
# times the bf16 path's gap from fp32 (PERF.md).
INDEPENDENT_ROUNDING = math.sqrt(2)


@contextlib.contextmanager
def fp32_head():
    """While the block runs, the models' logits are taken in fp32 from
    their final hidden state (the head's product in fp32): the head's own
    bf16 rounding, the same step in every bf16 path, would quantize a
    comparison of two bf16 paths to an ulp of the logits (0.03 at 4)."""
    import repro_torch.models.transformer as tfm_models
    real = tfm_models.lm_logits
    tfm_models.lm_logits = lambda params, x, cfg: real(params, x.float(),
                                                       cfg)
    try:
        yield
    finally:
        tfm_models.lm_logits = real


def whisper_inputs(torch, cfg, b: int, s: int, seed: int) -> dict:
    """b prompts of s tokens and frames of 0.1 * normal (as
    tests/test_models.py feeds them), from a seed, on the card."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = 0.1 * rng.standard_normal((b, cfg.encoder_seq_len,
                                        cfg.d_model))
    return {"tokens": torch.from_numpy(tokens).cuda(),
            "frames": torch.from_numpy(frames.astype(np.float32)).cuda()}


def whisper_launches(cfg, prefills: int, steps: int) -> dict:
    """The kernel launches of Whisper's path: flash_attention in each
    prefill once per encoder layer and twice per decoder layer (causal
    self attention, cross attention), and once per decoder layer in each
    decode step (cross attention, one query row); decode_attention once
    per decoder layer in each decode step."""
    enc, dec = cfg.encoder_layers, cfg.num_layers
    return {"flash_attention": (enc + 2 * dec) * prefills + dec * steps,
            "decode_attention": dec * steps}


def whisper_model_phase(torch, cfg, params, kernels: dict) -> dict:
    """Kernel vs plain at model level, full size: prefill 8 prompts of 16
    tokens after 1500 frames of 0.1 * normal, then 8 decode steps, three
    ways: the kernel path; the plain path (flash_attention_op and
    decode_attention_op patched to their plain versions, fp32 inside, so
    that only the kernels differ); the fp32 model.  All are fed the fp32
    model's greedy tokens, on `fan_in_params`, the logits taken in fp32
    from each path's hidden state (`fp32_head`).  Tolerances, prefill
    logits included: kernel vs plain <= INDEPENDENT_ROUNDING x (plain vs
    fp32), and the kernel path no further from fp32 than that bound.  The
    serving engine feeds zero frames, under which every encoder layer
    maps 0 to 0 and cross attention adds nothing, so this check is the
    one that holds the encoder and cross attention: the frames must move
    the logits by more than the bf16 path's own error.  Then one decode
    step of the kernel path under the profiler."""
    import functools

    import repro_torch.models.attention as attn_models
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model

    b, s, steps = SERVE_BATCH, 16, 8
    kern = plain = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, decode_kernel=False,
                                          dtype="float32"))
    batch = whisper_inputs(torch, cfg, b, s, seed=1)
    pos0 = torch.full((b,), s, dtype=torch.int32, device="cuda")

    def run(model, p, feed=None):
        logits, cache = model.prefill(p, batch, WHISPER_MAX_LEN)
        outs, toks, pos = [logits.float()], [], pos0
        for t in range(steps):
            tok = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[t])
            toks.append(tok)
            logits, cache = model.decode(p, cache, tok[:, None], pos)
            outs.append(logits.float())
            pos = pos + 1
        return outs, toks, cache

    real = (attn_models.flash_attention_op, attn_models.decode_attention_op)
    attn_models.flash_attention_op = functools.partial(real[0], impl="ref")
    attn_models.decode_attention_op = functools.partial(real[1], impl="ref")
    try:
        with fp32_head():
            zero_counts(kernels)
            p32 = tree_map(lambda t: t.float(), params)
            want32, feed, _ = run(m32, p32)
            del p32
            got_p, _, _ = run(plain, params, feed)
            plain_launches = read_counts(kernels)
    finally:
        attn_models.flash_attention_op, attn_models.decode_attention_op = real
    assert not any(plain_launches.values()), (
        f"the plain path launched kernels: {plain_launches}")
    zero_counts(kernels)
    with fp32_head():
        got_k, _, cache = run(kern, params, feed)
    launches = read_counts(kernels)
    for kernel, n in whisper_launches(cfg, 1, steps).items():
        assert launches[kernel] == n, (kernel, n, launches)
    assert launches["decode_attention_tc"] == launches["decode_attention"]
    assert launches["flash_attention_fp32"] == 0, launches
    d = max(float((a - c).abs().max()) for a, c in zip(got_k, got_p))
    d_plain = max(float((a - c).abs().max()) for a, c in zip(got_p, want32))
    d_kernel = max(float((a - c).abs().max()) for a, c in zip(got_k, want32))
    agree = sum(int((a.argmax(-1) == c.argmax(-1)).sum())
                for a, c in zip(got_k, got_p))
    scale = max(float(a.abs().max()) for a in got_p)
    zero = dict(batch, frames=torch.zeros_like(batch["frames"]))
    with fp32_head():
        moved = float((kern.prefill(params, zero, WHISPER_MAX_LEN)[0]
                       - got_k[0]).abs().max())
    log(f"model check whisper-base full size, {b} prompts x {s} after "
        f"{cfg.encoder_seq_len} frames of 0.1*normal, {steps} decode steps: "
        f"max|dlogits| kernel vs plain = {d:.6f} (bound: "
        f"{INDEPENDENT_ROUNDING:.4f} x plain vs fp32 = "
        f"{INDEPENDENT_ROUNDING * d_plain:.6f}; plain vs fp32 = "
        f"{d_plain:.6f}); kernel vs fp32 = {d_kernel:.6f}; max|logits| "
        f"{scale:.4f}; greedy agree {agree}/{(steps + 1) * b}; zero frames "
        f"move the prefill logits by {moved:.6f}; kernel-path launches "
        f"{launches}, plain-path launches {plain_launches}")
    assert all(bool(torch.isfinite(a).all()) for a in got_k + got_p)
    bound = INDEPENDENT_ROUNDING * d_plain
    assert d <= bound and d_kernel <= bound, (
        f"the kernel path differs from the plain path by {d} and from fp32 "
        f"by {d_kernel}, against a bound of {bound} (plain vs fp32 "
        f"{d_plain})")
    assert moved > d_plain, (f"the frames move the logits by {moved}, no "
                             f"more than bf16 rounding ({d_plain})")
    # one decode step under the profiler: where its device time goes
    _, wall, per = device_trace(torch, lambda: kern.decode(
        params, cache, feed[-1][:, None], pos0 + steps))
    parts = breakdown(per)
    assert parts["decode_attention"] > 0 and parts["flash_attention"] > 0, (
        sorted(per))
    busy = sum(parts.values())
    log(f"trace of one whisper-base decode step (kernel path, B={b}, "
        f"{WHISPER_MAX_LEN} slots, {cfg.encoder_seq_len} frames, profiler "
        f"on): wall_us={wall * 1e6:.3f} device_busy_us={busy:.3f} "
        f"device_busy_share={busy / (wall * 1e6):.6f} "
        + " ".join(f"{k}_us={v:.3f}" for k, v in parts.items())
        + f" kernels={len(per)}")
    return {"max_abs_dlogits": d, "plain_vs_fp32": d_plain,
            "kernel_vs_fp32": d_kernel, "greedy_agree": agree,
            "frames_move_logits": moved, "kernel_launches": launches,
            "step_us": parts, "step_wall_us": wall * 1e6}


def deepseek_model_phase(torch, cfg, params) -> dict:
    """DeepSeek-V3's model check, at its 3 leading (dense) layers: no
    kernel of the port is on this path, so it holds (1) the bf16 logits
    against the fp32 model's (params cast) and (2) the absorbed decode
    against the expanded prefill: the logits of decode at position t
    against those of a prefill over the t+1 tokens, equal in exact
    arithmetic.  In bf16 their gap must be no larger than
    INDEPENDENT_ROUNDING x the bf16 model's gap from fp32 in the same run
    (over the prefill, the decode steps and the prefills over t+1 tokens:
    the two paths round differently by design); in fp32 no larger than a
    hundredth of that gap.  8 prompts of 512 tokens, 4 decode
    steps, all fed the fp32 model's greedy tokens, on `fan_in_params`,
    the logits taken in fp32 from each run's hidden state (`fp32_head`)."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model

    b, s, steps = SERVE_BATCH, 512, 4
    m16 = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    prompts = hymba_inputs(torch, cfg, b, s, seed=5)

    def run(model, p, feed=None):
        logits, cache = model.prefill(p, {"tokens": prompts},
                                      DEEPSEEK_MAX_LEN)
        outs, expanded, toks = [logits.float()], [], []
        seq, pos = prompts, torch.full((b,), s, dtype=torch.int32,
                                       device="cuda")
        for t in range(steps):
            tok = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[t])
            toks.append(tok)
            logits, cache = model.decode(p, cache, tok[:, None], pos)
            outs.append(logits.float())
            seq = torch.cat([seq, tok[:, None]], dim=1)
            expanded.append(model.prefill(p, {"tokens": seq},
                                          DEEPSEEK_MAX_LEN)[0].float())
            pos = pos + 1
        return outs, expanded, toks

    with fp32_head():
        p32 = tree_map(lambda t: t.float(), params)
        out32, exp32, feed = run(m32, p32)
        del p32
        torch.cuda.empty_cache()
        out16, exp16, _ = run(m16, params, feed)
    gap = lambda xs, ys: max(float((a - c).abs().max()) for a, c in
                             zip(xs, ys))
    d_bf16 = max(gap(out16, out32), gap(exp16, exp32))
    d_abs16, d_abs32 = gap(out16[1:], exp16), gap(out32[1:], exp32)
    scale = max(float(a.abs().max()) for a in out32)
    agree = sum(int((a.argmax(-1) == c.argmax(-1)).sum())
                for a, c in zip(out16, out32))
    log(f"model check deepseek-v3 ({cfg.num_layers} of 61 layers, all "
        f"dense MLA, published widths), {b} prompts x {s}, {steps} decode "
        f"steps: max|dlogits| bf16 vs fp32 = {d_bf16:.6f}; absorbed decode "
        f"vs expanded prefill: bf16 {d_abs16:.6f} (bound: "
        f"{INDEPENDENT_ROUNDING:.4f} x bf16 vs fp32 = "
        f"{INDEPENDENT_ROUNDING * d_bf16:.6f}), fp32 {d_abs32:.6f} (bound "
        f"{d_bf16 / 100:.6f}); max|logits| {scale:.4f}; greedy agree bf16 "
        f"vs fp32 {agree}/{(steps + 1) * b}")
    assert all(bool(torch.isfinite(a).all()) for a in out16 + exp16)
    assert d_abs16 <= INDEPENDENT_ROUNDING * d_bf16, (
        f"the absorbed decode differs from the expanded prefill by {d_abs16} "
        f"in bf16, against bf16's own error {d_bf16} against fp32")
    assert d_abs32 <= d_bf16 / 100, (
        f"the absorbed decode differs from the expanded prefill by {d_abs32} "
        f"in fp32")
    return {"bf16_vs_fp32": d_bf16, "absorbed_vs_expanded_bf16": d_abs16,
            "absorbed_vs_expanded_fp32": d_abs32, "greedy_agree": agree,
            "max_abs_logits": scale}


def bmm_kernels(e) -> list:
    """(name, us) of the kernels launched under the aten::bmm ops beneath
    a profiled CPU op."""
    if e.name == "aten::bmm":
        return op_kernels(e)
    return [k for ch in e.cpu_children for k in bmm_kernels(ch)]


def deepseek_step(torch, cfg, params) -> dict:
    """Where a DeepSeek-V3 decode step's time goes, on the serving
    runtime's params (the one device copy): 8 prompts of 1024 prefilled
    into the 2048-slot latent cache, 5 synchronised decode steps timed on
    the host clock (the decode graph's replays), then one eager step
    under the profiler (CPU and CUDA activity) with mla_decode, the dense
    FFN and moe_ffn each inside a record_function range: the MLA products,
    the dense FFNs, the expert products (the kernels of aten::bmm under
    moe_ffn), the rest of the MoE (router, dispatch, shared expert) and
    everything else, beside the weight-read floor (every weight but the embedding table and the MTP
    module, which decode never reads, read once: the decode-time
    regrouping puts the 8 rows' 64 (token, expert) choices in one group
    with one slot per expert, and the batched products run all 256
    experts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch.models.attention as attn_models
    import repro_torch.models.moe as moe_models
    import repro_torch.models.transformer as tfm_models
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    prompts = hymba_inputs(torch, cfg, SERVE_BATCH, 1024, seed=6)
    _, cache = model.prefill(params, {"tokens": prompts}, DEEPSEEK_MAX_LEN)
    tok = prompts[:, -1:]
    pos = torch.full((SERVE_BATCH,), 1024, dtype=torch.int32, device="cuda")
    ms = []
    for i in range(6):                      # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode(params, cache, tok, pos + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ranges = {"mla": (attn_models, "mla_decode"),
              "dense_ffn": (tfm_models, "dense_ffn"),
              "moe": (moe_models, "moe_ffn")}
    real = {label: getattr(mod, fn) for label, (mod, fn) in ranges.items()}

    def ranged(label):
        def call(*a, **kw):
            with record_function(label):
                return real[label](*a, **kw)
        return call

    for label, (mod, fn) in ranges.items():
        setattr(mod, fn, ranged(label))
    try:
        # the eager step: a graph's replay runs no op, no range
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.decode_graphs.step(params, cache, tok, pos + 6)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for label, (mod, fn) in ranges.items():
            setattr(mod, fn, real[label])
    per = {}
    under = {label: 0.0 for label in ranges}
    experts = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name not in ranges:        # not a range's own device span
                per[e.name] = per.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
        elif e.name in ranges:
            under[e.name] += sum(us for _, us in op_kernels(e))
            if e.name == "moe":
                experts += sum(us for _, us in bmm_kernels(e))
    busy = sum(per.values())
    parts = {"mla_products": under["mla"], "dense_ffn": under["dense_ffn"],
             "expert_products": experts,
             "moe_rest": under["moe"] - experts,
             "other": busy - sum(under.values())}
    assert experts > 0 and under["mla"] > 0 and under["dense_ffn"] > 0, (
        under, sorted(per))
    moe_p = params["layers"]["moe"]
    expert_bytes = sum(int(moe_p[k].nbytes)
                       for k in ("w_gate", "w_up", "w_down"))
    weight_bytes = sum(int(t.nbytes) for t in tree_leaves(params)) - int(
        params["embed"].nbytes) - sum(int(t.nbytes) for t in
                                      tree_leaves(params["mtp"]))
    floor_ms = weight_bytes / PEAK_BYTES_PER_S * 1e3
    row = {"wall_us": wall * 1e6, "busy_us": busy,
           "busy_share": busy / (wall * 1e6), "device_us": parts,
           "step_ms": ms[1:], "expert_bytes": expert_bytes,
           "weight_bytes": weight_bytes, "weight_floor_ms": floor_ms}
    log(f"trace of one deepseek-v3 decode step ({cfg.num_layers} layers, "
        f"B={SERVE_BATCH}, {DEEPSEEK_MAX_LEN} slots, position 1030, profiler "
        f"on): wall_us={wall * 1e6:.3f} device_busy_us={busy:.3f} "
        f"device_busy_share={busy / (wall * 1e6):.6f} "
        + " ".join(f"{k}_us={v:.3f}" for k, v in parts.items())
        + f"; device busy us over the fastest synchronised step "
        f"{busy / (min(ms[1:]) * 1e3):.6f}; synchronised steps ms "
        f"{[round(x, 3) for x in ms[1:]]}; weight-read floor "
        f"{floor_ms:.4f} ms ({weight_bytes} bytes of weights, "
        f"{expert_bytes} of them the experts', at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s)")
    return row


# -- the training phase ---------------------------------------------------------
# Llama-3.2-1B at its published config, trained by launch.train on a pilot:
# bf16 params, fp32 AdamW state, remat "full", batch 8 x 1024, 30 steps
TRAIN_ARGV = ["--arch", "llama3_2_1b", "--preset", "full", "--steps", "30",
              "--batch", "8", "--seq", "1024", "--ckpt-every", "100",
              "--log-every", "5"]
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# card vs CPU on reduced(llama3_2_1b) in fp32, 3 steps: the metrics, and
# every param leaf, at these tolerances (the CPU tests' step parity)
CARD_CPU_METRIC_RTOL, CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-5, 1e-4, 1e-6
# the first step in bf16 against fp32 at full width (one init, one batch):
# (loss gap, lowest per-leaf gradient cosine) bounds per init, set from
# a first run of this check on an H100 (PERF.md §6): on fan-in-scaled
# weights bf16 tracks fp32 (measured 0.000276, 0.999822); on the trainer's
# own draw (the reference's fan-in rule, the residual stream growing about
# 11x a layer) the layers' gradients are chaotic in the rounding
# (measured 0.000013, 0.084338), and only their sign is held
BF16_BOUNDS = {"fan_in": (2e-3, 0.999), "trainer": (1e-3, 0.04)}


def train_batch(torch, cfg, b: int, s: int, seed: int, device) -> dict:
    """b rows of s tokens (and their labels) from the training corpus."""
    from repro_torch.data.pipeline import synthesize_corpus
    toks = synthesize_corpus(cfg.vocab_size, b * (s + 1), seed=seed)
    arr = torch.from_numpy(toks.reshape(b, s + 1).astype(np.int64))
    return {"tokens": arr[:, :-1].to(device),
            "labels": arr[:, 1:].to(device)}


def train_card_vs_cpu(torch) -> dict:
    """3 train steps of reduced(llama3_2_1b) in fp32 on the card and the
    same 3 on the CPU, from the same params (`fan_in_params`: on the
    reference's init the residual stream grows until the two devices'
    summation orders move the gradients by 1e-5 of their norm) and the
    same batches."""
    from repro_torch.configs.base import (ParallelConfig, TrainConfig,
                                          reduced)
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.train import steps
    cfg = reduced(get_config("llama3_2_1b"), dtype="float32")
    model = build_model(cfg)
    init = tree_map(lambda t: t.float().cpu(), fan_in_params(torch, cfg, 0))
    runs = {}
    for dev in ("cpu", "cuda"):
        # a copy on each side: the step updates its state in place
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        state = steps.TrainState(params, steps.adamw_init(params))
        step = steps.make_train_step(model, ParallelConfig(), TrainConfig(
            learning_rate=1e-3, warmup_steps=1, total_steps=10))
        hist = []
        for i in range(3):
            state, m = step(state, train_batch(torch, model.cfg, 4, 64,
                                               seed=20 + i, device=dev))
            hist.append({k: float(v) for k, v in m.items()})
        runs[dev] = (hist, [t.cpu() for t in tree_leaves(state.params)])
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(runs["cuda"][0], runs["cpu"][0])
                     for k in b if b[k])
    leaf_err, leaf_rel, outside = 0.0, 0.0, 0
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        excess = (a - b).abs() - CARD_CPU_RTOL * b.abs()
        leaf_err = max(leaf_err, float(excess.max()))
        outside += int((excess > CARD_CPU_ATOL).sum())
        leaf_rel = max(leaf_rel, float((a - b).norm() / b.norm()))
    row = {"steps": 3, "metrics_max_rel_err": metric_err,
           "param_max_err_past_rtol": leaf_err,
           "param_elements_outside_tol": outside,
           "param_max_leaf_rel_norm_err": leaf_rel,
           "loss_card": [h["loss"] for h in runs["cuda"][0]],
           "loss_cpu": [h["loss"] for h in runs["cpu"][0]],
           "grad_norm_card": [h["grad_norm"] for h in runs["cuda"][0]],
           "grad_norm_cpu": [h["grad_norm"] for h in runs["cpu"][0]]}
    log(f"training, card vs cpu (reduced llama3.2-1b, fp32, 3 steps): "
        f"metrics max rel err {metric_err:.3e} (limit "
        f"{CARD_CPU_METRIC_RTOL}); params max |err| past rtol "
        f"{CARD_CPU_RTOL} {leaf_err:.3e} (limit {CARD_CPU_ATOL}), "
        f"{outside} elements outside, largest leaf error "
        f"{leaf_rel:.3e} of its norm; losses card {row['loss_card']} cpu "
        f"{row['loss_cpu']}; grad norms card {row['grad_norm_card']} cpu "
        f"{row['grad_norm_cpu']}")
    assert metric_err <= CARD_CPU_METRIC_RTOL, row
    assert leaf_err <= CARD_CPU_ATOL, row
    return row


def train_bf16_vs_fp32(torch, cfg, init: str) -> dict:
    """The first step's loss and gradients at full width in bf16 and in
    fp32 from one init -- the trainer's own draw (``model.init``, seed 0,
    the reference's fan-in rule) or `fan_in_params` -- on one batch of
    8 x 1024: the loss gap and the lowest per-leaf cosine between the two
    gradients, each held to its bound (``BF16_BOUNDS``)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.train import steps
    model = build_model(cfg)
    params = (model.init(torch.Generator(device="cuda").manual_seed(0),
                         device="cuda") if init == "trainer"
              else fan_in_params(torch, cfg, seed=0))
    batch = train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, seed=5,
                        device="cuda")
    m16, g16 = steps.loss_and_grads(model, params, batch, TrainConfig())
    g16 = tree_leaves(g16)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params = tree_map(lambda t: t.float(), params)
    m32, g32 = steps.loss_and_grads(model32, params, batch, TrainConfig())
    del params
    cos = []
    for a, b in zip(g16, tree_leaves(g32)):
        a, b = a.double().flatten(), b.double().flatten()
        cos.append(float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300)))
    del g16, g32
    gap = abs(float(m16["loss"]) - float(m32["loss"]))
    max_gap, min_cos = BF16_BOUNDS[init]
    row = {"init": init, "loss_bf16": float(m16["loss"]),
           "loss_fp32": float(m32["loss"]), "loss_gap": gap,
           "min_leaf_cosine": min(cos), "leaf_cosines": cos,
           "bounds": {"loss_gap": max_gap, "min_leaf_cosine": min_cos}}
    log(f"training, bf16 vs fp32 ({init} init, full width, first step, "
        f"8 x 1024): loss {row['loss_bf16']:.6f} vs {row['loss_fp32']:.6f}, "
        f"gap {gap:.6f} (bound {max_gap}); lowest per-leaf gradient cosine "
        f"{min(cos):.6f} (bound {min_cos}); cosines "
        f"{[round(c, 6) for c in cos]}")
    assert gap <= max_gap and min(cos) >= min_cos, row
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_trace(torch, run) -> dict:
    """One more step of the trained state under the profiler (CPU and
    CUDA activity): the device time of the kernels launched in each of
    the step's record_function ranges -- forward, backward (its ops run
    on autograd's device thread, so a kernel is put in the range whose
    host interval holds its launch), optimizer -- and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import steps
    step = steps.make_train_step(run.model, run.pcfg, run.tcfg)
    batch = train_batch(torch, run.cfg, TRAIN_BATCH, TRAIN_SEQ, seed=7,
                        device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.state, m = step(run.state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    phases = ("forward", "backward", "optimizer")
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in phases:
            spans[e.name] = (e.time_range.start, e.time_range.end)
    assert sorted(spans) == sorted(phases), sorted(spans)
    device = {p: 0.0 for p in phases}
    busy = 0.0
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name not in phases:
                busy += e.time_range.elapsed_us()
                per[e.name] = per.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
        elif e.kernels and e.name not in phases:
            us = sum(float(k.duration) for k in e.kernels)
            at = e.time_range.start
            for p, (a, b) in spans.items():
                if a <= at <= b:
                    device[p] += us
                    break
    gemm = sum(us for name, us in per.items()
               if re.search(r"gemm|cutlass|xmma|nvjet|cublas", name, re.I))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    row = {"wall_us": wall * 1e6, "busy_us": busy,
           "busy_share": busy / (wall * 1e6), "device_us": device,
           "host_span_us": {p: b - a for p, (a, b) in spans.items()},
           "gemm_us": gemm, "top_kernels_us": top,
           "loss": float(m["loss"])}
    log(f"trace of one llama3.2-1b train step (8 x 1024, profiler on): "
        f"wall_us={wall * 1e6:.3f} device_busy_us={busy:.3f} "
        f"device_busy_share={row['busy_share']:.6f} "
        + " ".join(f"{p}_device_us={device[p]:.3f}" for p in phases)
        + " " + " ".join(f"{p}_host_us={row['host_span_us'][p]:.3f}"
                         for p in phases)
        + f" gemm_us={gemm:.3f}; top kernels (us): "
        + "; ".join(f"{name[:90]} {us:.3f}" for name, us in top))
    return row


def train_checkpoint(torch, run) -> dict:
    """The run's final checkpoint: its bytes and write seconds, and a
    restore that equals the state in memory bit for bit."""
    from repro_torch.models.common import tree_leaves
    info = run.ckpt.write_log[-1]
    t0 = time.perf_counter()
    restored, step = run.ckpt.restore(run.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert step == 30, step
    pairs = list(zip(tree_leaves(restored), tree_leaves(run.state)))
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_cuda
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            a.element_size()]
        assert torch.equal(a.view(bits), b.view(bits)), "restore differs"
    del restored, pairs
    row = {"step": info["step"], "bytes": info["bytes"],
           "write_s": info["write_s"], "snapshot_s": info["snapshot_s"],
           "restore_s": restore_s, "restore_bit_equal": True}
    log(f"training checkpoint at step {info['step']}: {info['bytes']} bytes, "
        f"snapshot {info['snapshot_s']:.3f} s, write {info['write_s']:.3f} s "
        f"({info['bytes'] / info['write_s'] / 1e9:.3f} GB/s); restore "
        f"{restore_s:.3f} s, bit for bit equal to the state in memory")
    return row


def train_scan(torch) -> dict:
    """The training scan (`ssm.chunked_scan`: 256-step chunks, a doubling
    scan in each) at Hymba's refill shape (B=1, S=2048, Di=3200, N=16,
    bf16 x): forward, and forward plus backward, against the forward-only
    kernel at the same shape, and its y against the kernel's."""
    from repro_torch.models import ssm
    from repro_torch.kernels.selective_scan.ops import selective_scan_op
    b, s, di, n = 1, 2048, 3200, 16
    g = torch.Generator(device="cuda").manual_seed(4)
    r = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    x = r(b, s, di).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(r(b, s, di) - 4)
    a = -torch.exp(r(di, n) * 0.5)
    bs, cs = r(b, s, n).to(torch.bfloat16), r(b, s, n).to(torch.bfloat16)
    d = torch.ones(di, device="cuda")
    with torch.no_grad():
        y_kernel, _ = selective_scan_op(x, dt, a, bs, cs, d)
        y_train, _ = ssm.chunked_scan(x, dt, a, bs, cs, d)
        fwd_ms = event_ms(torch, lambda: ssm.chunked_scan(
            x, dt, a, bs, cs, d), 5)
        kernel_ms = event_ms(torch, lambda: selective_scan_op(
            x, dt, a, bs, cs, d), 20)
    err = float((y_train.float() - y_kernel.float()).abs().max())
    scale = float(y_kernel.float().abs().max())
    assert err <= 2e-2 * max(scale, 1.0), (err, scale)
    xg = x.detach().requires_grad_()
    dtg = dt.detach().requires_grad_()

    def fwd_bwd():
        y, _ = ssm.chunked_scan(xg, dtg, a, bs, cs, d)
        y.float().sum().backward()
    both_ms = event_ms(torch, fwd_bwd, 5)
    row = {"shape": [b, s, di, n], "forward_ms": fwd_ms,
           "forward_backward_ms": both_ms, "kernel_forward_ms": kernel_ms,
           "max_abs_err_vs_kernel": err, "y_scale": scale}
    log(f"training scan (chunked, doubling, 256-step chunks) at B={b} S={s} "
        f"Di={di} N={n}: forward {fwd_ms:.6f} ms, forward+backward "
        f"{both_ms:.6f} ms; the forward-only kernel {kernel_ms:.6f} ms; "
        f"max |y - kernel y| {err:.3e} on |y| up to {scale:.3f}")
    return row


def training_phase(torch, kernels: dict) -> dict:
    """Trains Llama-3.2-1B at its published config through launch.train
    (a pilot, one compute unit per step), after the card-vs-CPU and
    bf16-vs-fp32 checks; then the 100m preset's recovery and options.
    Every kernel count is set to 0 before and read after: training runs
    none of the port's kernels (they are forward-only, and the JAX package
    trains through none of its Pallas kernels)."""
    import shutil
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    ckpt_root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    cfg = get_config("llama3_2_1b")
    zero_counts(kernels)
    card_cpu = train_card_vs_cpu(torch)
    mixed = {init: train_bf16_vs_fp32(torch, cfg, init)
             for init in ("fan_in", "trainer")}

    t0 = time.perf_counter()
    run = train_mod.run(TRAIN_ARGV + ["--ckpt-dir", str(ckpt_root / "full")])
    wall = time.perf_counter() - t0
    assert run.cfg == cfg and run.device.type == "cuda"
    assert len(run.losses) == 30 and all(map(math.isfinite, run.losses))
    last5 = sum(run.losses[-5:]) / 5
    assert last5 < run.losses[0], (run.losses[0], last5)
    steady = run.step_s[1:]                     # the first step warms up
    med = float(np.median(steady))
    flops = train_flops(cfg, run.tokens_per_step, TRAIN_SEQ)
    ckpt = train_checkpoint(torch, run)
    trace = train_trace(torch, run)
    full = {"params": cfg.num_params(), "steps": len(run.losses),
            "tokens_per_step": run.tokens_per_step,
            "median_step_ms": med * 1e3,
            "step_ms": [s * 1e3 for s in run.step_s],
            "tokens_per_s": run.tokens_per_step / med,
            "model_flops_per_step": flops,
            "model_flops_share_of_989T": flops / med / PEAK_BF16_FLOPS,
            "peak_bytes": run.peak_bytes, "first_loss": run.losses[0],
            "last5_mean_loss": last5, "losses": run.losses,
            "grad_norms": run.grad_norms,
            "run_wall_s": wall, "checkpoint": ckpt, "trace": trace}
    log(f"training llama3.2-1b (published config, {cfg.num_params()} "
        f"parameters, bf16, fp32 AdamW, remat full) on a pilot: 30 steps "
        f"of 8 x 1024 in {wall:.3f} s; median step {med * 1e3:.3f} ms "
        f"(steps 2-30), {run.tokens_per_step / med:.3f} tokens/s, "
        f"{flops:.6e} model FLOPs a step, "
        f"{full['model_flops_share_of_989T']:.6f} of 989 TFLOP/s; peak "
        f"device memory {run.peak_bytes / 1e9:.3f} GB; loss "
        f"{run.losses[0]:.6f} -> {run.losses[-1]:.6f} (last-5 mean "
        f"{last5:.6f})")
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # recovery and options at the 100m preset
    small = ["--arch", "llama3_2_1b", "--preset", "100m", "--log-every",
             "100"]
    rec_dir = ckpt_root / "recovery"
    rec = train_mod.run(small + ["--steps", "30", "--ckpt-every", "10",
                                 "--failure-at", "15", "--ckpt-dir",
                                 str(rec_dir)])
    latest = CheckpointManager(rec_dir / rec.cfg.name).latest_step()
    recovery = {"latest_step": latest, "loss": rec.loss,
                "steps_run": len(rec.losses)}
    assert latest == 30 and math.isfinite(rec.loss), recovery
    options = {}
    for name, extra in (("int8", ["--opt-dtype", "int8"]),
                        ("microbatches_2", ["--microbatches", "2"])):
        r = train_mod.run(small + ["--steps", "4", "--ckpt-dir",
                                   str(ckpt_root / name)] + extra)
        assert math.isfinite(r.loss), (name, r.loss)
        options[name] = r.loss
    launches = read_counts(kernels)
    assert not any(launches.values()), ("training launched a kernel",
                                        launches)
    log(f"training 100m preset: --failure-at 15 of 30 steps recovered, "
        f"latest checkpoint step {latest}, final loss {rec.loss:.6f}; "
        f"int8 state loss {options['int8']:.6f}, 2 microbatches loss "
        f"{options['microbatches_2']:.6f}; kernel launches in training "
        f"{launches}")
    del rec, r
    shutil.rmtree(ckpt_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    scan = train_scan(torch)
    return {"card_vs_cpu": card_cpu, "bf16_vs_fp32": mixed, "full": full,
            "recovery": recovery,
            "options": options, "launches": launches, "scan": scan}


# -- the sharded training phase ---------------------------------------------
# the training phase's Llama-3.2-1B run again, through launch.train under a
# one-rank NCCL process group: a ("data", "model") mesh of (1, 1), the state
# as DTensors, the sharded step; then compressed_pod_mean over a pod axis of
# 1 on a step's gradients, held to the reference test's bound
COMPRESSION_REL_BOUND = 0.02


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


ONE_RANK_STEPS = 3


def one_rank_variants(torch, model, mesh, kernels: dict) -> dict:
    """The published Llama-3.2-1B cell (8 x 1024) over the one-rank mesh
    `mesh`, `ONE_RANK_STEPS` steps from one seeded init and the same
    batches, under the sequence-parallel rules (``launch.autotune.SP``:
    at a ``model`` axis of 1 the residual stays whole) with float32
    AdamW state, and under the default rules with int8 state, each held
    to the unsharded step bit for bit: metrics, params and moments.  No
    kernel launches."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch.autotune import SP
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import AxisRules
    from repro_torch.train import steps as steps_mod
    sp = AxisRules()
    for logical, axes in SP:
        sp = sp.replacing(logical, axes)
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10)
    batches = [train_batch(torch, model.cfg, TRAIN_BATCH, TRAIN_SEQ,
                           200 + i, "cuda") for i in range(ONE_RANK_STEPS)]
    lengths = []
    layer = transformer.layer_forward

    def recorded(lp, x, *a, **k):
        lengths.append(x.shape[1])
        return layer(lp, x, *a, **k)

    out = {}
    transformer.layer_forward = recorded
    try:
        for name, rules, dtype in (("seq_parallel", sp, "float32"),
                                   ("int8_state", AxisRules(), "int8")):
            pcfg = ParallelConfig(opt_state_dtype=dtype)
            runs = []
            for sharded in (False, True):
                zero_counts(kernels)
                lengths.clear()
                torch.cuda.reset_peak_memory_stats()
                state = steps_mod.init_train_state(
                    model, torch.Generator(device="cuda").manual_seed(0),
                    pcfg, device="cuda")
                if sharded:
                    state = steps_mod.shard_train_state(
                        state, steps_mod.train_state_shardings(
                            model, mesh, rules, dtype))
                    step = steps_mod.make_sharded_train_step(
                        model, pcfg, tcfg, mesh, rules)
                else:
                    step = steps_mod.make_train_step(model, pcfg, tcfg)
                metrics, times = [], []
                for batch in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    metrics.append({k: float(v) for k, v in m.items()})
                    times.append((time.perf_counter() - t0) * 1e3)
                launches = read_counts(kernels)
                assert not any(launches.values()), launches
                whole = steps_mod.gather_state(state)
                runs.append({"metrics": metrics, "step_ms": times,
                             "peak_bytes": torch.cuda.max_memory_allocated(),
                             "residual": sorted(set(lengths)),
                             "leaves": [t.cpu() for t in tree_leaves(whole)]})
                del state, step, whole
                gc.collect()
                torch.cuda.empty_cache()
            assert runs[1]["metrics"] == runs[0]["metrics"], (name, runs)
            assert len(runs[1]["leaves"]) == len(runs[0]["leaves"])
            differ = []
            for i, (a_, b_) in enumerate(zip(runs[1]["leaves"],
                                             runs[0]["leaves"])):
                bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                    a_.element_size()]
                if a_.numel() == b_.numel():
                    # an int8 moment's blocks in the leaf's order, laid out
                    # by quant.block_layout
                    a_ = a_.reshape(b_.shape)
                if a_.dtype != b_.dtype or a_.shape != b_.shape:
                    differ.append((i, str(a_.dtype), str(b_.dtype),
                                   tuple(a_.shape), tuple(b_.shape)))
                elif not torch.equal(a_.view(bits), b_.view(bits)):
                    off = a_.float() != b_.float()
                    differ.append((i, tuple(a_.shape), int(off.sum()),
                                   float((a_.float() - b_.float()).abs()
                                         .max())))
            assert not differ, f"{name}: leaves differ {differ}"
            assert runs[1]["residual"] == [TRAIN_SEQ], runs[1]["residual"]
            out[name] = {"opt_state_dtype": dtype, "steps": ONE_RANK_STEPS,
                         "bit_equal": True,
                         "losses": [m["loss"] for m in runs[1]["metrics"]],
                         "sharded_step_ms": runs[1]["step_ms"],
                         "unsharded_step_ms": runs[0]["step_ms"],
                         "sharded_peak_bytes": runs[1]["peak_bytes"],
                         "unsharded_peak_bytes": runs[0]["peak_bytes"],
                         "residual_length": runs[1]["residual"]}
            log(f"one-rank NCCL mesh, {name} ({dtype} AdamW state): "
                f"{ONE_RANK_STEPS} steps bit-equal to the unsharded step "
                f"(metrics, params, moments); losses "
                f"{out[name]['losses']}; step ms sharded "
                f"{[round(t, 3) for t in runs[1]['step_ms']]} against "
                f"{[round(t, 3) for t in runs[0]['step_ms']]}; peak "
                f"{runs[1]['peak_bytes'] / 1e9:.3f} GB against "
                f"{runs[0]['peak_bytes'] / 1e9:.3f}; residual between "
                f"blocks {runs[1]['residual']} tokens")
            del runs
    finally:
        transformer.layer_forward = layer
    return out


def sharded_training_phase(torch, kernels: dict, unsharded: dict) -> dict:
    """Trains Llama-3.2-1B at its published config through
    ``launch.train.run`` over a one-rank NCCL mesh, the same 30 steps of
    the same batches as the unsharded run of `training_phase` (whose
    record is `unsharded`), and holds its losses and grad norms to that
    run's; its checkpoint (gathered, written by rank 0) restores through
    ``restore(shardings=)`` bit for bit; ``compressed_pod_mean`` runs on
    a step's gradients over a (1, 1, 1) pod x data x model mesh; the
    sequence-parallel rules and int8 AdamW state over the same mesh are
    each bit-equal to the unsharded step (`one_rank_variants`).  No
    kernel launches (asserted by the counts)."""
    import datetime
    import shutil
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import train as train_mod
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.compression import (compressed_pod_mean,
                                               init_residuals)
    from repro_torch.train import steps as steps_mod
    ckpt_root = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    torch.cuda.set_device(0)
    port = free_port()
    dist.init_process_group(                  # a failure here raises
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=600))
    try:
        zero_counts(kernels)
        t0 = time.perf_counter()
        run = train_mod.run(TRAIN_ARGV + ["--ckpt-dir", str(ckpt_root)])
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        assert not any(launches.values()), ("sharded training launched a "
                                            "kernel", launches)
        mesh = run.mesh
        assert mesh is not None and tuple(mesh.shape) == (1, 1), mesh
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert type(run.state.params["embed"]).__name__ == "DTensor"
        pairs = {"loss": (run.losses, unsharded["losses"]),
                 "grad_norm": (run.grad_norms, unsharded["grad_norms"])}
        diffs = {k: max(abs(a - b) for a, b in zip(*v))
                 for k, v in pairs.items()}
        bit_equal = {k: v[0] == v[1] for k, v in pairs.items()}
        assert len(run.losses) == len(unsharded["losses"]) == 30
        log(f"sharded training, largest difference to the unsharded run: "
            f"{diffs}; bit-equal {bit_equal}")
        assert all(bit_equal.values()), (
            "a one-rank mesh must train bit for bit as one device", diffs)
        med = float(np.median(run.step_s[1:]))
        med10 = float(np.median(run.step_s[1:10]))
        unsharded_med10 = float(np.median(unsharded["step_ms"][1:10]))
        # the checkpoint: gathered, written by rank 0, restored by shard
        info = run.ckpt.write_log[-1]
        t1 = time.perf_counter()
        restored, step = run.ckpt.restore(
            run.state, shardings=steps_mod.train_state_shardings(
                run.model, mesh))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        assert step == 30, step
        for a, b in zip(tree_leaves(restored), tree_leaves(run.state)):
            assert type(a) is type(b)
            a = a.to_local() if hasattr(a, "to_local") else a
            b = b.to_local() if hasattr(b, "to_local") else b
            assert a.dtype == b.dtype and a.shape == b.shape and a.is_cuda
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                a.element_size()]
            assert torch.equal(a.view(bits), b.view(bits)), "restore differs"
        del restored
        # EF-int8 compression of a step's gradients over a pod axis of 1
        pod_mesh = init_device_mesh("cuda", (1, 1, 1),
                                    mesh_dim_names=("pod", "data", "model"))
        params = steps_mod.gather_state(run.state.params)
        batch = train_batch(torch, run.cfg, TRAIN_BATCH, TRAIN_SEQ, 7, "cuda")
        _, grads = steps_mod.loss_and_grads(run.model, params, batch,
                                            run.tcfg)
        del params, batch
        # twice: the first call also sets up the pod group's communicator
        times = []
        for _ in range(2):
            residuals = init_residuals(grads)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            means, residuals = compressed_pod_mean(grads, residuals,
                                                   pod_mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        compress_ms = times[-1]
        rel = max(float((m.float() - g.float()).abs().max())
                  / max(float(g.float().abs().max()), 1e-30)
                  for m, g in zip(tree_leaves(means), tree_leaves(grads)))
        res_norm = math.sqrt(sum(float(r.square().sum())
                                 for r in tree_leaves(residuals)))
        assert rel < COMPRESSION_REL_BOUND and res_norm > 0, (rel, res_norm)
        grad_bytes = sum(g.numel() * g.element_size()
                         for g in tree_leaves(grads))
        del grads, means, residuals
        model = run.model
        run.state = None                    # the variants draw their own
        gc.collect()
        torch.cuda.empty_cache()
        variants_t0 = time.perf_counter()
        variants = one_rank_variants(torch, model, mesh, kernels)
        variants_s = time.perf_counter() - variants_t0
        row = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "backend": dist.get_backend(), "steps": len(run.losses),
               "losses": run.losses, "grad_norms": run.grad_norms,
               "max_abs_diff_vs_unsharded": diffs, "bit_equal": bit_equal,
               "median_step_ms": med * 1e3,
               "unsharded_median_step_ms": unsharded["median_step_ms"],
               "median_step_ms_2_10": med10 * 1e3,
               "unsharded_median_step_ms_2_10": unsharded_med10,
               "step_ms": [t * 1e3 for t in run.step_s],
               "peak_bytes": run.peak_bytes,
               "unsharded_peak_bytes": unsharded["peak_bytes"],
               "run_wall_s": wall, "launches": launches,
               "checkpoint": {"step": info["step"], "bytes": info["bytes"],
                              "snapshot_s": info["snapshot_s"],
                              "write_s": info["write_s"],
                              "restore_s": restore_s,
                              "restore_bit_equal": True},
               "compression": {"mesh": {"pod": 1, "data": 1, "model": 1},
                               "max_rel_err": rel, "bound":
                               COMPRESSION_REL_BOUND,
                               "residual_norm": res_norm,
                               "grad_bytes": grad_bytes, "ms": compress_ms,
                               "first_call_ms": times[0]},
               "one_rank_variants": variants,
               "one_rank_variants_s": variants_s}
        log(f"sharded training llama3.2-1b (published config) over a "
            f"one-rank NCCL mesh {row['mesh']}: 30 steps in {wall:.3f} s; "
            f"median step {med * 1e3:.3f} ms against "
            f"{unsharded['median_step_ms']:.3f} unsharded (steps 2-30), "
            f"{med10 * 1e3:.3f} against {unsharded_med10:.3f} (steps "
            f"2-10); peak device "
            f"memory {run.peak_bytes / 1e9:.3f} GB against "
            f"{unsharded['peak_bytes'] / 1e9:.3f}; losses and grad norms "
            f"bit-equal to the unsharded run; checkpoint "
            f"{info['bytes']} bytes (snapshot {info['snapshot_s']:.3f} s, "
            f"write {info['write_s']:.3f} s), restore(shardings=) "
            f"{restore_s:.3f} s, bit for bit; compressed_pod_mean over "
            f"{grad_bytes} bytes of gradients in {compress_ms:.3f} ms (first "
            f"call {times[0]:.3f} ms), max "
            f"relative error {rel:.6f} (bound {COMPRESSION_REL_BOUND}), "
            f"residual norm {res_norm:.6f}; kernel launches {launches}")
        del run, model
        dist.barrier()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckpt_root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return row


# -- the dry-run phase ---------------------------------------------------------
# the sharded training cell above (Llama-3.2-1B at its published config,
# 8 x 1024, bf16, fp32 AdamW, remat full, mesh (1, 1)) planned by
# launch.dryrun on fake tensors over a fake one-rank group, in a process of
# its own (a fake default group never shares a process with a real one)
PLAN_PEAK_RTOL = 0.25
PLAN_DIR = ROOT / "build" / "dryrun_card"
PLAN_ARGV = ["-m", "repro_torch.launch.dryrun", "--arch", "llama3_2_1b",
             "--shape", "train_4k", "--batch", "8", "--seq", "1024",
             "--mesh", "1x1", "--force", "--out", str(PLAN_DIR)]
PLAN_RECORD = PLAN_DIR / "llama3_2_1b__train_4k_b8_s1024__1x1.json"


def dryrun_phase(torch, card: str, sharded: dict, unsharded: dict) -> dict:
    """Plans the sharded training cell on the CPU (``launch.dryrun``, a
    subprocess that sees no card) and holds the plan to this run's
    measurement of the same cell: the roofline time (a lower bound) at
    most the measured median step, the planned peak within
    PLAN_PEAK_RTOL of ``max_memory_allocated``.  Also checks that
    ``HBM_PER_CHIP`` is the card's total memory."""
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"dry-run: HBM_PER_CHIP {HBM_PER_CHIP} bytes, the card's "
        f"total_memory {total} bytes ({card})")
    assert total == HBM_PER_CHIP, (total, HBM_PER_CHIP)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable] + PLAN_ARGV, cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                                     "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    rec = json.loads(PLAN_RECORD.read_text())
    assert rec["status"] == "ok", rec
    r = rec["roofline"]
    step_ms, peak = sharded["median_step_ms"], sharded["peak_bytes"]
    roof_ms = r["roofline_time"] * 1e3
    row = {"t_compute_ms": r["t_compute"] * 1e3,
           "t_memory_ms": r["t_memory"] * 1e3,
           "t_collective_ms": r["t_collective"] * 1e3,
           "bottleneck": r["bottleneck"], "roofline_ms": roof_ms,
           "flops": r["flops_per_device"], "bytes": r["bytes_per_device"],
           "measured_step_ms": step_ms,
           "unsharded_step_ms": unsharded["median_step_ms"],
           "step_over_roofline": step_ms / roof_ms,
           "planned_peak_bytes": r["peak_mem_bytes"],
           "measured_peak_bytes": peak,
           "peak_ratio": r["peak_mem_bytes"] / peak,
           "top_opcode_bytes": r["extras"]["top_opcode_bytes"],
           "plan_s": rec["plan_s"], "subprocess_s": wall,
           "total_memory": total}
    log(f"dry-run plan of llama3.2-1b training (published config, 8 x "
        f"1024, mesh (1, 1)): t_compute {row['t_compute_ms']:.3f} ms, "
        f"t_memory {row['t_memory_ms']:.3f} ms, t_collective "
        f"{row['t_collective_ms']:.3f} ms, bottleneck {r['bottleneck']}, "
        f"roofline {roof_ms:.3f} ms against the measured median step "
        f"{step_ms:.3f} ms (sharded; {unsharded['median_step_ms']:.3f} "
        f"unsharded), step/roofline {row['step_over_roofline']:.4f}; "
        f"planned in {rec['plan_s']:.3f} s ({wall:.3f} s with the "
        f"process); {card}")
    log(f"dry-run plan: peak {r['peak_mem_bytes'] / 1e9:.3f} GB against "
        f"max_memory_allocated {peak / 1e9:.3f} GB, planned/measured "
        f"{row['peak_ratio']:.4f} (bound 1 +- {PLAN_PEAK_RTOL}); {card}")
    assert roof_ms <= step_ms, ("the roofline exceeds the measured step",
                                row)
    assert abs(row["peak_ratio"] - 1) <= PLAN_PEAK_RTOL, row
    return row


# -- the elastic phases -------------------------------------------------------
# elastic serving: a burst of 32 requests on one Llama-3.2-1B replica, a
# fleet of at most 3 pilots on the one card
ELASTIC_REQUESTS, ELASTIC_MAX_PILOTS, ELASTIC_MEMORY_GB = 32, 3, 4
# resilient training: the 100m preset, 12 steps of 8 x 512, a checkpoint
# every 4 steps, the first pilot lost after 7 compute units
RESILIENT_STEPS, RESILIENT_EVERY, RESILIENT_FAIL_AT = 12, 4, 7
RESILIENT_BATCH, RESILIENT_SEQ = 8, 512
# elastic KMeans: the rebalancer idles (a skew no placement reaches, busy
# pilots' bytes weighing up to 3x) while KMeans runs and the node dies, so
# that no migration allocates on the card while the kill's release is
# read; once the fleet is repaired it moves at 1.2x the mean pressure
REBALANCE_IDLE_SKEW, REBALANCE_SKEW = 8.0, 1.2


def runtime_ready(eng, pilot) -> bool:
    return (eng.name, "runtime") in pilot._jit_cache


def elastic_serving_phase(torch, core, cfg, params, kernels: dict) -> dict:
    """Llama-3.2-1B at full width on an elastic, supervised session: a
    burst of 32 requests lands on one replica; the autoscaler scales out
    on the queue wait (the reaper adopts each newcomer as a replica); then
    the first replica, holding rows in flight, is scaled in by hand: its
    requests are handed off through drain_replica and re-prefilled on the
    survivors.  Held against the same 32 requests on one undisturbed
    replica: the tokens of each handed-off request up to the handoff."""
    from repro_torch.core import LoadScalingPolicy
    from repro_torch.core.backends.base import register_backend
    from repro_torch.core.backends.simulated import SimulatedClusterBackend
    from repro_torch.core.taskengine import current_pilot
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServingEngine

    rng = np.random.default_rng(1)
    lens = itertools.islice(itertools.cycle(PROMPT_LENS), ELASTIC_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    n = len(prompts)
    alone = serve(torch, core, cfg, params, prompts, kernels,
                  max_len=SERVE_MAX_LEN, memory_gb=ELASTIC_MEMORY_GB)
    gc.collect()
    torch.cuda.empty_cache()
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    kv_bytes = (2 * cfg.num_layers * SERVE_BATCH * SERVE_MAX_LEN
                * cfg.num_kv_heads * cfg.resolved_head_dim * 2)

    model = build_model(cfg)
    firsts = {}                 # pilot id -> wall clock of its first token
    inner = model.prefill

    def prefill(p, batch, max_len):
        out = inner(p, batch, max_len)
        pilot = current_pilot()
        if pilot is not None and pilot.id not in firsts:
            torch.cuda.current_stream().synchronize()
            firsts[pilot.id] = time.time()
        return out

    model = dataclasses.replace(model, prefill=prefill)
    register_backend(SimulatedClusterBackend(substrate="slurm"))
    # scale-out after 0.25 s of queue wait held for 2 ticks; the scale-in
    # is the phase's own (by hand, mid-stream): the policy's waits for 10 s
    # of cold signal, longer than the burst
    policy = LoadScalingPolicy(serving_wait_s=0.25, hysteresis=2,
                               in_hysteresis=200)
    ready = {}                  # pilot id -> wall clock its runtime was seen

    def note_ready(s, eng):
        for p in s.pilots:
            if p.id not in ready and runtime_ready(eng, p):
                ready[p.id] = time.time()

    with core.PilotSession(
            supervise=True, autoscale=True, min_pilots=1,
            max_pilots=ELASTIC_MAX_PILOTS,
            autoscaler_kwargs={"policy": policy, "interval_s": 0.05,
                               "cooldown_s": 0.5}) as s:
        (first,) = s.add_pilots(1, backend="simulated",
                                memory_gb=ELASTIC_MEMORY_GB)
        auto = s.autoscaler
        with ServingEngine(s, model, params=params, batch_size=SERVE_BATCH,
                           max_len=SERVE_MAX_LEN, page_tokens=16) as eng:
            eng.deploy()
            deadline = time.monotonic() + 300
            while not runtime_ready(eng, first):
                assert time.monotonic() < deadline, "no runtime in 300 s"
                time.sleep(0.01)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(kernels)
            t0 = time.perf_counter()
            reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
            # the queue wait grows the fleet to its maximum
            deadline = time.monotonic() + 120
            while True:
                note_ready(s, eng)
                grown = [p for p in s.pilots if p is not first]
                if (len(grown) == ELASTIC_MAX_PILOTS - 1
                        and all(p.id in ready for p in grown)):
                    break
                assert time.monotonic() < deadline, (
                    "the fleet did not grow", auto.stats()["decisions"])
                time.sleep(0.005)
            in_flight = len(eng._replicas[first.id].active)
            queued_then = len(eng._replicas[first.id].queue)
            assert in_flight > 0, ("the first replica finished before the "
                                   "fleet grew")
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            released = auto.scale_in(first, reason="handoff of a replica "
                                     "holding rows")
            drain_s = time.perf_counter() - t1
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            assert released is first, auto.stats()["decisions"][-1]
            eng.drain(timeout=900)
            wall = time.perf_counter() - t0
            launches = read_counts(kernels)
            outs = [r.result(timeout=10) for r in reqs]
            handed = {i: len(r.prior) for i, r in enumerate(reqs)
                      if r.recoveries}
            st = eng.stats()
            peak = torch.cuda.max_memory_allocated()
            note_ready(s, eng)
        ast = auto.stats()
    freed = before - after
    prefills = st["waves"] + st["refills"]
    alone_prefills = alone["stats"]["waves"] + alone["stats"]["refills"]
    assert st["completed"] == n, st
    assert all(len(o) == SERVE_GEN for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert st["tokens_served"] >= n * SERVE_GEN, st
    assert handed, "no request was handed off"
    for i, kept in handed.items():
        assert outs[i][:kept] == alone["outs"][i][:kept], (
            f"request {i}: the tokens before the handoff differ", kept)
    tails = sum(outs[i] != alone["outs"][i] for i in handed)
    assert launches["decode_attention"] == (
        cfg.num_layers * st["decode_steps"]) > 0, (launches, st)
    assert launches["decode_attention_tc"] == launches["decode_attention"]
    assert launches["flash_attention"] == cfg.num_layers * prefills, (
        launches, st)
    assert launches["flash_attention_fp32"] == 0, launches
    # the re-prefills of the handed-off requests
    assert prefills > alone_prefills, (prefills, alone_prefills)
    assert (launches["flash_attention"]
            - alone["launches"]["flash_attention"]) == (
        cfg.num_layers * (prefills - alone_prefills))
    outs_d = [d for d in ast["decisions"] if d["action"] == "scale-out"]
    ins_d = [d for d in ast["decisions"] if d["action"] == "scale-in"]
    assert ast["counters"]["scale_outs"] >= 1 and outs_d, ast["counters"]
    assert ast["counters"]["scale_ins"] >= 1 and ins_d, ast["counters"]
    assert all(d["signals"].get("n_pilots", 0) >= 1
               for d in outs_d + ins_d), "a decision without its signals"
    assert "serving wait" in outs_d[0]["reason"], outs_d[0]["reason"]
    handoff = next(d for d in ins_d if d["pilot"] == first.id)
    assert handoff["detail"]["serving_handoff"] >= in_flight, handoff
    # the drained replica's weights and KV cache were released: the
    # survivors may have allocated a KV cache each and their re-prefills'
    # temporaries meanwhile, together below 3 caches
    assert freed >= param_bytes - 3 * kv_bytes, (freed, param_bytes,
                                                 kv_bytes)
    scale_outs = [{"pilot": d["pilot"], "reason": d["reason"],
                   "ready_s": (ready[d["pilot"]] - d["t"]
                               if d["pilot"] in ready else None),
                   "first_token_s": (firsts[d["pilot"]] - d["t"]
                                     if d["pilot"] in firsts else None),
                   "serving_wait_s": d["signals"]["serving_wait_s"],
                   "serving_queued": d["signals"]["serving_queued"]}
                  for d in outs_d]
    row = {"requests": n, "gen": SERVE_GEN, "wall_s": wall,
           "tokens_per_s": n * SERVE_GEN / wall,
           "tokens_served": st["tokens_served"],
           "decode_steps": st["decode_steps"], "prefills": prefills,
           "p50_latency_s": st["p50_latency_s"],
           "p99_latency_s": st["p99_latency_s"],
           "undisturbed": {"wall_s": alone["wall_s"],
                           "tokens_per_s": n * SERVE_GEN / alone["wall_s"],
                           "p50_latency_s": alone["stats"]["p50_latency_s"],
                           "p99_latency_s": alone["stats"]["p99_latency_s"],
                           "decode_steps": alone["stats"]["decode_steps"],
                           "prefills": alone_prefills,
                           "peak_bytes": alone["peak_bytes"]},
           "scale_outs": scale_outs, "drain_s": drain_s,
           "in_flight_at_handoff": in_flight,
           "queued_at_handoff": queued_then,
           "handed_off": len(handed),
           "handed_off_tokens_kept": sorted(handed.values()),
           "bf16_tails_differing": tails,
           "recovered_requests": st["recovered_requests"],
           "drained_replicas": st["drained_replicas"],
           "freed_bytes_at_scale_in": freed,
           "replica_param_bytes": param_bytes, "replica_kv_bytes": kv_bytes,
           "peak_bytes": peak, "launches": launches,
           "undisturbed_launches": alone["launches"],
           "autoscaler_counters": ast["counters"]}
    timing = [(o["ready_s"], o["first_token_s"]) for o in scale_outs]
    log(f"elastic serving llama3.2-1b full width, {n} requests at batch "
        f"{SERVE_BATCH} on 1 -> {ELASTIC_MAX_PILOTS} pilots: "
        f"{n * SERVE_GEN} tokens in {wall:.6f} s "
        f"({n * SERVE_GEN / wall:.3f} tok/s; one undisturbed replica "
        f"{n * SERVE_GEN / alone['wall_s']:.3f}); p50/p99 latency "
        f"{st['p50_latency_s']:.6f}/{st['p99_latency_s']:.6f} s "
        f"(undisturbed {alone['stats']['p50_latency_s']:.6f}/"
        f"{alone['stats']['p99_latency_s']:.6f}); scale-outs (decision -> "
        f"runtime ready, -> first token, s) {timing}; drain {drain_s:.6f} s "
        f"handing off {len(handed)} requests ({in_flight} in rows, "
        f"{queued_then} queued; tokens kept {sorted(handed.values())}), "
        f"{tails} with bf16 tails that differ from the undisturbed run "
        f"after the handoff; freed {freed / 1e9:.3f} GB at scale-in "
        f"(replica weights {param_bytes / 1e9:.3f} GB, KV cache "
        f"{kv_bytes / 1e9:.3f} GB); peak device memory {peak / 1e9:.3f} GB; "
        f"prefills {prefills} (undisturbed {alone_prefills}); launches "
        f"{launches}; autoscaler {ast['counters']}")
    return {"row": row, "launches": launches,
            "undisturbed_launches": alone["launches"]}


def elastic_kmeans(torch, core, pts, k: int, kernel_mod, kill: bool) -> dict:
    """Scenario (i) over the device tiers of three simulated slurm pilots
    (each partition on two of them) in a supervised, rebalancing session.
    With `kill`, the second pilot's node is lost after iteration 1 (a
    kill armed on it and fired by a health() probe; the backend's
    ChaosPolicy wipes its memory), the supervisor respawns it and repairs
    the replication, and one more pilot is then added by hand for the
    rebalancer to move partitions onto."""
    import threading
    from repro_torch.core import InterconnectModel
    from repro_torch.core.backends.base import register_backend
    from repro_torch.core.backends.simulated import (ChaosEvent, ChaosPolicy,
                                                     SimulatedClusterBackend)
    from repro_torch.core.pilot import State
    be = SimulatedClusterBackend(
        substrate="slurm", policy=ChaosPolicy(lose_memory=True,
                                              target_index=1))
    register_backend(be)
    rec = {}
    calls = []                                  # (thread name, clock)
    lock = threading.Lock()

    def map_fn(points, centroids):
        with lock:
            calls.append((threading.current_thread().name,
                          time.monotonic()))
        return core.assign_partial(points, centroids)

    with core.PilotSession(
            supervise=True, rebalance=True, interconnect=InterconnectModel(),
            supervisor_kwargs={"interval_s": 0.02, "min_heartbeat_s": 0.05,
                               "repair_interval_s": 0.05},
            rebalancer_kwargs={"tier": "device", "skew": REBALANCE_IDLE_SKEW,
                               "interval_s": 0.05}) as s:
        pilots = s.add_pilots(3, backend="simulated", memory_gb=1)
        target = pilots[1]
        pds = s.data_service
        du = s.data("points", pts, parts=PARTS)
        for i in range(PARTS):        # two device replicas: 5/6/5 a pilot
            for p in (pilots[i % 3], pilots[(i + 1) % 3]):
                pds.replicate(du, i, p.id, "device")
        pds.register(du, replication=2)     # the target, once placed
        # what was quarantined when the rebalancer started each move
        moves_seen = []
        replicate = pds.replicate

        def recorded(du_, i, pid, tier="device", pin=False):
            if threading.current_thread().name == "pilot-rebalancer":
                moves_seen.append((i, pid, frozenset(
                    set(s.manager.policy.quarantined) | set(pds.avoided)
                    | set(s.supervisor.quarantined))))
            return replicate(du_, i, pid, tier, pin)

        pds.replicate = recorded

        def on_iteration(i, sse):
            if i != 1 or not kill:
                return
            tm = target.tier_manager
            torch.cuda.synchronize()
            rec["before"] = torch.cuda.memory_allocated()
            rec["held"] = tm.usage("device")
            rec["held_parts"] = len(tm.resident_keys("device"))
            target.arm_chaos((ChaosEvent(at_s=0.0, action="kill"),))
            rec["t_kill"] = time.monotonic()
            be.health(target)                   # the probe fires the kill
            deadline = time.monotonic() + 5
            while not any(e["op"] == "lose-volatile" for e in tm.events):
                assert time.monotonic() < deadline, "the kill never fired"
                time.sleep(0.001)
            torch.cuda.synchronize()
            rec["after"] = torch.cuda.memory_allocated()
            # FAILED, or already CANCELED by the supervisor's release
            assert target.state is not State.RUNNING, target.state

        kernel_mod.LAUNCHES = 0
        res = s.kmeans(du, k=k, iters=ITERS, map_fn=map_fn,
                       on_iteration=on_iteration)
        torch.cuda.synchronize()
        out = {"sse": res.sse_history, "centroids": res.centroids,
               "iter_s": res.iter_seconds, "launches": kernel_mod.LAUNCHES,
               "map_calls": len(calls)}
        if not kill:
            return out
        sup = s.supervisor
        deadline = time.monotonic() + 60
        while True:
            rs = pds.replication_stats()["points"]
            if (sup.respawns and rs["under"] == 0
                    and min(rs["per_partition"].values()) >= 2):
                break
            assert time.monotonic() < deadline, ("repair incomplete", rs)
            time.sleep(0.01)
        repair_s = time.monotonic() - rec["t_kill"]
        respawn = sup.respawns[0]
        assert respawn.old_pilot == target.id, respawn
        # one more pilot, by hand: skew for the rebalancer to move
        assert not s.rebalancer.stats()["migrations"]
        s.rebalancer.skew = REBALANCE_SKEW
        t0 = time.perf_counter()
        grown = s.add_pilot(backend="simulated", memory_gb=1)
        grow_s = time.perf_counter() - t0
        deadline = time.monotonic() + 30
        while not s.rebalancer.stats()["migrations"]:
            assert time.monotonic() < deadline, s.rebalancer.stats()
            time.sleep(0.01)
        time.sleep(0.2)                         # let the round finish
        rb = s.rebalancer.stats()
        parts = np.array_split(pts, PARTS)
        for m in rb["migrations"]:
            assert m["cost_s"] > 0, m                  # priced
            bad = next(q for i, pid, q in moves_seen
                       if (i, pid) == (m["part"], m["dst"]))
            assert not {m["src"], m["dst"]} & (bad | {target.id}), m
            tm = pds.manager_for(m["dst"])
            key = du._key(m["part"])
            if tm is not None and tm.tier_of(key) == "device":
                got = tm.backends["device"].get_device(key)
                assert got.device == s.compute.pilots[m["dst"]].devices[0]
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              parts[m["part"]])
        rs = pds.replication_stats()["points"]
        assert rs["under"] == 0 and min(rs["per_partition"].values()) >= 2
        wasted = sum(1 for name, t in calls
                     if name.startswith(target.id) and t >= rec["t_kill"])
    out.update({
        "killed": target.id, "respawned_as": respawn.new_pilot,
        "respawn_s": respawn.downtime_s, "held_bytes": rec["held"],
        "held_partitions": rec["held_parts"],
        "freed_bytes": rec["before"] - rec["after"], "repair_s": repair_s,
        "grown": grown.id, "grow_provision_s": grown.provision_time,
        "grow_s": grow_s, "wasted_map_calls": wasted,
        "replication": rs["per_partition"],
        "migrations": rb["migrations"], "rebalancer": rb["counters"]})
    return out


def elastic_kmeans_phase(torch, core, kernel_mod) -> dict:
    """The paper's scenario (i) (1M x K=50, D=8, f32, 8 partitions, two
    replicas each) through a pilot loss, a repair and a rebalance, held
    to an undisturbed run of the same seed at the tolerance the main path
    holds the card to the CPU with; then one pilot provisioned on each
    simulated substrate (the paper's Fig. 6 provisioning ratios)."""
    from repro_torch.core import PilotComputeDescription
    from repro_torch.core.analytics import PAPER_SCENARIOS, make_blobs
    from repro_torch.core.backends.base import register_backend
    from repro_torch.core.backends.simulated import (SUBSTRATES,
                                                     SimulatedClusterBackend)
    n, k = PAPER_SCENARIOS["i"]
    pts, _ = make_blobs(n, min(k, 256), d=D, seed=3)
    calm = elastic_kmeans(torch, core, pts, k, kernel_mod, kill=False)
    assert calm["launches"] == ITERS * PARTS == calm["map_calls"], calm
    hit = elastic_kmeans(torch, core, pts, k, kernel_mod, kill=True)
    np.testing.assert_allclose(hit["sse"], calm["sse"], rtol=1e-4)
    np.testing.assert_allclose(hit["centroids"], calm["centroids"],
                               atol=1e-3)
    assert hit["launches"] == hit["map_calls"] == (
        ITERS * PARTS + hit["wasted_map_calls"]), hit
    assert hit["freed_bytes"] >= hit["held_bytes"] > 0, hit
    assert hit["rebalancer"]["migrations"] >= 1, hit["rebalancer"]
    provision = {}
    for sub in SUBSTRATES:
        be = SimulatedClusterBackend(substrate=sub)
        pilot = be.provision(PilotComputeDescription(backend="simulated",
                                                     memory_gb=1))
        provision[sub] = pilot.provision_time
        be.release(pilot)
    register_backend(SimulatedClusterBackend())
    ratios = {sub: t / provision["slurm"] for sub, t in provision.items()}
    row = {"points": n, "k": k, "parts": PARTS, "replication": 2,
           "sse": hit["sse"], "sse_undisturbed": calm["sse"],
           "max_abs_dcentroids": float(np.abs(
               hit["centroids"] - calm["centroids"]).max()),
           "iter_s": hit["iter_s"], "iter_s_undisturbed": calm["iter_s"],
           "launches": hit["launches"],
           "launches_undisturbed": calm["launches"],
           "wasted_map_calls": hit["wasted_map_calls"],
           "held_bytes": hit["held_bytes"],
           "held_partitions": hit["held_partitions"],
           "freed_bytes": hit["freed_bytes"], "repair_s": hit["repair_s"],
           "respawn_s": hit["respawn_s"],
           "grow_provision_s": hit["grow_provision_s"],
           "replication_after": hit["replication"],
           "migrations": hit["migrations"], "rebalancer": hit["rebalancer"],
           "provision_s": provision, "provision_ratio_to_slurm": ratios}
    moves = [(m["part"], m["cost_s"]) for m in hit["migrations"]]
    log(f"elastic kmeans scenario i N={n} K={k} D={D} over 3 simulated "
        f"slurm pilots (2 device replicas a partition): the kill of "
        f"{hit['killed']} after iteration 1 freed {hit['freed_bytes']} "
        f"bytes of device memory (it held {hit['held_bytes']} in "
        f"{hit['held_partitions']} partitions); sse={hit['sse']} "
        f"(undisturbed {calm['sse']}); iter_s={hit['iter_s']} (undisturbed "
        f"{calm['iter_s']}); launches {hit['launches']} (undisturbed "
        f"{calm['launches']}, wasted {hit['wasted_map_calls']}); respawn "
        f"{hit['respawn_s']:.6f} s, replication restored "
        f"{hit['repair_s']:.6f} s after the kill; a pilot added by hand in "
        f"{hit['grow_s']:.6f} s; rebalancer {hit['rebalancer']}, moves "
        f"(partition, priced s) {moves}; provisioning s {provision} "
        f"(x slurm {ratios})")
    return row


def resilient_training_phase(torch, kernels: dict) -> dict:
    """The port's train step through ResilientRunner: the 100m preset
    (8 layers, d 768), 12 steps of 8 x 512 tokens, a checkpoint every 4
    steps, on a simulated pilot whose node is lost after 7 compute units
    (FaultPolicy(fail_devices_at=7)); the replacement comes from a
    healthy allocation.  Held to an uninterrupted 12-step run from the
    same init and batches.  No kernel runs in training."""
    import shutil
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core import PilotComputeDescription, PilotComputeService
    from repro_torch.core.backends.base import register_backend
    from repro_torch.core.backends.simulated import (FaultPolicy,
                                                     SimulatedClusterBackend)
    from repro_torch.launch.train import scaled_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.runtime.fault_tolerance import ResilientRunner
    from repro_torch.train import steps as steps_mod

    cfg = scaled_config("llama3_2_1b", "100m")
    model = build_model(cfg)
    pcfg = ParallelConfig()
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=RESILIENT_STEPS,
                       warmup_steps=2)
    step = steps_mod.make_train_step(model, pcfg, tcfg)
    root = ROOT / "build" / "resilient_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def init():
        return steps_mod.init_train_state(
            model, torch.Generator(device="cuda").manual_seed(0), pcfg,
            device="cuda")

    def batch(i):
        return train_batch(torch, cfg, RESILIENT_BATCH, RESILIENT_SEQ,
                           seed=1000 + i, device="cuda")

    def run(desc, doomed=None):
        svc = PilotComputeService()
        try:
            runner = ResilientRunner(
                svc, desc, CheckpointManager(root / desc.backend),
                checkpoint_every=RESILIENT_EVERY, max_recoveries=3)
            if doomed is not None:
                # the job starts on a node that will be lost; the
                # replacement comes from a healthy allocation (a faulty
                # backend's policy would hold for its replacement too)
                register_backend(doomed)
                runner.pilot = svc.submit_pilot(desc)
                register_backend(SimulatedClusterBackend(substrate="slurm"))
            t0 = time.perf_counter()
            final, metrics = runner.run(init(), step, RESILIENT_STEPS,
                                        batch_fn=batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return final, [float(m["loss"]) for m in metrics], runner, wall
        finally:
            svc.cancel_all()

    zero_counts(kernels)
    want, want_losses, _, plain_s = run(
        PilotComputeDescription(backend="inprocess"))
    got, losses, runner, wall = run(
        PilotComputeDescription(backend="simulated"),
        doomed=SimulatedClusterBackend(
            substrate="slurm",
            policy=FaultPolicy(fail_devices_at=RESILIENT_FAIL_AT)))
    launches = read_counts(kernels)
    register_backend(SimulatedClusterBackend())
    shutil.rmtree(root, ignore_errors=True)
    assert not any(launches.values()), ("training launched a kernel",
                                        launches)
    assert len(runner.recoveries) == 1, runner.recoveries
    ev = runner.recoveries[0]
    assert ev.step == RESILIENT_FAIL_AT and ev.restored_step in (4, 8), ev
    assert all(map(math.isfinite, losses)), losses
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    max_abs = max(float((a.float() - b.float()).abs().max())
                  for a, b in pairs)
    for a, b in pairs:
        # within two bf16 ulps of each param (fp32 moments far inside)
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=1e-6)
    r = ev.restored_step
    assert len(losses) == RESILIENT_STEPS + ev.step - r, losses
    # the steps both runs took from the same state: 0..6, then r..11
    losses_equal = (losses[:ev.step] == want_losses[:ev.step]
                    and losses[ev.step:] == want_losses[r:])
    row = {"preset": "100m",
           "params": sum(t.numel() for t in tree_leaves(want.params)),
           "steps": RESILIENT_STEPS, "checkpoint_every": RESILIENT_EVERY,
           "fail_devices_at": RESILIENT_FAIL_AT,
           "recoveries": [dataclasses.asdict(e) for e in runner.recoveries],
           "downtime_s": ev.downtime_s, "bit_equal": bit_equal,
           "losses_equal": losses_equal, "max_abs_diff": max_abs,
           "losses": losses, "uninterrupted_losses": want_losses,
           "wall_s": wall, "uninterrupted_wall_s": plain_s,
           "launches": launches}
    log(f"resilient training 100m preset ({row['params']} parameters), "
        f"{RESILIENT_STEPS} steps of {RESILIENT_BATCH} x {RESILIENT_SEQ}, "
        f"checkpoint every {RESILIENT_EVERY}: pilot lost at step {ev.step}, "
        f"restored step {r} on {ev.new_pilot} after {ev.downtime_s:.6f} s "
        f"of downtime; run {wall:.6f} s (uninterrupted {plain_s:.6f} s); "
        f"final state bit-equal to the uninterrupted run: {bit_equal} "
        f"(max |diff| {max_abs:.3e}), losses of the shared steps equal: "
        f"{losses_equal}; kernel launches {launches}")
    return row


# -- the ported examples, on the card ----------------------------------------
# each examples/torch/*.py at its defaults (the card, serve_lm and train_lm
# at --preset smoke), all started together: each must exit 0 and print the
# line that closes its run (its own checks passed); their last lines are
# its key numbers
EXAMPLE_MARKS = {"quickstart": "quickstart OK",
                 "kmeans_pilot": "tier=device",
                 "multipilot_scaling":
                 "replica read after invalidation is coherent",
                 "elastic_failover": "elastic failover OK",
                 "serve_lm": "[serve]",
                 "train_lm": "[train] done"}
EXAMPLE_TIMEOUT_S = 300


def examples_phase() -> dict:
    """Run every ported example in its own process on the card (at once,
    one thread waiting on each); a failed example, or one that does not
    print its closing line, fails the phase.  Returns each one's exit
    code, seconds and last lines."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run(name):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py")],
            capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=EXAMPLE_TIMEOUT_S)
        return name, res, time.perf_counter() - t0

    with ThreadPoolExecutor(len(EXAMPLE_MARKS)) as pool:
        done = list(pool.map(run, EXAMPLE_MARKS))
    out = {}
    for name, res, secs in done:
        lines = res.stdout.strip().splitlines()
        out[name] = {"rc": res.returncode, "seconds": secs,
                     "lines": [ln[:400] for ln in lines[-4:]]}
        log(f"example {name}: exit {res.returncode} in {secs:.3f} s; "
            + " | ".join(out[name]["lines"]))
        assert res.returncode == 0, (
            f"example {name} exited {res.returncode}:\n{res.stderr[-3000:]}")
        assert any(EXAMPLE_MARKS[name] in ln for ln in lines), (
            f"example {name} did not print {EXAMPLE_MARKS[name]!r}")
    return out


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
    log(f"profiler delivers device events after "
        f"{profiler_ready(torch)} warm-up session(s)")

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

    # -- 3b. KMeans through a pilot loss, a repair and a rebalance -----------
    ekmeans = elastic_kmeans_phase(torch, core, kernel_mod)
    launches_total += ekmeans["launches"] + ekmeans["launches_undisturbed"]
    gc.collect()
    torch.cuda.empty_cache()

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
        ("long row", 1, 32768, 32, 8, 64, bf16, 0, {"fill": 1.0}),
        # head width 128: Mixtral's rolling 4096-slot window, rows past it,
        # and InternVL2's 1024 slots full
        ("mixtral decode, window", 8, 4096, 48, 8, 128, bf16, 4096,
         {"first": 4608}),
        ("internvl2 decode", 8, 1024, 16, 8, 128, bf16, 0, {"fill": 1.0}),
        # Whisper's decoder self-attention: one query head per kv head,
        # bf16, its 448-token text context full
        ("whisper decode, G=1", 8, 448, 8, 8, 64, bf16, 0, {"fill": 1.0}),
        # a rank's heads over a (1, 4) pilot mesh: Llama-3.2-1B's 8 of 32
        # q and 2 of 8 kv heads (G = 4), DeepSeek-67B's 16 of 64 and 2 of
        # 8 at its 2048-slot cache half full
        ("llama decode, (1, 4) rank", 8, 1024, 8, 2, 64, bf16, 0,
         {"fill": 1.0}),
        ("deepseek-67b decode, (1, 4) rank", 8, 2048, 16, 2, 128, bf16, 0,
         {"fill": 0.5}),
        # Mixtral-8x22B's 12 of 48 q and 2 of 8 kv heads, its rolling
        # 4096-slot window, rows past it
        ("mixtral decode, (1, 4) rank", 8, 4096, 12, 2, 128, bf16, 4096,
         {"first": 4608}),
        # Yi-9B (32 q and 4 kv heads of 128) serving 1024-2048-token
        # prompts from an 8192-slot cache at batch 8: one card's rows, and
        # a rank's over four cards, the batch split over (4, 1) (2 rows),
        # split and heads halved over (2, 2), heads quartered over (1, 4)
        ("yi-9b decode, one card", 8, 8192, 32, 4, 128, bf16, 0,
         {"fill": 0.25}),
        ("yi-9b decode, (4, 1) rank", 2, 8192, 32, 4, 128, bf16, 0,
         {"fill": 0.25}),
        ("yi-9b decode, (2, 2) rank", 4, 8192, 16, 2, 128, bf16, 0,
         {"fill": 0.25}),
        ("yi-9b decode, (1, 4) rank", 8, 8192, 8, 1, 128, bf16, 0,
         {"fill": 0.25}),
        # Llama-3.2-1B's rank over (2, 2): 16 of 32 q and 4 of 8 kv heads,
        # 8 rows, and the 16 rows of a batch of 32
        ("llama decode, (2, 2) rank", 8, 1024, 16, 4, 64, bf16, 0,
         {"fill": 0.25}),
        ("llama decode, (2, 2) rank, batch 32", 16, 1024, 16, 4, 64, bf16,
         0, {"fill": 0.25}),
        # StarCoder2-7B (36 q and 4 kv heads of 128: G = 9, two head
        # groups a (row, kv head), the second of one head) serving
        # 1024-4096-token prompts from an 8192-slot cache at batch 8; and
        # G = 9 in fp32 on the CUDA-core route, and at 9/1
        ("starcoder2 decode", 8, 8192, 36, 4, 128, bf16, 0, {"fill": 0.25}),
        ("starcoder2 G=9 fp32", 3, 1000, 36, 4, 128, f32, 0, {"fill": 0.6}),
        ("G=9 over one kv head", 2, 777, 9, 1, 128, bf16, 300,
         {"fill": 1.0})]
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
        ("ragged G=2", 3, 1000, 6, 3, 32, f32, 0),
        # head width 128: a Mixtral refill past its 4096 window, and an
        # InternVL2 wave (256 vision + 384 text tokens)
        ("mixtral refill, window", 1, 4608, 48, 8, 128, bf16, 4096),
        ("internvl2 wave", 8, 640, 16, 8, 128, bf16, 0),
        # a rank's heads over a (1, 4) pilot mesh (see the decode shapes)
        ("llama wave, (1, 4) rank", 8, 128, 8, 2, 64, bf16, 0),
        ("deepseek-67b wave, (1, 4) rank", 8, 512, 16, 2, 128, bf16, 0),
        ("deepseek-67b refill, (1, 4) rank", 1, 1024, 16, 2, 128, bf16, 0),
        ("mixtral refill, (1, 4) rank", 1, 4608, 12, 2, 128, bf16, 4096),
        # Yi-9B's refill of a 2048-token prompt, on the rank that owns the
        # row (heads whole: one card, or (4, 1))
        ("yi-9b refill", 1, 2048, 32, 4, 128, bf16, 0),
        # StarCoder2-7B (36/4, H=128): a refill of a 4096-token prompt and
        # the serving phase's wave (its first prompt, 4096 tokens, and 7
        # padding copies)
        ("starcoder2 refill", 1, 4096, 36, 4, 128, bf16, 0),
        ("starcoder2 wave", 8, 4096, 36, 4, 128, bf16, 0)]
    gc.collect()      # the StarCoder2 wave's plain version holds ~58 GB
    torch.cuda.empty_cache()
    flash_rows = [check_flash(torch, flash_attention_op, *shape)
                  for shape in flash_shapes]
    # Whisper's non-causal shapes (8/8 heads of 64, 1500 frames): the
    # encoder, and cross attention of a 64-token prompt and of one decode
    # token against the frames
    flash_rows += [check_flash(torch, flash_attention_op, name, 8, sq, 8, 8,
                               64, bf16, 0, causal=False, skv=1500)
                   for name, sq in (("whisper encoder", 1500),
                                    ("whisper cross prefill", 64),
                                    ("whisper cross decode", 1))]
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
                   ("ragged, h0", 2, 1000, 96, 4, f32, True),
                   # a rank's 800 of Hymba's 3200 channels over (1, 4)
                   ("hymba refill, (1, 4) rank", 1, 2048, 800, 16, bf16),
                   ("hymba wave, (1, 4) rank", 8, 512, 800, 16, bf16),
                   # Falcon-Mamba-7B (Di = 8192, N = 16): a 2048-token
                   # refill on the chunked route (4 chunks of 512), the
                   # serving phase's wave (8 x 2048) and a wave of 8 x 512
                   # in one pass; a (1, 4) rank's 2048 channels of the
                   # refill (16 chunks of 128) and a (4, 1) rank's 2 rows
                   # of the wave
                   ("falcon-mamba refill", 1, 2048, 8192, 16, bf16),
                   ("falcon-mamba wave", 8, 2048, 8192, 16, bf16),
                   ("falcon-mamba wave of 512", 8, 512, 8192, 16, bf16),
                   ("falcon-mamba refill, (1, 4) rank", 1, 2048, 2048, 16,
                    bf16),
                   ("falcon-mamba wave, (4, 1) rank", 2, 2048, 8192, 16,
                    bf16)]
    scan_rows = [check_scan(torch, selective_scan_op, *shape)
                 for shape in scan_shapes]

    # -- 5b. the decode step as one CUDA graph against the eager step -------
    graph_check = decode_graph_phase(torch, {
        "decode_attention": (attn_mod, "LAUNCHES"),
        "decode_attention_tc": (attn_mod, "TC_LAUNCHES"),
        "flash_attention": (flash_mod, "TC_LAUNCHES"),
        "selective_scan": (scan_mod, "LAUNCHES")})

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
    gc.collect()
    torch.cuda.empty_cache()
    # -- 6'. the same serving over a one-rank (1, 1) pilot mesh -------------
    pserve = pilot_mesh_serving_phase(torch, core, cfg, params,
                                      llama_kernels, lserve)
    gc.collect()
    torch.cuda.empty_cache()
    # -- 6a. the elastic fleet: scale-out on the queue wait, a drain -------
    eserve = elastic_serving_phase(torch, core, cfg, params, llama_kernels)
    del params
    gc.collect()             # the closed session's runtime, held in cycles
    torch.cuda.empty_cache()

    # -- 6b. training Llama-3.2-1B at its published config ------------------
    all_kernels = {"kmeans_assign": (kernel_mod, "LAUNCHES"),
                   "decode_attention": (attn_mod, "LAUNCHES"),
                   "decode_attention_tc": (attn_mod, "TC_LAUNCHES"),
                   "decode_attention_core": (attn_mod, "CORE_LAUNCHES"),
                   "flash_attention": (flash_mod, "TC_LAUNCHES"),
                   "flash_attention_fp32": (flash_mod, "LAUNCHES"),
                   "selective_scan": (scan_mod, "LAUNCHES")}
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    training = training_phase(torch, all_kernels)
    train_launches = training["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    # -- 6b'. the same training over a one-rank NCCL mesh ------------------
    training["sharded"] = sharded_training_phase(torch, all_kernels,
                                                 training["full"])
    sharded_launches = training["sharded"]["launches"]
    # -- 6b''. the same cell planned by the dry-run, against its measure ----
    training["dryrun"] = dryrun_phase(torch, card, training["sharded"],
                                      training["full"])
    # -- 6c. the train step through the resilient runner -------------------
    resilient = resilient_training_phase(torch, all_kernels)
    gc.collect()
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
    n = hcfg.num_layers
    hymba_row = ssm_model_phase(
        torch, hcfg, hparams, hymba_kernels, name="hymba-1.5b full width",
        s=HYMBA_CHECK_LEN, max_len=HYMBA_MAX_LEN,
        expect={"flash_attention": n, "flash_attention_fp32": 0,
                "selective_scan": n, "decode_attention": 8 * n,
                "decode_attention_tc": 8 * n})
    hymba_steps = hymba_trace(torch, hcfg, hparams)
    hserve = hymba_serving_phase(torch, core, hcfg, hparams, hymba_kernels)
    del hparams
    gc.collect()
    torch.cuda.empty_cache()
    gqa_kernels = {"decode_attention": (attn_mod, "LAUNCHES"),
                   "decode_attention_tc": (attn_mod, "TC_LAUNCHES"),
                   "flash_attention": (flash_mod, "TC_LAUNCHES"),
                   "flash_attention_fp32": (flash_mod, "LAUNCHES")}

    # -- 8. the serving path: InternVL2-2B at full width ---------------------
    vcfg = get_config("internvl2_2b")
    t0 = time.perf_counter()
    vparams = build_model(vcfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"params: {vcfg.name} {vcfg.num_params()} parameters drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    vision_row = model_phase(torch, vcfg, vparams, name="internvl2-2b",
                             max_len=VLM_MAX_LEN)
    vserve = family_serving_phase(torch, core, "internvl2-2b", vcfg,
                                  vparams, gqa_kernels, VLM_PROMPT_LENS,
                                  VLM_MAX_LEN, memory_gb=4)
    del vparams
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8b. a (1, 4) rank's share of MoE and MLA at published widths ------
    split = rank_split_phase(torch)

    # -- 9. the serving path: Mixtral-8x22B at published widths -------------
    full = get_config("mixtral_8x22b")
    ccfg = dataclasses.replace(full, num_layers=MIXTRAL_CHECK_LAYERS)
    t0 = time.perf_counter()
    cparams = build_model(ccfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"params: {ccfg.name} at {ccfg.num_layers} of {full.num_layers} "
        f"layers, {ccfg.num_params()} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    moe_row = model_phase(
        torch, ccfg, cparams, name=f"mixtral-8x22b ({ccfg.num_layers} of "
        f"{full.num_layers} layers)", b=2, s=MIXTRAL_CHECK_LEN,
        max_len=MIXTRAL_MAX_LEN, trace=False)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
    weight_bytes = 2 * mcfg.num_params()             # all bf16 but the router
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    log(f"serving {mcfg.name} at {mcfg.num_layers} of {full.num_layers} "
        f"layers: {mcfg.num_params()} parameters (about "
        f"{weight_bytes / 1e9:.3f} GB), drawn on the card by the engine from "
        f"its seed, one device copy")
    steps = {}

    def after(params):
        # one device copy: the runtime's params are all that is allocated
        # besides the batch's cache
        live = torch.cuda.memory_allocated()
        log(f"device memory allocated after serving {live / 1e9:.3f} GB "
            f"(weights about {weight_bytes / 1e9:.3f} GB)")
        assert live < 1.1 * weight_bytes, live
        steps["host"] = host_memory("the Mixtral shards in host memory")
        steps["step"] = mixtral_step(torch, mcfg, params)
        return steps

    mserve = family_serving_phase(
        torch, core, "mixtral-8x22b", mcfg, None, gqa_kernels,
        MIXTRAL_PROMPT_LENS, MIXTRAL_MAX_LEN, after=after,
        width=f"published widths, {mcfg.num_layers} of {full.num_layers} "
        f"layers,")
    step = steps["step"]
    per_step = mserve["wall_s"] / mserve["stats"]["decode_steps"] * 1e3
    log(f"mixtral-8x22b decode step against its weight-read floor: floor "
        f"{step['weight_floor_ms']:.4f} ms; synchronised step "
        f"{min(step['step_ms']):.4f} ms (min of {len(step['step_ms'])}); "
        f"serving {per_step:.4f} ms per step, refills included")
    gc.collect()             # the runtime's 40.9 GB, on the card and host
    torch.cuda.empty_cache()

    # -- 10. the serving path: Whisper-base at full size --------------------
    wcfg = get_config("whisper_base")
    t0 = time.perf_counter()
    wparams = fan_in_params(torch, wcfg, seed=0)
    torch.cuda.synchronize()
    log(f"params: {wcfg.name} {spec_bytes(wcfg)[0]} parameters drawn on the "
        f"card at a 1/sqrt(fan-in) scale in {time.perf_counter() - t0:.3f} s")
    whisper_row = whisper_model_phase(torch, wcfg, wparams, gqa_kernels)
    del wparams
    wserve = family_serving_phase(
        torch, core, "whisper-base", wcfg, None, gqa_kernels,
        WHISPER_PROMPT_LENS, WHISPER_MAX_LEN, memory_gb=4,
        expect=lambda st: whisper_launches(
            wcfg, st["waves"] + st["refills"], st["decode_steps"]))
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10b. the serving path: Falcon-Mamba-7B, all 64 layers -------------
    full = get_config("falcon_mamba_7b")
    ccfg = dataclasses.replace(full, num_layers=FALCON_CHECK_LAYERS)
    ssm_kernels = gqa_kernels | {"selective_scan": (scan_mod, "LAUNCHES")}
    t0 = time.perf_counter()
    cparams = build_model(ccfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"params: {ccfg.name} at {ccfg.num_layers} of {full.num_layers} "
        f"layers, {ccfg.num_params()} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    n = ccfg.num_layers
    falcon_row = ssm_model_phase(
        torch, ccfg, cparams, ssm_kernels, name=f"falcon-mamba-7b ({n} of "
        f"{full.num_layers} layers, published widths)", s=FALCON_CHECK_LEN,
        max_len=FALCON_MAX_LEN, expect={
            "selective_scan": n, "flash_attention": 0,
            "flash_attention_fp32": 0, "decode_attention": 0})
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    log(f"serving {full.name} at all {full.num_layers} layers: "
        f"{full.num_params()} parameters (about "
        f"{2 * full.num_params() / 1e9:.3f} GB of bf16), drawn on the card "
        f"by the engine from its seed")
    # no attention: the scan in every layer of each prefill, the decode
    # step's recurrence in PyTorch
    fserve = family_serving_phase(
        torch, core, "falcon-mamba-7b", full, None, ssm_kernels,
        FALCON_PROMPT_LENS, FALCON_MAX_LEN, width="published widths, all "
        f"{full.num_layers} layers,", expect=lambda st: {
            "selective_scan": full.num_layers * (st["waves"]
                                                 + st["refills"]),
            "flash_attention": 0, "decode_attention": 0})
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10c. the serving path: StarCoder2-7B, all 32 layers ---------------
    full = get_config("starcoder2_7b")
    ccfg = dataclasses.replace(full, num_layers=STARCODER_CHECK_LAYERS)
    t0 = time.perf_counter()
    cparams = build_model(ccfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"params: {ccfg.name} at {ccfg.num_layers} of {full.num_layers} "
        f"layers, {ccfg.num_params()} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    code_row = model_phase(
        torch, ccfg, cparams, name=f"starcoder2-7b ({ccfg.num_layers} of "
        f"{full.num_layers} layers, published widths)",
        s=STARCODER_CHECK_LEN, max_len=STARCODER_MAX_LEN, trace=False)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    log(f"serving {full.name} at all {full.num_layers} layers: "
        f"{full.num_params()} parameters (about "
        f"{2 * full.num_params() / 1e9:.3f} GB of bf16), drawn on the card "
        f"by the engine from its seed")
    # flash_attention (tensor cores) in every layer of each prefill,
    # decode_attention (tensor cores) in every layer of each decode step
    cserve = family_serving_phase(
        torch, core, "starcoder2-7b", full, None, gqa_kernels,
        STARCODER_PROMPT_LENS, STARCODER_MAX_LEN,
        width=f"published widths, all {full.num_layers} layers,")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. the serving path: DeepSeek-V3 at published widths, last -------
    full = get_config("deepseek_v3_671b")
    ccfg = dataclasses.replace(full, num_layers=DEEPSEEK_CHECK_LAYERS)
    assert ccfg.moe.first_k_dense == DEEPSEEK_CHECK_LAYERS   # all dense
    t0 = time.perf_counter()
    cparams = fan_in_params(torch, ccfg, seed=0)
    torch.cuda.synchronize()
    log(f"params: {ccfg.name} at {ccfg.num_layers} of {full.num_layers} "
        f"layers, {spec_bytes(ccfg)[0]} parameters drawn on the card at a "
        f"1/sqrt(fan-in) scale in {time.perf_counter() - t0:.3f} s")
    mla_row = deepseek_model_phase(torch, ccfg, cparams)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    dcfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS)
    d_params, d_bytes = spec_bytes(dcfg)
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    d_host = host_memory("before the DeepSeek-V3 draw")
    log(f"serving {dcfg.name} at {dcfg.num_layers} of {full.num_layers} "
        f"layers: {d_params} parameters ({d_bytes / 1e9:.3f} GB; "
        f"num_params() gives {dcfg.num_params()}), drawn on the card by "
        f"the engine from its seed, one device copy")
    dsteps = {"host_before": d_host}

    def dafter(params):
        live = torch.cuda.memory_allocated()
        log(f"device memory allocated after serving {live / 1e9:.3f} GB "
            f"(weights {d_bytes / 1e9:.3f} GB)")
        assert live < 1.1 * d_bytes, live
        dsteps["host"] = host_memory("the DeepSeek-V3 shards in host memory")
        dsteps["step"] = deepseek_step(torch, dcfg, params)
        return dsteps

    # MLA and the experts are PyTorch products: no kernel of the port runs
    dserve = family_serving_phase(
        torch, core, "deepseek-v3", dcfg, None, gqa_kernels,
        DEEPSEEK_PROMPT_LENS, DEEPSEEK_MAX_LEN, after=dafter,
        width=f"published widths, {dcfg.num_layers} of {full.num_layers} "
        f"layers,", expect=lambda st: {"flash_attention": 0,
                                       "decode_attention": 0})
    dstep = dsteps["step"]
    per_step = dserve["wall_s"] / dserve["stats"]["decode_steps"] * 1e3
    log(f"deepseek-v3 decode step against its weight-read floor: floor "
        f"{dstep['weight_floor_ms']:.4f} ms; synchronised step "
        f"{min(dstep['step_ms']):.4f} ms (min of {len(dstep['step_ms'])}); "
        f"serving {per_step:.4f} ms per step, refills included")

    # -- 11b. the ported examples, each in its own process ----------------
    gc.collect()
    torch.cuda.empty_cache()
    examples = examples_phase()

    # -- 12. the kernels line ----------------------------------------------
    head = rows[len(rows) - len(PAPER_SCENARIOS)]      # scenario i partition
    ahead = attn_rows[1]                                # the serving shape
    fhead, shead = flash_rows[0], scan_rows[0]          # the hymba refill
    served = lambda res: {k: res["stats"][k] for k in (
        "completed", "tokens_served", "decode_steps", "refills", "waves",
        "p50_latency_s", "p99_latency_s")} | {
        "wall_s": res["wall_s"], "setup_s": res["setup_s"]}
    by_path = lambda name: {
        path: launches.get(name, 0) for path, launches in (
            ("llama3_2_1b serving", lserve["launches"]),
            ("llama3_2_1b serving over a (1, 1) pilot mesh",
             pserve["launches"]),
            ("llama3_2_1b serving, 32 requests on 1 replica",
             eserve["undisturbed_launches"]),
            ("llama3_2_1b elastic serving", eserve["launches"]),
            ("hymba_1_5b serving", hserve["launches"]),
            ("internvl2_2b serving", vserve["launches"]),
            ("mixtral_8x22b serving", mserve["launches"]),
            ("whisper_base serving", wserve["launches"]),
            ("falcon_mamba_7b serving", fserve["launches"]),
            ("starcoder2_7b serving", cserve["launches"]),
            ("deepseek_v3_671b serving", dserve["launches"]))} | {
        "llama3_2_1b training": train_launches[name],
        "llama3_2_1b sharded training": sharded_launches[name],
        "resilient training (100m)": resilient["launches"][name]}
    for name in ("kmeans_assign", "decode_attention", "flash_attention",
                 "selective_scan"):
        assert train_launches[name] == 0, (name, train_launches)
        assert sharded_launches[name] == 0, (name, sharded_launches)
        assert resilient["launches"][name] == 0, (name, resilient)
    log(card)
    log(json.dumps({"rank_split": split}))
    log(json.dumps({"examples": examples}))
    log(json.dumps({"decode_graphs": graph_check}))
    log(json.dumps({"training": training}))
    log(json.dumps({"elastic": {"serving": eserve["row"],
                                "kmeans": ekmeans,
                                "resilient_training": resilient}}))
    log(json.dumps({"kernels": [{
        "name": "kmeans_assign", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches_total,
        "launches_by_path": {
            "kmeans main path": launches_total - ekmeans["launches"]
            - ekmeans["launches_undisturbed"],
            "kmeans elastic, undisturbed": ekmeans["launches_undisturbed"],
            "kmeans elastic, pilot lost": ekmeans["launches"],
            "llama3_2_1b training": train_launches["kmeans_assign"],
            "llama3_2_1b sharded training":
            sharded_launches["kmeans_assign"],
            "resilient training (100m)":
            resilient["launches"]["kmeans_assign"]},
        "checked": True,
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
        "model_check": model_row, "serving": served(lserve),
        "serving_pilot_mesh": served(pserve),
        "model_checks": {"internvl2_2b": vision_row,
                         "mixtral_8x22b": moe_row,
                         "whisper_base": whisper_row,
                         "starcoder2_7b": code_row,
                         # no kernel of the port on its path
                         "deepseek_v3_671b": mla_row},
        "servings": {"internvl2_2b": served(vserve),
                     "mixtral_8x22b": served(mserve)
                     | {"peak_bytes": mserve["peak_bytes"]}
                     | mserve["after"],
                     "whisper_base": served(wserve)
                     | {"peak_bytes": wserve["peak_bytes"]},
                     "starcoder2_7b": served(cserve)
                     | {"peak_bytes": cserve["peak_bytes"]},
                     "deepseek_v3_671b": served(dserve)
                     | {"peak_bytes": dserve["peak_bytes"]}
                     | dserve["after"]}}, {
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
        "serving": served(hserve),
        "model_checks": {"whisper_base": whisper_row},
        "servings": {"whisper_base": served(wserve),
                     "starcoder2_7b": served(cserve)}}, {
        "name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES,
        "launches": sum(by_path("selective_scan").values()),
        "launches_by_path": by_path("selective_scan"), "checked": True,
        "max_abs_err": max(r["max_abs_err"] for r in scan_rows),
        "ms": shead["kernel_ms"], "plain_ms": shead["plain_ms"],
        "bound_ms": shead["bound_us"] / 1e3, "bound_by": shead["bound_by"],
        "library_ms": None, "shapes": scan_rows,
        "model_checks": {"hymba_1_5b": hymba_row,
                         "falcon_mamba_7b": falcon_row},
        "servings": {"hymba_1_5b": served(hserve),
                     "falcon_mamba_7b": served(fserve)
                     | {"peak_bytes": fserve["peak_bytes"]}}}]}))
    # -- 13. the last line --------------------------------------------------
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
