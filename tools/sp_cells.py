"""Sequence parallelism and int8 AdamW state over a mesh of torchrun's
ranks: the cells ``tools/sp_four_cards.sh`` measures on four cards.

    torchrun --nproc-per-node 4 tools/sp_cells.py --cell train \\
        --out chiprun_out/sp4/cells.jsonl
    torchrun --nproc-per-node 4 tools/sp_cells.py --cell prefill --preset smoke \\
        --seq 64 --device cpu                 # a rehearsal on gloo

Every rank takes the same global inputs (random tokens from a seed) and
the same seeded state, drawn shard by shard
(``steps.init_sharded_train_state``, ``transformer.local_draw``); rank 0
prints one JSON line a run and, with ``--out``, appends it there.

``train``: Llama-3.2-1B (``--preset full``: its published config) at
batch 8 x ``--seq``, over (1, 4) and (2, 2), under the default rules and
under sequence parallelism (``launch.autotune.SP``): the losses, the
median step (host clock, synchronised, steps 2 on but the profiled
one), the peak device memory a rank and the ``--trace-step``-th step's
device ms by part (``launch.train.trace_split``).  Then 3 steps of each
in fp32 (activations and params), where SP's losses are held to the
default rules' of the same mesh at ``LOSS_RTOL``, the sharded tests'
tolerance (in bf16 the two orders of sums part by a bf16 rounding, and
the bf16 runs' difference is reported, not held).

``int8``: the same cell over (4, 1) and (2, 2) under the default rules
with float32 and with int8 AdamW state: the median step, the peak a rank
and the bytes of a rank's moments.

``prefill``: Yi-9B (its published config, 48 layers) prefilling 1 x
``--seq`` tokens over (1, 4) under both rule sets: the median of 3
prefills after one, the peak a rank, the flash kernel's launches, and the
largest difference of SP's last-token logits from the default rules',
in bf16 and, from one more prefill of each with params and activations
in fp32, in fp32.
Then, on rank 0's card, the flash kernel at a rank's shape (B=1, S=seq,
8 q heads, 1 kv head, H=128, causal, bf16) against its plain version
(one q head at a time: all eight's fp32 scores do not fit a card) and
SDPA, with its bound (``roofline.analysis.flash_bound``); and the
dry-run's plan of the cell (``launch.dryrun``, a subprocess that sees no
card) under each rule set, held to the measurement: the roofline time at
most the measured prefill, the planned peak within ``PLAN_PEAK_RTOL`` of
the measured peak.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.launch.autotune import SP  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402
from repro_torch.launch.train import _profiled, scaled_config  # noqa: E402
from repro_torch.models.common import (leaf_seed, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.parallel.sharding import AxisRules  # noqa: E402
from repro_torch.train import steps as steps_mod  # noqa: E402

LOSS_RTOL = 1e-5                # the sharded steps' tests' metric tolerance
PLAN_PEAK_RTOL = 0.25           # chip_smoke.py's dry-run phase's
TRAIN_ARCH, PREFILL_ARCH = "llama3_2_1b", "yi_9b"
BATCH = 8


def rules_named(name: str) -> AxisRules:
    rules = AxisRules()
    for logical, axes in {"default": (), "seq_parallel": SP}[name]:
        rules = rules.replacing(logical, axes)
    return rules


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(tree))


def train(args, mesh_shape, rules_name: str, opt_dtype: str, dev,
          fp32: bool = False) -> dict:
    """`args.steps` steps (3 with `fp32`) of the sharded step on one mesh,
    rule set and state dtype."""
    cfg = scaled_config(TRAIN_ARCH, args.preset)
    if fp32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    n_steps = 3 if fp32 else args.steps
    mesh = make_mesh(mesh_shape, ("data", "model"))
    rules = rules_named(rules_name)
    pcfg = ParallelConfig(opt_state_dtype=opt_dtype)
    tcfg = TrainConfig(learning_rate=1e-4, total_steps=args.steps,
                       warmup_steps=1)
    reset_peak(dev)
    state = steps_mod.init_sharded_train_state(
        model, torch.Generator(device=dev).manual_seed(0), pcfg, mesh, rules)
    if fp32:
        state = steps_mod.TrainState(tree_map(lambda p: p.float(),
                                              state.params), state.opt_state)
    step = steps_mod.make_sharded_train_step(model, pcfg, tcfg, mesh, rules)
    rng = np.random.default_rng(1)
    losses, times, trace = [], [], None
    for i in range(n_steps):
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (BATCH, args.seq))).to(dev)
            for k in ("tokens", "labels")}
        dist.barrier()
        t0 = time.perf_counter()
        if (i + 1 == args.trace_step and dist.get_rank() == 0
                and dev.type == "cuda" and not fp32):
            (state, metrics), trace = _profiled(lambda: step(state, batch),
                                                dev)
        else:
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))       # waits for the step
        sync(dev)
        times.append(time.perf_counter() - t0)
    untraced = [t for i, t in enumerate(times)
                if i > 0 and i + 1 != args.trace_step]
    rec = {"cell": args.cell, "arch": cfg.name, "batch": BATCH,
           "seq": args.seq, "mesh": dict(zip(mesh.mesh_dim_names,
                                             mesh.shape)),
           "rules": rules_name, "opt_state_dtype": opt_dtype,
           "compute": "float32" if fp32 else cfg.dtype,
           "losses": losses,
           "median_step_ms": float(np.median(untraced or times)) * 1e3,
           "step_ms": [t * 1e3 for t in times], "peak_bytes": peak(dev),
           "param_bytes_held": local_bytes(state.params),
           "opt_state_bytes_held": local_bytes(
               (state.opt_state.m, state.opt_state.v)),
           "trace_step": args.trace_step, "trace_ms": trace}
    del state, step
    assert all(math.isfinite(v) for v in losses), losses
    return rec


def loss_match(a: dict, b: dict) -> dict:
    """The largest relative difference of `a`'s losses from `b`'s."""
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    return {"max_rel_diff": rel, "rtol": LOSS_RTOL, "within": rel <= LOSS_RTOL}


def local_params(model, mesh, rules, dev):
    """The rank's serving leaves (``transformer.local_draw``), drawn from
    the seeds ``init_params`` draws."""
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_unflatten
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = tree_leaves(model.specs)
    lays = tree_leaves(transformer.tp_layouts(model.specs, model.cfg))
    return tree_unflatten(model.specs, [
        transformer.local_draw(spec, leaf_seed(gen), lay, mesh, rules, dev)
        for spec, lay in zip(specs, lays)])


def prefill(args, rules_name: str, dev, fp32: bool = False) -> dict:
    """3 prefills after one (1 with `fp32`: params and activations in
    fp32) over (1, 4) under one rule set -> the record and the last-token
    logits (whole vocabulary)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.common import gather_vocab
    from repro_torch.parallel.sharding import sharding_context
    cfg = scaled_config(PREFILL_ARCH, args.preset)
    if fp32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    mesh = make_mesh((1, 4), ("data", "model"))
    rules = rules_named(rules_name)
    params = local_params(model, mesh, rules, dev)
    if fp32:
        params = tree_map(lambda t: t.float(), params)
    reset_peak(dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, args.seq)).astype(np.int32)).to(dev)
    step = steps_mod.make_prefill_step(model, max_len=args.seq)
    times, launches = [], []
    for i in range(2 if fp32 else 4):
        dist.barrier()
        before = fa.TC_LAUNCHES + fa.LAUNCHES
        t0 = time.perf_counter()
        with sharding_context(mesh, rules):
            logits, cache = step(params, {"tokens": tokens})
            logits = gather_vocab(logits, cfg.vocab_size)
        sync(dev)
        times.append(time.perf_counter() - t0)
        launches.append(fa.TC_LAUNCHES + fa.LAUNCHES - before)
        del cache
    rec = {"cell": "prefill", "arch": cfg.name, "layers": cfg.num_layers,
           "batch": 1, "seq": args.seq, "mesh": {"data": 1, "model": 4},
           "rules": rules_name, "compute": cfg.dtype,
           "prefill_ms": float(np.median(times[1:]))
           * 1e3, "prefills_ms": [t * 1e3 for t in times],
           "peak_bytes": peak(dev), "flash_launches_per_prefill": launches,
           "param_bytes_held": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(params))}
    del params
    return rec, logits.float().cpu()


def flash_row(args, dev) -> dict:
    """The flash kernel at a (1, 4) rank's Yi-9B prefill shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.roofline.analysis import flash_bound
    cfg = scaled_config(PREFILL_ARCH, args.preset)
    b, s, nq, nkv, h = (1, args.seq, cfg.num_heads // 4,
                        max(1, cfg.num_kv_heads // 4), cfg.resolved_head_dim)
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, s, nq, h), (b, s, nkv, h), (b, s, nkv, h)))
    impl = "cuda" if dev.type == "cuda" else "ref"

    def timed(fn, reps=5):
        fn()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    got = flash_attention_op(q, k, v, causal=True, impl=impl)
    # the plain version one q head at a time (its kv head is shared)
    err, plain_ms = 0.0, 0.0
    for j in range(nq):
        qj = q[:, :, j:j + 1].float()
        sync(dev)
        t0 = time.perf_counter()
        want = flash_attention_op(qj, k.float(), v.float(), causal=True,
                                  impl="ref")
        sync(dev)
        plain_ms += (time.perf_counter() - t0) * 1e3
        want = want.to(torch.bfloat16).float()
        err = max(err, float((got[:, :, j:j + 1].float() - want).abs()
                             .max()))
        assert bool(((got[:, :, j:j + 1].float() - want).abs()
                     <= 2e-2 + 2e-2 * want.abs()).all()), err
        del want
    kernel_ms = timed(lambda: flash_attention_op(q, k, v, causal=True,
                                                 impl=impl))
    library_ms = timed(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True))
    bound_s, bound_by, pairs = flash_bound(b, s, s, nq, nkv, h, 2, True, 0)
    return {"cell": "flash_rank_shape", "b": b, "s": s, "nq": nq,
            "nkv": nkv, "h": h, "causal": True, "dtype": "bfloat16",
            "route": impl, "kernel_ms": kernel_ms,
            "plain_ms_one_head_at_a_time": plain_ms,
            "library_ms_sdpa_is_causal": library_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "pairs": pairs,
            "max_abs_err": err}


def plan(args, rules_name: str, measured: dict) -> dict:
    """The dry-run's plan of the prefill cell, in a subprocess that sees
    no card, held to `measured`."""
    out = ROOT / "build" / "sp4_plan"
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            PREFILL_ARCH, "--shape", "prefill_32k", "--batch", "1",
            "--seq", str(args.seq), "--mesh", "1x4", "--rules", rules_name,
            "--force", "--out", str(out)]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(ROOT / "src")}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    t0 = time.perf_counter()
    res = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=1200)
    if res.returncode:
        raise RuntimeError(res.stdout[-2000:] + res.stderr[-3000:])
    tag = "" if rules_name == "default" else f"_{rules_name}"
    rec = json.loads((out / f"{PREFILL_ARCH}__prefill_32k_b1_s{args.seq}"
                      f"__1x4{tag}.json").read_text())
    r = rec["roofline"]
    roof_s = max(r["t_compute"], r["t_memory"], r["t_collective"])
    planned = r["peak_mem_bytes"]
    return {"cell": "prefill_plan", "rules": rules_name,
            "plan_s": time.perf_counter() - t0,
            "roofline_s": roof_s, "t_compute": r["t_compute"],
            "t_memory": r["t_memory"], "t_collective": r["t_collective"],
            "coll_by_kind": r["coll_by_kind"], "planned_peak_bytes": planned,
            "measured_prefill_s": measured["prefill_ms"] / 1e3,
            "measured_peak_bytes": measured["peak_bytes"],
            "roofline_at_most_measured": roof_s <= measured["prefill_ms"]
            / 1e3,
            "peak_rel_diff": abs(planned - measured["peak_bytes"])
            / measured["peak_bytes"],
            "peak_within": abs(planned - measured["peak_bytes"])
            <= PLAN_PEAK_RTOL * measured["peak_bytes"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    choices=("train", "int8", "prefill"))
    ap.add_argument("--preset", default="full")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=None,
                    help="1024 for training, 32768 for the prefill")
    ap.add_argument("--trace-step", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="rank 0 appends its JSON lines here too")
    args = ap.parse_args(argv)
    args.seq = args.seq or (32768 if args.cell == "prefill" else 1024)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    owned = init_distributed(dev)
    if not dist.is_initialized() or dist.get_world_size() != 4:
        raise ValueError("tools/sp_cells.py runs under torchrun, 4 ranks")
    rank = dist.get_rank()
    records, ok = [], True

    def emit(rec):
        records.append(rec)
        if rank == 0:
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")

    try:
        if args.cell == "train":
            for shape in ((1, 4), (2, 2)):
                for fp32 in (False, True):
                    runs = {name: train(args, shape, name, "float32", dev,
                                        fp32)
                            for name in ("default", "seq_parallel")}
                    match = loss_match(runs["seq_parallel"], runs["default"])
                    runs["seq_parallel"]["losses_vs_default"] = match
                    if fp32:
                        ok &= match["within"]
                    for rec in runs.values():
                        emit(rec)
        elif args.cell == "int8":
            for shape in ((4, 1), (2, 2)):
                for dtype in ("float32", "int8"):
                    emit(train(args, shape, "default", dtype, dev))
        else:
            for fp32 in (False, True):
                logits = {}
                for name in ("default", "seq_parallel"):
                    rec, logits[name] = prefill(args, name, dev, fp32)
                    if not fp32:
                        emit(rec)
                diff = float((logits["seq_parallel"] - logits["default"])
                             .abs().max())
                emit({"cell": "prefill_logits",
                      "compute": "float32" if fp32 else "bfloat16",
                      "max_abs_diff_sp_vs_default": diff,
                      "max_abs_logit": float(logits["default"].abs()
                                             .max())})
            reset_peak(dev)
            dist.barrier()
            if rank == 0:
                emit(flash_row(args, dev))
                # the dry-run plans the published config only
                for rec in [r for r in records if r["cell"] == "prefill"
                            and args.preset == "full"]:
                    got = plan(args, rec["rules"], rec)
                    emit(got)
                    ok &= got["roofline_at_most_measured"] and got[
                        "peak_within"]
            dist.barrier()
    finally:
        if owned:
            dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
