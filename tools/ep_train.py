"""Expert-parallel training over a mesh of torchrun's ranks, under the
default rules and under EP-2D, and the EF-int8 pod mean over a pod axis.

    torchrun --nproc-per-node 4 tools/ep_train.py --layers 4 --steps 10 \\
        --seq 1024 --trace-step 6

It drives ``train.steps.make_sharded_train_step`` directly on Mixtral-8x22B
at its published widths cut to ``--layers`` decoder layers (``--preset
smoke`` for the small config), from a state drawn shard by shard
(``steps.init_sharded_train_state``: no rank holds the whole state), over
a (2, 2) data x model mesh of 4 ranks at batch 8, under each rule set in
turn: "default" puts the experts on the model axis and gathers a rank's
experts over the data axis for the step; "ep2d"
(``launch.autotune.EP2D``) holds them over ``("model", "data")`` and
sends the dispatch buffer to them by an all-to-all over the data axis.
Every rank takes the same global batches (random tokens from a seed) and
keeps its slice.  Rank 0 prints, per rule set, one JSON line: the
losses, the median step (host clock, synchronised, steps 2 on but the
profiled one), the peak device memory, and the ``--trace-step``-th step's
device ms by part (``launch.train.trace_split``: compute, all-gather,
reduce-scatter, all-reduce, all-to-all).

Then it runs ``optim.compression.compressed_pod_mean`` over a
(2, 1, 2) pod x data x model mesh of 4 ranks on a Llama-3.2-1B training
step's gradients (each pod its own batch): its ms (median of 5 calls
after one), the int8 payload and scales each rank sends against an fp32
ring all-reduce's bytes, and its largest error against the exact mean of
the two pods' gradients relative to that mean's largest magnitude.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.launch.autotune import EP2D  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402
from repro_torch.launch.train import _profiled, scaled_config  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.parallel.sharding import AxisRules  # noqa: E402
from repro_torch.train import steps as steps_mod  # noqa: E402

COMPRESSION_REL_BOUND = 0.02
ARCH = "mixtral_8x22b"           # the expert-parallel training
POD_ARCH = "llama3_2_1b"         # the pod mean's gradients
MESH, BATCH = (2, 2), 8


def rules_named(name: str) -> AxisRules:
    rules = AxisRules()
    for logical, axes in {"default": (), "ep2d": EP2D}[name]:
        rules = rules.replacing(logical, axes)
    return rules


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args, cfg, mesh, rules_name: str, dev) -> dict:
    """`args.steps` steps of the sharded step under one rule set."""
    model = build_model(cfg)
    rules = rules_named(rules_name)
    pcfg = ParallelConfig()
    tcfg = TrainConfig(learning_rate=1e-4, total_steps=args.steps,
                       warmup_steps=1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = steps_mod.init_sharded_train_state(
        model, torch.Generator(device=dev).manual_seed(0), pcfg, mesh, rules)
    sync(dev)
    init_s = time.perf_counter() - t0
    step = steps_mod.make_sharded_train_step(model, pcfg, tcfg, mesh, rules)
    rng = np.random.default_rng(1)
    losses, times, trace = [], [], None
    for i in range(args.steps):
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (BATCH, args.seq))).to(dev)
            for k in ("tokens", "labels")}
        dist.barrier()
        t0 = time.perf_counter()
        if (i + 1 == args.trace_step and dist.get_rank() == 0
                and dev.type == "cuda"):
            (state, metrics), trace = _profiled(lambda: step(state, batch),
                                                dev)
        else:
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))       # waits for the step
        sync(dev)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # steps 2 on, but the profiled one: it runs slower than the rest
    untraced = [t for i, t in enumerate(times)
                if i > 0 and i + 1 != args.trace_step]
    held = sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(state.params))
    del state, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    assert all(math.isfinite(v) for v in losses), losses
    return {"rules": rules_name, "mesh": dict(zip(mesh.mesh_dim_names,
                                                  mesh.shape)),
            "arch": cfg.name, "layers": cfg.num_layers,
            "params": cfg.num_params(), "batch": BATCH,
            "seq": args.seq, "losses": losses,
            "median_step_ms": float(np.median(untraced or times)) * 1e3,
            "step_ms": [t * 1e3 for t in times], "peak_bytes": peak,
            "param_bytes_held": held, "init_s": init_s,
            "trace_step": args.trace_step, "trace_ms": trace}


def pod_mean(args, dev) -> dict:
    """The EF-int8 pod mean over a (2, 1, 2) mesh of 4 ranks."""
    from repro_torch.optim.compression import (compressed_pod_mean,
                                               init_residuals)
    from repro_torch.optim.quant import quantize
    if dist.get_world_size() != 4:
        raise ValueError("the pod mean runs on 4 ranks: a (2, 1, 2) mesh")
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    cfg = scaled_config(POD_ARCH, args.preset)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    pod = mesh.get_local_rank("pod")
    rng = np.random.default_rng(100 + pod)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, args.seq))).to(dev)
        for k in ("tokens", "labels")}
    _, grads = steps_mod.loss_and_grads(model, params, batch, TrainConfig())
    del params, batch
    gc.collect()
    times = []
    for _ in range(6):                 # the first also sets up the group
        residuals = init_residuals(grads)
        sync(dev)
        t0 = time.perf_counter()
        means, residuals = compressed_pod_mean(grads, residuals, mesh)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    group = mesh.get_group("pod")
    err = scale = 0.0
    for m, g in zip(tree_leaves(means), tree_leaves(grads)):
        exact = g.float().clone()
        dist.all_reduce(exact, group=group)
        exact /= 2
        err = max(err, float((m.float() - exact).abs().max()))
        scale = max(scale, float(exact.abs().max()))
    sent = 0
    for g in tree_leaves(grads):
        q = quantize(g.float())
        sent += q.data.numel() * q.data.element_size() + (
            q.scale.numel() * q.scale.element_size())
    n = sum(g.numel() for g in tree_leaves(grads))
    rel = err / max(scale, 1e-30)
    assert rel < COMPRESSION_REL_BOUND, rel
    return {"mesh": {"pod": 2, "data": 1, "model": 2}, "arch": cfg.name,
            "grad_elements": n,
            "grad_bytes": sum(g.numel() * g.element_size()
                              for g in tree_leaves(grads)),
            "ms": float(np.median(times[1:])), "first_call_ms": times[0],
            "calls_ms": times, "wire_bytes_sent_per_rank": sent,
            "fp32_ring_allreduce_bytes_per_rank": 2 * (2 - 1) / 2 * 4 * n,
            "max_rel_err_vs_exact_mean": rel,
            "bound": COMPRESSION_REL_BOUND}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="full")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--trace-step", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="rank 0 writes its JSON lines here too")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    owned = init_distributed(dev)
    if not dist.is_initialized():
        raise ValueError("tools/ep_train.py runs under torchrun")
    cfg = dataclasses.replace(scaled_config(ARCH, args.preset),
                              num_layers=args.layers)
    records = []
    try:
        mesh = make_mesh(MESH, ("data", "model"))
        for name in ("default", "ep2d"):
            records.append(train(args, cfg, mesh, name, dev))
        records.append({"pod_mean": pod_mean(args, dev)})
        dist.barrier()
    finally:
        if owned:
            dist.destroy_process_group()
    if int(os.environ.get("RANK", "0")) == 0:
        for rec in records:
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return records


if __name__ == "__main__":
    main()
