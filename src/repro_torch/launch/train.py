"""End-to-end training on the Pilot stack.

    python -m repro_torch.launch.train --arch llama3_2_1b --preset 100m \\
        --steps 300 --batch 8 --seq 512

The port of ``repro/launch/train.py``.  Flow (paper Fig. 3): the corpus
lives as a file-tier DataUnit -> staged to the host tier by the pipeline
-> batches feed the train step, run as one compute unit per step on a
PilotCompute that keeps the step (``jit_cached``) across the whole run ->
checkpoints write back to the persistent tier asynchronously.
``--failure-at`` releases the pilot at that step (a simulated pilot loss),
submits a new one and restarts from the last checkpoint.  It runs on the
card unless ``--device cpu`` is given; ``main()`` returns the final loss,
``run()`` the whole record of the run.

Over a device mesh: when a process group is up, or ``torchrun``'s
environment names one (``torchrun --nproc-per-node N -m
repro_torch.launch.train ...``; NCCL on the card, each rank on its
``LOCAL_RANK`` card, gloo on the CPU), every rank forms
``make_local_mesh(N)`` of ``--model-parallel N`` (ranks / N data x N
model; N = 1 puts every rank on the data axis, and a model axis runs
the models tensor-parallel, ``models/transformer.py``), submits its own
pilot on its device, holds its shards of the state
(``steps.shard_train_state``), steps through
``steps.make_sharded_train_step`` on its slice of the pipeline's global
batch (every rank reads the same batches), saves through the gathering
checkpoint and restores through ``restore(shardings=)`` the step rank 0
last wrote whole (``agreed_latest_step``).  Rank 0 prints; every rank
returns the run.  ``--trace-step K`` runs the K-th step on the card under
``torch.profiler`` on rank 0 and splits its device time among compute
(every kernel and copy but NCCL's) and each collective (`trace_split`).

Presets scale the *width/depth* of the chosen architecture family while
keeping its structure (GQA ratios, MoE top-k, SSM dims), so every assigned
arch has a runnable small variant: smoke (~1M), 20m, 100m, or the published
config (full).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, ParallelConfig,
                                      TrainConfig, reduced)
from repro_torch.core import (ComputeDataManager, PilotComputeDescription,
                              PilotComputeService, make_backend,
                              resolve_device, to_device)
from repro_torch.data.pipeline import BatchPipeline, corpus_data_unit
from repro_torch.launch.mesh import (host_device_grid, init_distributed,
                                     make_local_mesh)
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import Model, build_model
from repro_torch.train import steps as steps_mod

PRESETS = {
    "smoke": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  d_ff=128, vocab_size=512, head_dim=16),
    "20m": dict(num_layers=4, d_model=384, num_heads=6, num_kv_heads=2,
                d_ff=1024, vocab_size=8192, head_dim=64),
    "100m": dict(num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=2048, vocab_size=16384, head_dim=64),
    "full": {},
}


def scaled_config(arch: str, preset: str) -> ModelConfig:
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "smoke":
        return reduced(cfg)
    over = dict(PRESETS[preset])
    if cfg.is_moe:
        over["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            expert_d_ff=over["d_ff"],
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            first_dense_d_ff=over["d_ff"])
        over["d_ff"] = cfg.d_ff and over["d_ff"]
    if cfg.ssm is not None:
        over["ssm"] = cfg.ssm
        if cfg.d_ff == 0:
            over["d_ff"] = 0
    if cfg.vision_tokens:
        over["vision_tokens"] = min(cfg.vision_tokens, 16)
        over["vision_embed_dim"] = 128
    if cfg.encoder_layers:
        over["encoder_layers"] = min(cfg.encoder_layers, 4)
        over["encoder_seq_len"] = min(cfg.encoder_seq_len, 64)
    over["global_attn_layers"] = tuple(
        i for i in cfg.global_attn_layers if i < over["num_layers"])
    if cfg.sliding_window:
        over["sliding_window"] = min(cfg.sliding_window, 256)
    over["name"] = f"{cfg.name}-{preset}"
    return dataclasses.replace(cfg, **over)


@dataclasses.dataclass
class TrainRun:
    """What one `run` did: the final state and the record of each step."""
    cfg: ModelConfig
    model: Model
    pcfg: ParallelConfig
    tcfg: TrainConfig
    device: torch.device
    state: Any                      # the final TrainState
    ckpt: CheckpointManager         # its write_log holds each save
    losses: List[float]             # per step run (a restart repeats some;
    #                                 nan alone where no step ran)
    grad_norms: List[float]         # per step run, beside `losses`
    step_s: List[float]             # host seconds per step, synchronised
    peak_bytes: Optional[int]       # max_memory_allocated (the card only)
    tokens_per_step: int
    mesh: Any = None                # the DeviceMesh of a sharded run
    trace: Optional[dict] = None    # rank 0's `trace_split` of one step

    @property
    def loss(self) -> float:
        return self.losses[-1]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--preset", default="100m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--failure-at", type=int, default=0,
                    help="inject a pilot failure at this step (demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace-step", type=int, default=0,
                    help="profile this step on the card (rank 0) and "
                         "print its device time by part")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the model axis of the mesh (under "
                         "torchrun; it must divide the ranks)")
    return ap.parse_args(argv)


# NCCL kernel name fragments -> the collective a traced step ran (NCCL
# runs an all-to-all as grouped sends and receives)
TRACE_PARTS = (("AllGather", "all-gather"),
               ("ReduceScatter", "reduce-scatter"),
               ("AllReduce", "all-reduce"), ("SendRecv", "all-to-all"),
               ("nccl", "other collective"))


def trace_split(prof) -> dict:
    """Device milliseconds of a profiled run by part: each NCCL kernel
    under its collective, every other kernel and copy under "compute"."""
    from torch.autograd import DeviceType
    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        part = next((p for frag, p in TRACE_PARTS
                     if frag.lower() in e.name.lower()), "compute")
        out[part] = out.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def _profiled(fn, dev: torch.device, tries: int = 5):
    """(fn(), its `trace_split`): fn under ``torch.profiler`` (CUDA
    activity), after small sessions until the profiler delivers device
    events (a process's first session may hold none)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device=dev)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as warm:
            x.mul_(1.0)
            torch.cuda.synchronize(dev)
        if trace_split(warm):
            break
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize(dev)
    return out, trace_split(prof)


def agreed_latest_step(ckpt: CheckpointManager, mesh) -> Optional[int]:
    """The newest step on disk, the same on every rank of a sharded run:
    rank 0 (the writer) first finishes its background save, then tells
    the others which step it sees, so no rank reads an older step while
    rank 0's newest is still a ``.tmp`` directory.  A collective."""
    if mesh is None:
        return ckpt.latest_step()
    if dist.get_rank() == 0:
        ckpt.wait()
    latest = [ckpt.latest_step()]
    dist.broadcast_object_list(latest, src=0)
    return latest[0]


def run(argv=None) -> TrainRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    owned = init_distributed(dev)
    if args.model_parallel > 1 and (
            not dist.is_initialized()
            or dist.get_world_size() % args.model_parallel):
        raise ValueError(f"--model-parallel {args.model_parallel} needs a "
                         f"process group (torchrun) whose ranks it divides")
    mesh = (make_local_mesh(args.model_parallel) if dist.is_initialized()
            else None)
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = scaled_config(args.arch, args.preset)
    model = build_model(cfg)
    n_params = sum(int(np.prod(s.shape)) for s in tree_leaves(model.specs))
    say(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, device={dev}"
        + ("" if mesh is None else f", mesh {host_device_grid(mesh)}"))

    # --- pilot: retained resources for the whole run ---
    svc = PilotComputeService()
    desc = PilotComputeDescription(backend="inprocess", num_devices=1,
                                   affinity="trainer", device=dev)
    pilot = svc.submit_pilot(desc)
    manager = ComputeDataManager(svc)

    # --- data: file tier -> host tier -> batches (each rank its own) ---
    corpus_dir = Path(args.ckpt_dir) / ("corpus" if mesh is None
                                        else f"corpus_rank{rank}")
    backends = {"file": make_backend("file", root=str(corpus_dir)),
                "host": make_backend("host")}
    du = corpus_data_unit("corpus", cfg,
                          num_tokens=max(2_000_000, 4 * args.batch
                                         * (args.seq + 1) * 16),
                          backends=backends, tier="file")
    du.to_tier("host", delete_source=False)
    pipe = BatchPipeline(du, cfg, args.batch, args.seq)

    pcfg = ParallelConfig(microbatches=args.microbatches,
                          opt_state_dtype=args.opt_dtype)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20))
    state = steps_mod.init_train_state(
        model, torch.Generator(device=dev).manual_seed(tcfg.seed), pcfg,
        device=dev)
    if mesh is None:
        shardings = None
        build_step = lambda: steps_mod.make_train_step(model, pcfg, tcfg)
    else:
        shardings = steps_mod.train_state_shardings(
            model, mesh, opt_state_dtype=args.opt_dtype)
        state = steps_mod.shard_train_state(state, shardings)
        build_step = lambda: steps_mod.make_sharded_train_step(
            model, pcfg, tcfg, mesh)
    step_fn = pilot.jit_cached(("train_step", cfg.name), build_step)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name)

    start = 0
    latest = agreed_latest_step(ckpt, mesh)
    if latest is not None:
        state, start = ckpt.restore(state, latest, shardings=shardings)
        say(f"[train] restored step {start}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses: List[float] = []
    gnorms: List[float] = []
    t_hist: List[float] = []
    failed_once = False
    trace = None
    step = start
    try:
        while step < args.steps:
            batch = {k: to_device(v, dev) for k, v in next(pipe).items()}
            if args.failure_at and step == args.failure_at and not failed_once:
                failed_once = True
                say(f"[train] !!! injecting pilot failure at step {step}")
                svc.release(pilot)
                pilot = svc.submit_pilot(desc)
                step_fn = pilot.jit_cached(("train_step", cfg.name),
                                           build_step)
                state, step = ckpt.restore(
                    state, agreed_latest_step(ckpt, mesh), shardings=shardings)
                say(f"[train] recovered at step {step}")
                continue
            t0 = time.perf_counter()
            run_step = lambda s=state, b=batch: manager.run(
                lambda: step_fn(s, b), affinity="trainer").result()
            if (step - start + 1 == args.trace_step and rank == 0
                    and dev.type == "cuda"):
                (state, metrics), trace = _profiled(run_step, dev)
            else:
                state, metrics = run_step()
            losses.append(float(metrics["loss"]))       # waits for the step
            dt = time.perf_counter() - t0
            if trace is not None and step - start + 1 == args.trace_step:
                say(f"[train] trace of step {step + 1}: wall "
                    f"{dt * 1e3:.3f} ms; device ms "
                    + ", ".join(f"{k} {v:.3f}"
                                for k, v in sorted(trace.items())))
            t_hist.append(dt)
            gnorms.append(float(metrics["grad_norm"]))
            step += 1
            if step % args.log_every == 0 or step == 1:
                mem = (f" peak={torch.cuda.max_memory_allocated(dev)/1e9:.2f}GB"
                       if dev.type == "cuda" else "")
                say(f"[train] step {step:5d} loss={losses[-1]:.4f} "
                    f"gnorm={gnorms[-1]:.3f} "
                    f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms{mem}")
            if step % args.ckpt_every == 0:
                ckpt.save(step, state, blocking=False)
        ckpt.save(args.steps, state, blocking=True)
        if mesh is not None:
            # every rank returns once rank 0's checkpoint is on disk (and
            # none leaves while a peer still sends)
            dist.barrier()
    finally:
        pipe.close()
        svc.cancel_all()
        if owned:
            dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    med = float(np.median(t_hist)) if t_hist else 0.0
    tokens_s = args.batch * args.seq / med if med else 0.0
    if not losses:          # restored at the last step: nothing to run
        losses.append(float("nan"))
    say(f"[train] done: median step {med*1e3:.0f}ms, {tokens_s:.0f} tok/s, "
        f"final loss {losses[-1]:.4f}"
        + (f", peak device memory {peak/1e9:.2f}GB" if peak else ""))
    return TrainRun(cfg=cfg, model=model, pcfg=pcfg, tcfg=tcfg, device=dev,
                    state=state, ckpt=ckpt, losses=losses, grad_norms=gnorms,
                    step_s=t_hist, peak_bytes=peak,
                    tokens_per_step=args.batch * args.seq,
                    mesh=None if owned else mesh, trace=trace)


def main(argv=None) -> float:
    """Train as the flags say; returns the final loss."""
    return run(argv).loss


if __name__ == "__main__":
    main()
