"""Multi-host launch entry for a GPU cluster under SLURM (the production
counterpart of the dry-run's fake process group).

    srun --ntasks-per-node 8 --gpus-per-task 1 \\
        python -m repro_torch.launch.multihost --arch yi_9b --shape train_4k

The port of ``repro/launch/multihost.py``.  ``detect_env`` reads SLURM's
task layout; ``main`` sets from it the variables of ``torchrun``'s
environment that ``launch.mesh.init_distributed`` reads (where torchrun
set them, its own win), joins the default group (NCCL, each rank on
``cuda:<SLURM_LOCALID>``), forms the production mesh over it, builds the
same sharded train step as the dry-run plans (``launch.dryrun``) and runs
it, printing each rank's peak device memory where the reference prints
the compiled peak: the dry-run's ``peak_mem_bytes`` predicts it, since
the mesh, the rules and the step are the same and only the process
group's backend differs.

A group of another size than the production mesh's (256 ranks, or 512
with ``--multi-pod``) runs over ``make_local_mesh()``, every rank on the
data axis.  The state is drawn whole on every rank and then sharded (a
model larger than one card needs a sharded draw, which is not ported).

The reference's TPU-pod branch (``TPU_WORKER_HOSTNAMES``) has no GPU
counterpart.  Its node-list parse cuts a host name at its first "-";
``first_host`` reads SLURM's host-list syntax instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import re

import torch
import torch.distributed as dist

MASTER_PORT = 8476


def first_host(nodelist: str) -> str:
    """The first host of a SLURM host list ("gpu-a[003-004,009],gpu-b"
    -> "gpu-a003")."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if m is None:
        raise ValueError(f"first_host: no host in {nodelist!r}")
    prefix, ranges = m.group(1), m.group(2)
    if ranges is None:
        return prefix
    return prefix + ranges.split(",")[0].split("-")[0]


def detect_env() -> dict:
    """Rank, world size, local rank and master address from SLURM's
    environment (an srun task); {} outside SLURM."""
    if "SLURM_JOB_ID" not in os.environ:
        return {}
    nodes = os.environ.get("SLURM_STEP_NODELIST",
                           os.environ.get("SLURM_NODELIST", "localhost"))
    return {"rank": int(os.environ.get("SLURM_PROCID", "0")),
            "world_size": int(os.environ.get("SLURM_NTASKS", "1")),
            "local_rank": int(os.environ.get("SLURM_LOCALID", "0")),
            "master_addr": first_host(nodes),
            "master_port": MASTER_PORT}


def apply_env(env: dict) -> None:
    """Set torchrun's variables from `env` (``detect_env``), each only
    where it is not set already."""
    names = {"RANK": "rank", "WORLD_SIZE": "world_size",
             "LOCAL_RANK": "local_rank", "MASTER_ADDR": "master_addr",
             "MASTER_PORT": "master_port"}
    for var, key in names.items():
        if key in env:
            os.environ.setdefault(var, str(env[key]))


def main(argv=None) -> dict:
    from repro_torch.configs.base import ParallelConfig, SHAPES, TrainConfig
    from repro_torch.core.device import resolve_device
    from repro_torch.launch.mesh import (PRODUCTION_MESH, host_device_grid,
                                         init_distributed, make_local_mesh,
                                         make_production_mesh)
    from repro_torch.launch.train import PRESETS, scaled_config
    from repro_torch.models.model import build_model
    from repro_torch.train import steps as steps_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--shape", default="train_4k",
                    choices=[n for n, s in SHAPES.items()
                             if s.kind == "train"])
    ap.add_argument("--preset", default="full", choices=list(PRESETS))
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    apply_env(detect_env())
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    owned = init_distributed(device)
    if not dist.is_initialized():
        raise RuntimeError("multihost: no process group: run it under srun "
                           "or torchrun")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        production = math.prod(PRODUCTION_MESH[args.multi_pod][0])
        mesh = (make_production_mesh(multi_pod=args.multi_pod)
                if world == production else make_local_mesh())
        cfg = scaled_config(args.arch, args.preset)
        shape = SHAPES[args.shape]
        shape = dataclasses.replace(
            shape, global_batch=args.batch or shape.global_batch,
            seq_len=args.seq or shape.seq_len)
        model = build_model(cfg)
        pcfg, tcfg = ParallelConfig(), TrainConfig()
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        state = steps_mod.init_train_state(model, gen, pcfg, device)
        state = steps_mod.shard_train_state(
            state, steps_mod.train_state_shardings(model, mesh))
        step = steps_mod.make_sharded_train_step(model, pcfg, tcfg, mesh)
        print(f"[multihost] rank {rank}/{world} on {device}: {cfg.name}, "
              f"mesh {host_device_grid(mesh)}", flush=True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        tokens = torch.randint(
            0, cfg.vocab_size, (shape.global_batch, shape.seq_len + 1),
            generator=torch.Generator().manual_seed(tcfg.seed))
        batch = {"tokens": tokens[:, :-1].to(device),
                 "labels": tokens[:, 1:].to(device)}
        losses = []
        for _ in range(args.steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
        print(f"[multihost] rank {rank}: {args.steps} steps of "
              f"{shape.global_batch} x {shape.seq_len}, losses {losses}, "
              f"peak device memory "
              f"{'not measured (cpu)' if peak is None else f'{peak/2**30:.2f}GiB'}",
              flush=True)
        return {"rank": rank, "world": world,
                "mesh": host_device_grid(mesh), "losses": losses,
                "peak_bytes": peak}
    finally:
        if owned:
            dist.barrier()
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
