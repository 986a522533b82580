"""Serving CLI: continuous-batching LM serving ON the pilot substrate.

    python -m repro_torch.launch.serve --arch llama3_2_1b --preset full \\
        --requests 32 --batch 8 --gen 64 --pilots 1

The port of ``repro/launch/serve.py``: a thin CLI over
``repro_torch.serving.ServingEngine`` (see that module).  Model shards and
KV-cache pages are tiered Pilot-Data partitions, requests route
replica-aware through the ``SchedulingPolicy``, each pilot runs its decode
loop as a long-lived resident task, and — with ``--supervise`` and a
``--checkpoint-dir`` — a pilot killed mid-stream has its in-flight
requests recovered from the durable tier.  It runs on the card unless
``--device cpu`` is given; ``--preset full`` serves the published config
(with seeded random weights), cut to ``--layers`` decoder layers where
it asks for it.  ``main()`` returns the engine's stats dict, with the
wall time, tokens a second, peak device memory (``max_memory_allocated``),
the process's peak resident host memory, the requests' mean queue wait
(submit to admission into a row) and their 95th-percentile time to first
token (nearest rank).

Over a multi-device pilot: ``--mesh DxM`` under ``torchrun`` (one rank a
card, ``torchrun --nproc-per-node D*M -m repro_torch.launch.serve --mesh
2x2 ...``) serves from one pilot whose mesh spans the ranks, data x model
(``serving/engine.py``): the batch split over the data axis (each of the
D data groups holds ``--batch``/D rows where D divides it and an MoE
layer's capacity groups nest in the groups, else the whole batch) and
tensor-parallel over the model axis; every rank runs the same
engine on the same prompts, holds its ``model`` shard of the weights and
its own checkpoint directory (``<checkpoint-dir>/rank<r>``); rank 0
prints, with its rows and cache bytes.  ``--prompt-len-max`` draws each prompt's length uniformly from
``--prompt-len`` to it.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import resource
import time

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.core import PilotSession
from repro_torch.core.device import resolve_device
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_mod
from repro_torch.kernels.flash_attention import flash_attention as flash_mod
from repro_torch.kernels.selective_scan import selective_scan as scan_mod
from repro_torch.launch.mesh import init_distributed
from repro_torch.launch.train import PRESETS, scaled_config
from repro_torch.models.model import build_model
from repro_torch.serving import ServingEngine


# the kernels' launch counters (module, attribute), read over the requests
KERNEL_COUNTS = {"decode_attention": (decode_mod, "LAUNCHES"),
                 "flash_attention": (flash_mod, "TC_LAUNCHES"),
                 "flash_attention_fp32": (flash_mod, "LAUNCHES"),
                 "selective_scan": (scan_mod, "LAUNCHES")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-len-max", type=int, default=None,
                    help="draw each prompt's length from --prompt-len to "
                         "this (default: all --prompt-len)")
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--pilots", type=int, default=1,
                    help="serving replicas (pilots) in the session")
    ap.add_argument("--memory-gb", type=float, default=0.5,
                    help="managed memory per pilot (shard + page tiers)")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="KV-page flush granularity in generated tokens")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="durable tier for shards + KV pages (enables "
                         "recovery of in-flight requests)")
    ap.add_argument("--supervise", action="store_true",
                    help="self-healing session: quarantine/respawn dead "
                         "pilots mid-stream")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers (default: the preset's); cuts a "
                         "published config too deep for one card")
    ap.add_argument("--mesh", default=None,
                    help="DxM: one pilot whose data x model mesh spans "
                         "the torchrun ranks: the batch split over the D "
                         "data groups (where D divides --batch and MoE "
                         "capacity groups nest in them), the "
                         "model tensor-parallel over M")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be at least 1")

    cfg = scaled_config(args.arch, args.preset)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    top = args.prompt_len_max or args.prompt_len
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(args.prompt_len, top + 1,
                                     size=args.requests)]

    dev = resolve_device(args.device)
    owned = False
    mesh_shape = ()
    if args.mesh:
        mesh_shape = tuple(int(n) for n in args.mesh.split("x"))
        if args.pilots != 1:
            raise ValueError("--mesh serves from one pilot")
        if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
        owned = init_distributed(dev)
    rank = dist.get_rank() if dist.is_initialized() else 0
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir and mesh_shape:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
    try:
        return _serve(args, cfg, model, prompts, dev, mesh_shape, ckpt_dir,
                      print if rank == 0 else (lambda *a, **k: None))
    finally:
        if owned:
            dist.barrier()
            dist.destroy_process_group()


def _serve(args, cfg, model, prompts, dev, mesh_shape, ckpt_dir, say):
    with PilotSession(checkpoint_dir=ckpt_dir, supervise=args.supervise,
                      device=dev) as session:
        if mesh_shape:
            session.add_pilot(num_devices=1, mesh_axes=("data", "model"),
                              mesh_shape=mesh_shape,
                              memory_gb=args.memory_gb, affinity="server")
        else:
            ndev = (torch.cuda.device_count()
                    if session.device.type == "cuda" else 1)
            session.add_pilots(args.pilots, num_devices=ndev,
                               memory_gb=args.memory_gb, affinity="server")
        engine = ServingEngine(
            session, model, batch_size=args.batch, max_len=args.max_len,
            temperature=args.temperature, page_tokens=args.page_tokens)
        with engine:
            t0 = time.perf_counter()
            engine.deploy()
            engine.wait_ready()
            setup = time.perf_counter() - t0
            if session.device.type == "cuda":
                # the serving peak, not the draw's: the params on the
                # card, the cache and the activations
                torch.cuda.reset_peak_memory_stats(session.device)
            for mod, attr in KERNEL_COUNTS.values():
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            reqs = [engine.submit(p, args.gen) for p in prompts]
            engine.drain(timeout=600)
            wall = time.perf_counter() - t0
            stats = engine.stats()
            stats["launches"] = {name: getattr(mod, attr) for name, (
                mod, attr) in KERNEL_COUNTS.items()}
            for r in reqs:
                if len(r.result()) != args.gen:
                    raise RuntimeError(f"request {r.rid} returned "
                                       f"{len(r.result())} tokens, "
                                       f"expected {args.gen}")
            stats["tokens"] = [r.result() for r in reqs]
            waits = [r.queue_s for r in reqs]
            ttfts = sorted(r.ttft_s for r in reqs)
            stats["queue_wait_ms"] = 1e3 * sum(waits) / len(waits)
            stats["ttft_p95_s"] = ttfts[math.ceil(0.95 * len(ttfts)) - 1]
        # the passes every rank shares (a data group with no active row
        # skips its decode, but not the pass)
        steps = max(1, stats["decode_passes"])
        stats["wall_s"] = wall
        stats["setup_s"] = setup
        stats["tok_per_s"] = stats["tokens_served"] / wall
        stats["peak_device_gb"] = (
            torch.cuda.max_memory_allocated(session.device) / 1e9
            if session.device.type == "cuda" else 0.0)
        stats["peak_host_gb"] = (resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9)
        say(f"[serve] {cfg.name} on {session.device}"
            + (f", mesh {args.mesh}" if mesh_shape else "") + ": "
            f"{stats['completed']}/{args.requests} requests on "
            f"{args.pilots} pilot(s) in {wall:.1f}s (deploy and load "
            f"{setup:.1f}s before); "
            f"{stats['tokens_served']} tokens "
            f"({stats['tok_per_s']:.0f} tok/s, "
            f"{wall / steps * 1e3:.1f}ms/step), "
            f"p50 latency {stats['p50_latency_s'] * 1e3:.0f}ms, "
            f"p99 latency {stats['p99_latency_s'] * 1e3:.0f}ms, "
            f"peak device {stats['peak_device_gb']:.2f} GB, "
            f"peak host {stats['peak_host_gb']:.2f} GB, "
            f"rows a rank {stats['rows_local']}, "
            f"cache {stats['cache_bytes'] / 1e9:.3f} GB a rank, "
            f"refills={stats['refills']}, "
            f"recovered={stats['recovered_requests']}, "
            f"kernel launches {stats['launches']}, "
            f"decode graphs {stats['decode_graph_captures']} captured "
            f"{stats['decode_graph_replays']} replayed, "
            f"mean queue wait {stats['queue_wait_ms']:.0f}ms, "
            f"p95 first token {stats['ttft_p95_s'] * 1e3:.0f}ms")
        return stats


if __name__ == "__main__":
    main()
