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
(with seeded random weights).  ``main()`` returns the engine's stats dict.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import PilotSession
from repro_torch.launch.train import PRESETS, scaled_config
from repro_torch.models.model import build_model
from repro_torch.serving import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
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
    args = ap.parse_args(argv)

    cfg = scaled_config(args.arch, args.preset)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]

    with PilotSession(checkpoint_dir=args.checkpoint_dir,
                      supervise=args.supervise,
                      device=args.device) as session:
        ndev = (torch.cuda.device_count() if session.device.type == "cuda"
                else 1)
        session.add_pilots(args.pilots, num_devices=ndev,
                           memory_gb=args.memory_gb, affinity="server")
        engine = ServingEngine(
            session, model, batch_size=args.batch, max_len=args.max_len,
            temperature=args.temperature, page_tokens=args.page_tokens)
        with engine:
            engine.deploy()
            t0 = time.perf_counter()
            reqs = [engine.submit(p, args.gen) for p in prompts]
            engine.drain(timeout=600)
            wall = time.perf_counter() - t0
            stats = engine.stats()
            for r in reqs:
                if len(r.result()) != args.gen:
                    raise RuntimeError(f"request {r.rid} returned "
                                       f"{len(r.result())} tokens, "
                                       f"expected {args.gen}")
        steps = max(1, stats["decode_steps"])
        print(f"[serve] {cfg.name} on {session.device}: "
              f"{stats['completed']}/{args.requests} requests on "
              f"{args.pilots} pilot(s) in {wall:.1f}s; "
              f"{stats['tokens_served']} tokens "
              f"({stats['tokens_served'] / wall:.0f} tok/s, "
              f"{wall / steps * 1e3:.1f}ms/step), "
              f"p99 latency {stats['p99_latency_s'] * 1e3:.0f}ms, "
              f"refills={stats['refills']}, "
              f"recovered={stats['recovered_requests']}")
        return stats


if __name__ == "__main__":
    main()
