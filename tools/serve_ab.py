#!/usr/bin/env python3
"""Time the port's one-card serving path in two or more checkouts, in
turns, on one card.

    python3 tools/serve_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of the repo (for a commit
against its parent: ``git archive <parent> src | tar -x -C build/parent``,
then give ``build/parent/src src src build/parent/src``).  Each SRC is
served in a process of its own, in the order given, through the API
that every slice of the port has had: a PilotSession on the card, one
pilot, a ServingEngine over Llama-3.2-1B at its published widths (bf16,
random weights from seed 0), batch 8, a 1024-slot cache.  A warm-up lot
of 8 requests (8 new tokens each) builds the runtime; then 16 greedy
requests of 64 new tokens, prompts of 96-160 tokens, are timed: ms per
decode step and tok/s over that lot.  Prints one JSON line per run, then
a last line with all of them and whether every run gave the same tokens.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ARCH, BATCH, MAX_LEN, GEN, WARM, TIMED = "llama3_2_1b", 8, 1024, 64, 8, 16


def one() -> dict:
    """Serve in this process (the checkout's ``src`` on PYTHONPATH)."""
    import numpy as np
    import torch
    from repro_torch.core import PilotSession
    from repro_torch.launch.train import scaled_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServingEngine
    cfg = scaled_config(ARCH, "full")
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(
        rng.integers(96, 161))).astype(np.int32)
        for _ in range(WARM + TIMED)]
    with PilotSession(device="cuda") as session:
        session.add_pilots(1, num_devices=1, memory_gb=4, affinity="server")
        with ServingEngine(session, model, batch_size=BATCH,
                           max_len=MAX_LEN) as engine:
            engine.deploy()
            for p in prompts[:WARM]:
                engine.submit(p, 8)
            engine.drain(timeout=600)
            before = engine.stats()["decode_steps"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [engine.submit(p, GEN) for p in prompts[WARM:]]
            engine.drain(timeout=600)
            wall = time.perf_counter() - t0
            steps = engine.stats()["decode_steps"] - before
            tokens = [list(map(int, r.result())) for r in reqs]
    return {"ms_per_step": wall / steps * 1e3, "decode_steps": steps,
            "tok_per_s": TIMED * GEN / wall, "wall_s": wall,
            "tokens_sha": hashlib.sha256(
                json.dumps(tokens).encode()).hexdigest()[:16]}


def main(srcs) -> int:
    runs = []
    for src in srcs:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        proc = subprocess.run([sys.executable, __file__, "--one"], env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        run = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   src=src)
        print(json.dumps(run), flush=True)
        runs.append(run)
    same = len({r["tokens_sha"] for r in runs}) == 1
    print(json.dumps({"runs": runs, "tokens_agree": same}))
    return 0 if same else 1


if __name__ == "__main__":
    if sys.argv[1:] == ["--one"]:
        print(json.dumps(one()))
    elif len(sys.argv) < 2:
        sys.exit(__doc__)
    else:
        sys.exit(main(sys.argv[1:]))
