"""Run a snippet in N processes that form one process group, for the
port's multi-rank tests: gloo on the CPU, or NCCL with one card a rank.

Each rank is a ``python -c`` subprocess (PYTHONPATH=src, one OpenMP
thread) whose prelude joins the group through a file under the test's
tmp_path (no TCP port to clash under xdist) with a timeout, and whose
epilogue meets every peer at a ``barrier()`` before
``destroy_process_group()`` (a rank that leaves first breaks its peers'
connections).  The snippet sees ``rank``, ``world``, ``out`` (a
directory shared by the ranks), ``device``, ``np``, ``torch`` and
``dist``.  The whole group has one wall-clock timeout; ranks still
running then are killed, and so are the others when one fails.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PRELUDE = """
import datetime, os, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = Path(os.environ["DIST_OUT"])
backend = os.environ["DIST_BACKEND"]
device = torch.device("cuda", rank) if backend == "nccl" else None
if device is not None:
    torch.cuda.set_device(device)
dist.init_process_group(
    backend, init_method="file://" + os.environ["DIST_INIT"], rank=rank,
    world_size=world, timeout=datetime.timedelta(seconds=60),
    device_id=device)
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
print("rank-ok", rank)
"""


def spawn(code: str, world: int, tmp_path, timeout: float = 120.0,
          backend: str = "gloo") -> Path:
    """Run `code` on `world` ranks; assert each exits 0 within `timeout`
    seconds in all (a rank that fails stops its peers at once: they
    would wait on it in a collective).  Under ``backend="nccl"`` rank r
    runs on card r (``device`` in the snippet; None under gloo).
    Returns the shared ``out`` directory."""
    tmp = Path(tmp_path)
    out = tmp / "dist_out"
    out.mkdir(parents=True, exist_ok=True)
    init = tmp / "dist_init"
    if init.exists():
        init.unlink()
    script = PRELUDE + textwrap.dedent(code) + EPILOGUE
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "WORLD_SIZE": str(world), "DIST_OUT": str(out),
           "DIST_INIT": str(init), "DIST_BACKEND": backend,
           "PYTHONWARNINGS": "ignore"}
    logs = [(tmp / f"rank{r}.out", tmp / f"rank{r}.err")
            for r in range(world)]
    procs = []
    for r, (so, se) in enumerate(logs):
        with open(so, "w") as fo, open(se, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script], env={**env, "RANK": str(r)},
                stdout=fo, stderr=fe))
    deadline = time.monotonic() + timeout
    first_bad = None                # the first rank seen to exit non-zero
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad and first_bad is None:
                first_bad = bad[0]
            if time.monotonic() > deadline or bad:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if first_bad is None:
        first_bad = next((r for r, p in enumerate(procs)
                          if p.returncode not in (0, -9)), None)
    texts = [(so.read_text(), se.read_text()) for so, se in logs]
    ok = all(p.returncode == 0 and f"rank-ok {r}" in text
             for r, (p, (text, _)) in enumerate(zip(procs, texts)))
    assert ok, _report(procs, texts, first_bad, timeout)
    return out


def _report(procs, texts, first_bad, timeout) -> str:
    """Every rank's exit code, whether it printed ``rank-ok``, and the
    tails of its stdout and stderr; the first rank seen to exit non-zero
    is marked (a negative code is a kill: after a peer failed, or at the
    limit)."""
    lines = [f"ranks failed (negative exit: killed, after a peer failed "
             f"or at the {timeout} s limit):"]
    for r, (p, (text, err)) in enumerate(zip(procs, texts)):
        mark = "  <- first to exit non-zero" if r == first_bad else ""
        lines.append(f"rank {r}: exit {p.returncode}, rank-ok "
                     f"{'printed' if f'rank-ok {r}' in text else 'missing'}"
                     f"{mark}")
    for r, (text, err) in enumerate(texts):
        lines.append(f"--- rank {r} stdout (tail) ---\n{text[-1500:]}")
        lines.append(f"--- rank {r} stderr (tail) ---\n{err[-3000:]}")
    return "\n".join(lines)


def run_jax(code: str, devices: int, timeout: float = 120.0) -> str:
    """Run `code` in a JAX subprocess on `devices` host CPU devices (the
    count fixed before jax initializes, as tests/test_parallel.py does);
    returns its stdout."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout
