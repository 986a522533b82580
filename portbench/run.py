#!/usr/bin/env python3
"""Run one cell of the benchmark on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

The cell is found in ``BENCHMARK.json`` at the checkout's root, and with
it its configuration, traffic mix, metric readers and limits
(``portbench/__init__.py``).  With ``--trace 0`` the result reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from the same run with the profiler on for a slice of the window.  The
last line of standard output is the result, a JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``busy_s`` and ``window_s`` too when traced), ``breakdown`` when traced,
and last ``checks``: each number the output check compared, with its
limit; the last lines of standard error give the same.  ``--control 1``
puts the float8 control of the check (``harness/check.py``) in the
program's place, so that ``correct`` has to come out false, and gives the
program's own widest gap under ``control``; it is for setting and proving
the limits, and the benchmark's own runs leave it off.

No result is printed, and the exit code is not 0, where the card or the
cards the cell asks for are missing, where the program cannot be found
or a run fails, and where, once the window has closed, this process
holds a module of JAX or of the JAX package ``repro`` (compared by whole
top-level names: ``repro_torch`` is the program).  The host's intra-op
threads are fixed at `THREADS`, and every cache of compiled kernels lies
under ``build/`` in the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREADS = 1
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def forbidden(modules) -> list:
    """The top-level names among `modules` that the program may not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def environment() -> None:
    """Fixed threads and the caches' directories, before torch loads."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    os.environ["USE_FLAX"] = "0"


def card(chips: int):
    """(device, its name) for a run, or None where this machine lacks the
    CUDA cards the cell asks for."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return "cuda:0", torch.cuda.get_device_name(0)


def read_metrics(entries, run) -> dict:
    from portbench.harness.cell import load_module
    out = {}
    for i, m in enumerate(entries):
        reader = load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{i}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    torch.set_num_threads(THREADS)
    from portbench.harness import cell, check, spec
    bench = spec.load(ROOT)
    chips = spec.workload(bench, args.workload)["chips"]
    found = card(chips)
    if found is None:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    where, kind = found
    print(f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{THREADS} intra-op threads", file=sys.stderr)
    got = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   where, t_start=T_START, root=ROOT,
                   control=bool(args.control))
    run = got["run"]
    metrics = read_metrics(spec.metrics_of(bench, args.workload,
                                           bool(args.trace)), run)
    device = {"platform": "gpu", "kind": kind,
              "count": chips, "memory_peak_bytes": int(got["peak"])}
    line = {"correct": check.passed(got["checks"]),
            "attempted": got["attempted"], "failed": got["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        if run.slice is None:
            print("the traced run read no profiler slice", file=sys.stderr)
            return 4
        device.update(busy_s=run.slice.busy_s, window_s=run.slice.window_s)
        line["breakdown"] = run.slice.breakdown()
    if args.control:
        line["control"] = {"program_max_logit_gap": got["program_gap"]}
    line["checks"] = got["checks"]
    bad = forbidden(list(sys.modules))
    if bad:
        print(f"this process loaded {bad}: the benchmark may not run JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    lat = sorted(run.latencies)
    p95 = lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
    print(f"requests completed in the window: {len(lat)}; their 95th "
          f"percentile latency {p95!r} s")
    for name, c in got["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:      # noqa: BLE001 - any failure: a code, no result
        traceback.print_exc()
        code = 1
    sys.exit(code)
