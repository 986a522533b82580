"""The paper's §4.3 experiment on the PyTorch port: KMeans over Pilot-Data
Memory backends.

    PYTHONPATH=src python examples/torch/kmeans_pilot.py \
        [--scenario i|ii|iii] [--device cpu]

The port of ``examples/kmeans_pilot.py``.  Runs Lloyd's KMeans with the
points DataUnit held in each storage tier: file (throttled to the paper's
Stampede-disk profile — SIMULATED; in a temporary directory), host (the
Redis analogue) and device/HBM (the Spark analogue), and reports the
per-iteration times + speedups.  The assignment step is the port's
``kmeans_assign`` kernel on the card, its plain version on the CPU.
``main(argv)`` returns, for each tier, its ms an iteration, its speedup,
its SSE history and its final centroids.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.core import (ComputeDataManager, DataUnit,
                              PilotComputeDescription, PilotComputeService,
                              kmeans, make_backend, make_blobs)
from repro_torch.core.analytics import PAPER_SCENARIOS
from repro_torch.core.device import resolve_device
from repro_torch.core.memory import PROFILES, FileBackend


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="ii", choices=list(PAPER_SCENARIOS))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, k = PAPER_SCENARIOS[args.scenario]
    print(f"scenario ({args.scenario}): {n} points x {k} clusters")
    pts, _ = make_blobs(n, min(k, 256), d=args.dim)

    svc = PilotComputeService()
    out = {"scenario": args.scenario, "n": n, "k": k, "tiers": {}}
    try:
        pilot = svc.submit_pilot(PilotComputeDescription(backend="inprocess",
                                                         device=dev))
        manager = ComputeDataManager(svc)
        with tempfile.TemporaryDirectory(prefix="kmeans_pilot") as root:
            backends = {"file": FileBackend(root, PROFILES["stampede_disk"]),
                        "host": make_backend("host"),
                        "device": make_backend("device", device=dev)}
            base = None
            for tier in ("file", "host", "device"):
                du = DataUnit.from_array(f"pts-{tier}", pts, 4, backends,
                                         tier=tier)
                res = kmeans(du, k=k, iters=args.iters,
                             manager=None if tier == "device" else manager,
                             pilot=pilot if tier == "device" else None)
                per = float(np.mean(res.iter_seconds))
                base = base or per
                print(f"  tier={tier:7s} {per*1e3:8.1f} ms/iter  "
                      f"speedup={base/per:5.2f}x  "
                      f"sse={res.sse_history[-1]:.0f}")
                out["tiers"][tier] = {
                    "ms_per_iter": per * 1e3, "speedup": base / per,
                    "sse_history": list(res.sse_history),
                    "centroids": np.asarray(res.centroids)}
                du.delete()
    finally:
        svc.cancel_all()
    return out


if __name__ == "__main__":
    main()
