"""Quickstart: the Pilot-API v2 in ~30 lines, on the PyTorch port.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The port of ``examples/quickstart.py``.  One PilotSession owns the whole
stack — pilots (retained device allocations), Data-Units (tiered,
replica-managed), the data-aware scheduler, and deterministic teardown.
It runs on the card unless ``--device cpu`` is given (without CUDA the
default raises).  ``main(argv)`` returns the numbers it prints.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import PilotSession


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    data = np.random.default_rng(0).normal(size=(8192, 16)).astype(np.float32)

    with PilotSession(device=args.device) as s:
        # 1. provision a Pilot-Compute with a retained-memory ask (its own
        #    managed device/host tier hierarchy)
        pilot = s.add_pilot(num_devices=1, memory_gb=0.05, affinity="demo")
        print(f"pilot up: {pilot} (provisioned in "
              f"{pilot.provision_time:.3f}s)")

        # 2. a Compute-Unit is just a function + late binding
        cu = s.run(lambda a, b: a @ b, np.eye(4, dtype=np.float32),
                   np.arange(16.0).reshape(4, 4))
        trace = float(np.asarray(cu.result()).trace())
        print("CU result trace:", trace)

        # 3. a Data-Unit: partitioned, session-bound, replica-managed
        du = s.data("matrix", data, parts=4)
        du.replicate_to_pilot(pilot)    # stage the working set into HBM
        residency = du.replica_residency(pilot)
        print(f"staged {du}: replica residency {residency}")

        # 4. MapReduce through the replica-aware pipelined engine
        total = float(s.map_reduce(du, lambda p: torch.sum(p * p),
                                   lambda a, b: a + b))
        check = float((data * data).sum())
        print(f"sum of squares via map_reduce: {total:.1f} "
              f"(numpy check: {check:.1f})")

        scheduler = s.stats()["scheduler"]
        print("scheduler:", scheduler)
    # <- session teardown: replication drained, checkpoints flushed,
    #    TierManagers closed, pilots released
    print("quickstart OK")
    return {"trace": trace, "sum_sq": total, "numpy_sum_sq": check,
            "residency": residency, "scheduler": scheduler}


if __name__ == "__main__":
    main()
