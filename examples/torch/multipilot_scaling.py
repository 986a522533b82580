"""Scaling out with multi-pilot distributed Pilot-Data (Pilot-API v2), on
the PyTorch port.

    PYTHONPATH=src python examples/torch/multipilot_scaling.py [--device cpu]

The port of ``examples/multipilot_scaling.py``.  Two pilots each own a
private TierManager (their retained memory ask); the session's
PilotDataService tracks which pilot holds which partition, and an
InterconnectModel prices cross-pilot transfers: when one pilot needs a
partition a sibling already holds, the fetch path reads it over the
modelled fabric link instead of re-pulling from the home store — and a
write still invalidates every replica coherently.  ``main(argv)`` returns
the numbers it prints.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import InterconnectModel, PilotSession, make_blobs


def host(x) -> np.ndarray:
    """A partition read as a host array (a device tier's is a tensor)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pts, _ = make_blobs(8_000, 8, d=16, seed=0)

    # the fabric: 12.5 GB/s default pilot-to-pilot links, a much slower
    # modelled home re-pull — so sibling replicas win the fetch race
    with PilotSession(interconnect=InterconnectModel(),
                      device=args.device) as s:
        pilots = s.add_pilots(2, memory_gb=0.05)

        # home placement: shared (cluster) storage the pilots pull from
        du = s.data("points", pts, parts=8)

        # distribute the working set: half the partitions to each pilot
        du.replicate_to_pilot(pilots[0], parts=range(0, 4))
        du.replicate_to_pilot(pilots[1], parts=range(4, 8))
        for p in pilots:
            print(f"{p.id}: replica residency {du.replica_residency(p)}")

        # replica-aware map_reduce: each pilot's group reads its own tiers
        r = s.kmeans(du, k=8, iters=3)
        sched = s.manager.stats()
        print(f"kmeans sse={r.sse_history[-1]:.3e} "
              f"({sched['submitted']} CUs over "
              f"{len(sched['per_pilot'])} pilots)")

        # cross-pilot replica read: pilot 1 pulls a partition only pilot 0
        # holds — the cost model routes it over the fabric, not home
        before = s.data_service.counters["sibling_reads"]
        du.partition(0, pilot=pilots[1])
        sibling = s.data_service.counters["sibling_reads"] - before
        print(f"sibling reads over the modelled interconnect: {sibling}")

        # coherent write: replicas are invalidated, readers re-pull
        du.update_partition(0, np.zeros_like(host(du.partition(0))))
        holders = s.data_service.holders(du._key(0))
        print(f"after write: partition 0 holders = {holders} "
              f"(re-pulled on next read)")
        np.testing.assert_array_equal(host(du.partition(0, pilot=pilots[0])),
                                      np.zeros_like(host(du.partition(0))))
        print("replica read after invalidation is coherent")

        # the zero-copy plane metered every one of those reads: views are
        # free aliases, copies are the memcpys the plane could not elide
        t = s.stats()["transport"]
        print(f"transport: {t['bytes_viewed'] / 2**20:.1f} MiB viewed "
              f"({t['views']} views) vs "
              f"{t['bytes_copied'] / 2**20:.1f} MiB copied "
              f"({t['copies']} copies), codec calls={t['codec']}")
    return {"sse_history": list(r.sse_history), "cus": sched["submitted"],
            "pilots": len(sched["per_pilot"]), "sibling_reads": sibling,
            "holders_after_write": holders, "coherent": True,
            "transport": t}


if __name__ == "__main__":
    main()
