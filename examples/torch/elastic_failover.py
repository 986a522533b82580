"""Self-healing session demo on the PyTorch port: a pilot is chaos-killed
mid-KMeans and the supervision layer recovers it live — detection,
quarantine, respawn from the dead pilot's own description, and
replication repair — while the analytics keep converging.  The recovery
trace is printed straight from ``session.stats()["supervisor"]`` (the
observability surface), so what you see is what any dashboard would see.

    PYTHONPATH=src python examples/torch/elastic_failover.py [--device cpu]

The port of ``examples/elastic_failover.py``.  Act 2 runs the step-loop
path (``ResilientRunner``), which delegates its replace/quarantine
mechanics to the same supervisor; its step state is a pair of torch
scalars on the pilots' device.  Checkpoints go to temporary directories.
The simulated backends registered here are replaced by a plain one at
the end.  ``main(argv)`` returns the numbers it prints.
"""
import argparse
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core import (PilotComputeDescription, PilotComputeService,
                              PilotSession, make_blobs)
from repro_torch.core.backends.base import register_backend
from repro_torch.core.backends.simulated import (ChaosEvent, ChaosPolicy,
                                                 FaultPolicy,
                                                 SimulatedClusterBackend)
from repro_torch.core.device import resolve_device
from repro_torch.runtime.fault_tolerance import ResilientRunner


def trace_loop(session, stop, lines):
    """Poll the supervisor observability surface and narrate changes."""
    seen_q, seen_r = set(), 0
    while not stop.is_set():
        sup = session.stats().get("supervisor")
        if sup:
            for pid in sup["quarantined"]:
                if pid not in seen_q:
                    seen_q.add(pid)
                    phi = sup["pilots"].get(pid, {}).get("phi", float("inf"))
                    lines.append(f"  [trace] QUARANTINE {pid} "
                                 f"(phi={phi:.1f})")
            for ev in sup["respawns"][seen_r:]:
                seen_r += 1
                lines.append(f"  [trace] RESPAWN {ev['old_pilot']} -> "
                             f"{ev['new_pilot'] or '<aborted>'} "
                             f"({ev['reason']}, "
                             f"downtime {ev['downtime_s']*1e3:.0f}ms)")
        stop.wait(0.02)


def act1_supervised_session(dev) -> dict:
    print("== act 1: supervised PilotSession, chaos kill mid-KMeans ==")
    register_backend(SimulatedClusterBackend(
        substrate="slurm",
        policy=ChaosPolicy(lose_memory=True, target_index=0,
                           events=(ChaosEvent(at_s=0.15, action="kill"),))))
    pts, _ = make_blobs(200_000, 8, d=8, seed=0)
    with tempfile.TemporaryDirectory() as ck, \
         PilotSession(name="failover", supervise=True, checkpoint_dir=ck,
                      supervisor_kwargs={"interval_s": 0.02,
                                         "min_heartbeat_s": 0.05,
                                         "repair_interval_s": 0.05},
                      device=dev) as s:
        victim = s.add_pilot(backend="simulated", startup_seconds=0.01,
                             memory_gb=0.1, host_memory_gb=0.4)
        s.add_pilots(2, memory_gb=0.1, host_memory_gb=0.4)
        du = s.data("pts", pts, parts=12, persist=True, replication=2)
        s.data_service.replicate_to_pilot(du, victim.id, tier="host")
        print(f"  fleet: {[p.id for p in s.pilots]}, victim {victim.id}")

        stop, lines = threading.Event(), []
        t = threading.Thread(target=trace_loop, args=(s, stop, lines))
        t.start()
        res = s.kmeans(du, k=8, iters=6)
        # wait for the repair queue to drain before auditing
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            rs = s.data_service.replication_stats()["pts"]
            if s.supervisor.respawns and rs["under"] == 0:
                break
            time.sleep(0.05)
        stop.set()
        t.join()
        for ln in lines:
            print(ln)

        sup = s.stats()["supervisor"]
        rs = sup["replication"]["pts"]
        print(f"  kmeans SSE: {res.sse_history[-1]:.1f} "
              f"({len(res.sse_history)} iters)")
        print(f"  respawns: {len(sup['respawns'])}, "
              f"repairs: {s.data_service.counters['repairs']}, "
              f"replication under target: {rs['under']}")
        ref = np.array_split(pts, 12, axis=0)
        intact = all(np.array_equal(_host(du.partition(i)), ref[i])
                     for i in range(12))
        print(f"  data intact after storm: {intact}")
        assert intact and len(sup["respawns"]) >= 1 and rs["under"] == 0
        return {"sse_history": list(res.sse_history),
                "respawns": len(sup["respawns"]),
                "repairs": s.data_service.counters["repairs"],
                "under": rs["under"], "intact": intact}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def act2_resilient_runner(dev) -> dict:
    print("== act 2: step-loop recovery (ResilientRunner on the same "
          "supervisor) ==")
    register_backend(SimulatedClusterBackend(
        substrate="yarn", policy=FaultPolicy(fail_devices_at=6)))
    svc = PilotComputeService()
    with tempfile.TemporaryDirectory() as ck:
        runner = ResilientRunner(
            svc, PilotComputeDescription(backend="simulated", device=dev),
            CheckpointManager(ck, keep=2), checkpoint_every=3,
            max_recoveries=5)

        def step_fn(state, batch):
            new = {"w": state["w"] + batch, "step": state["step"] + 1}
            return new, {"w": float(new["w"])}

        state = {"w": torch.tensor(0.0, dtype=torch.float32, device=dev),
                 "step": torch.tensor(0, dtype=torch.int32, device=dev)}
        one = torch.tensor(1.0, dtype=torch.float32, device=dev)
        final, _ = runner.run(state, step_fn, num_steps=20,
                              batch_fn=lambda i: one)
        svc.cancel_all()
    print(f"  finished: w={float(final['w'])} (expected 20.0)")
    for ev in runner.recoveries:
        print(f"  recovery: pilot {ev.old_pilot} -> {ev.new_pilot}, "
              f"rolled back step {ev.step} -> {ev.restored_step}, "
              f"downtime {ev.downtime_s*1e3:.0f}ms")
    assert float(final["w"]) == 20.0
    return {"w": float(final["w"]), "step": int(final["step"]),
            "recoveries": [(ev.step, ev.restored_step)
                           for ev in runner.recoveries]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    try:
        out = {"act1": act1_supervised_session(dev),
               "act2": act2_resilient_runner(dev)}
    finally:
        register_backend(SimulatedClusterBackend())
    print("elastic failover OK")
    return out


if __name__ == "__main__":
    main()
