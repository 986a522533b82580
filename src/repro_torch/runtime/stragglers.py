"""Straggler detection + speculative re-execution over the Pilot layer.

Detection: robust z-score of CU latency against the running median (MAD).
Mitigation: speculative duplicate — when a CU overruns the straggler
threshold, resubmit it to the next-best pilot and take whichever finishes
first (the classic MapReduce backup-task trick, which the Pilot-Abstraction
makes trivial because CUs are idempotent descriptors).
"""
from __future__ import annotations

import statistics
import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait
from typing import List, Optional

from repro_torch.core.manager import ComputeDataManager
from repro_torch.core.pilot import ComputeUnit, ComputeUnitDescription


class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, min_samples: int = 5):
        self.durations: List[float] = []
        self.threshold = threshold
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self.flagged: List[str] = []

    def record(self, cu: ComputeUnit):
        if cu.end_time and cu.start_time:
            with self._lock:
                self.durations.append(cu.end_time - cu.start_time)

    def cutoff(self) -> Optional[float]:
        with self._lock:
            if len(self.durations) < self.min_samples:
                return None
            med = statistics.median(self.durations)
            mad = statistics.median(abs(d - med) for d in self.durations)
        return med + self.threshold * max(mad, 0.05 * med, 1e-4)

    def is_straggling(self, cu: ComputeUnit, now: Optional[float] = None) -> bool:
        cut = self.cutoff()
        if cut is None or not cu.start_time or cu.end_time:
            return False
        if (now or time.monotonic()) - cu.start_time > cut:
            with self._lock:
                self.flagged.append(cu.id)
            return True
        return False


def run_speculative(manager: ComputeDataManager, desc: ComputeUnitDescription,
                    monitor: StragglerMonitor, poll: float = 0.01,
                    max_backups: int = 1, timeout: float = 120.0):
    """Run a CU with speculative backup on straggle. Returns (result, info)."""
    primary = manager.submit(desc)
    cus = [primary]
    backups = 0
    t0 = time.monotonic()
    while True:
        done = [c for c in cus if c.future.done()]
        for c in done:
            monitor.record(c)
            if c.future.exception() is None:
                return c.future.result(), {
                    "winner": c.id, "speculative": c is not primary,
                    "launched": len(cus)}
        if done and all(c.future.done() for c in cus):
            # every attempt failed -> surface the primary's error
            primary.future.result()
        if (backups < max_backups and monitor.is_straggling(primary)):
            # backup must land on a different pilot than the straggler
            cus.append(manager.submit(
                desc, exclude=frozenset({primary.pilot_id})))
            backups += 1
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"CU {primary.id} timed out")
        time.sleep(poll)
