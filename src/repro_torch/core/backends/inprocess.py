"""In-process backend: pilots own a slice of the local torch devices.

This is the 'HPC' adaptor of the paper: the resource manager (here: the
process's device set) hands the pilot a static allocation; the pilot then
multiplexes CUs itself (multi-level scheduling). Device slices are leased so
two pilots never share a card unless oversubscription is requested.

A description's device type picks the pool: ``cuda`` leases from
``torch.cuda.device_count()`` cards (an explicit index pins that card),
``cpu`` from the one host device.
"""
from __future__ import annotations

import threading
import time
from typing import List

import torch

from repro_torch.core.backends.base import ComputeBackend, register_backend
from repro_torch.core.pilot import PilotCompute, PilotComputeDescription


def _pool(device: torch.device) -> List[torch.device]:
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class InProcessBackend(ComputeBackend):
    name = "inprocess"

    def __init__(self, oversubscribe: bool = True):
        self._lock = threading.Lock()
        self._leased: set = set()
        self.oversubscribe = oversubscribe

    def _lease(self, n: int, device: torch.device) -> List[torch.device]:
        devs = _pool(device)
        with self._lock:
            free = [d for d in devs if d not in self._leased]
            if len(free) < n:
                if not self.oversubscribe:
                    raise RuntimeError(
                        f"backend has {len(free)} free devices, need {n}")
                free = devs
            take = free[:n]
            self._leased.update(take)
            return take

    def capacity(self):
        """Free (unleased) cards — the hard scale-out bound when this
        adaptor is not oversubscribing; unbounded (None) when it is."""
        if self.oversubscribe:
            return None
        with self._lock:
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
            return max(0, cards - len(self._leased))

    def provision(self, desc: PilotComputeDescription) -> PilotCompute:
        t0 = time.time()
        n = max(1, min(desc.num_devices, len(_pool(desc.device))))
        devices = self._lease(n, desc.device)
        pilot = PilotCompute(desc, devices)
        # per-pilot managed memory from desc.memory / desc.durability
        # (volatile budgets + the shared durable spill tier), on the
        # pilot's first device
        self.attach_managed_memory(pilot, desc, device=devices[0])
        # resident task-engine workers (lazy threads; see taskengine)
        self.attach_worker_pool(pilot, desc)
        pilot.start()
        pilot.provision_time = time.time() - t0
        return pilot

    def health(self, pilot: PilotCompute) -> dict:
        # in-process pilots share our fate, so the base worker-loop
        # heartbeat is the whole truth; annotate with the device lease so
        # a supervisor can tell a released pilot from a dead one
        h = super().health(pilot)
        if pilot.devices:
            with self._lock:
                h["devices_leased"] = all(
                    d in self._leased for d in pilot.devices)
        return h

    def release(self, pilot: PilotCompute) -> None:
        super().release(pilot)
        if pilot.devices:
            with self._lock:
                self._leased.difference_update(pilot.devices)


register_backend(InProcessBackend())
