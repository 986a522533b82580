"""Pilot-Compute: a retained placeholder allocation of accelerator resources.

Paper §3: "A Pilot-Compute allocates a set of computational resources"; CUs
are late-bound onto it without further system-level scheduling. Here the
retained resources are (i) a list of torch devices (and, for a pilot whose
description asks for a ``mesh_shape`` under a process group, a
``DeviceMesh`` over the group's ranks, current while its CUs run), and
(ii) *warm state*:
the executable cache and device-resident weights/data — the paper's
observation that YARN's per-application JVM+AM startup dominates short jobs
maps to kernel builds + data staging, and retaining them is the win.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import queue
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device


# default upper bound on waiting for one pre-binding stage-in before running
# the CU against wherever the data currently lives; per-pilot override via
# PilotComputeDescription(prebind_wait_s=...) / PilotSession(prebind_wait_s=.)
_PREBIND_WAIT_S = 120.0

# the worker loop stamps a heartbeat at least this often even when the CU
# queue is empty (the failure detector's liveness signal; see supervisor.py)
_HEARTBEAT_TICK_S = 0.05


class State(str, enum.Enum):
    NEW = "New"
    PENDING = "Pending"
    RUNNING = "Running"
    DONE = "Done"
    FAILED = "Failed"
    CANCELED = "Canceled"


_EVICTION_POLICIES = ("lru", "gdsf")


@dataclasses.dataclass(frozen=True)
class MemoryDescription:
    """The pilot's retained-memory ask (one TierManager's worth).

    `memory_gb` is the YARN-style device-tier (HBM) budget — 0 means the
    pilot gets no managed hierarchy at all; `host_memory_gb` optionally
    bounds the host tier (0 = unbounded).  The remaining knobs tune the
    TierManager built from the ask.
    """
    memory_gb: float = 0.0           # device-tier budget (0 = unmanaged)
    host_memory_gb: float = 0.0      # host-tier budget (0 = unbounded)
    eviction_policy: str = "lru"     # "lru" | "gdsf" for the pilot's tiers
    hysteresis: int = 0              # eviction ping-pong damping (clock ticks)
    stager_workers: int = 2          # TierManager stager pool width (the
    #                                  depth-k pipeline needs >= depth)

    def __post_init__(self):
        if self.memory_gb < 0 or self.host_memory_gb < 0:
            raise ValueError(
                f"MemoryDescription: memory_gb/host_memory_gb must be >= 0 "
                f"(got {self.memory_gb}/{self.host_memory_gb})")
        if self.eviction_policy not in _EVICTION_POLICIES:
            raise ValueError(
                f"MemoryDescription: eviction_policy must be one of "
                f"{_EVICTION_POLICIES}, got {self.eviction_policy!r}")
        if self.hysteresis < 0:
            raise ValueError("MemoryDescription: hysteresis must be >= 0, "
                             f"got {self.hysteresis}")
        if self.stager_workers < 1:
            raise ValueError("MemoryDescription: stager_workers must be "
                             f">= 1, got {self.stager_workers}")


@dataclasses.dataclass(frozen=True)
class DurabilityDescription:
    """The pilot's durable spill/recovery ask.

    `checkpoint_dir` adds the persistent checkpoint tier beneath the
    volatile budgets; pilots naming the same directory share ONE store
    (the recovery home after pilot loss).  `checkpoint_gb` optionally
    bounds it (0 = unbounded) and is meaningless without a directory.
    """
    checkpoint_dir: str = ""
    checkpoint_gb: float = 0.0

    def __post_init__(self):
        if self.checkpoint_gb < 0:
            raise ValueError("DurabilityDescription: checkpoint_gb must be "
                             f">= 0, got {self.checkpoint_gb}")
        if self.checkpoint_gb and not self.checkpoint_dir:
            raise ValueError(
                "DurabilityDescription: checkpoint_gb was set but "
                "checkpoint_dir is empty — a budget needs a directory to "
                "bound")


_MEMORY_FIELDS = tuple(f.name for f in dataclasses.fields(MemoryDescription))
_DURABILITY_FIELDS = tuple(f.name
                           for f in dataclasses.fields(DurabilityDescription))


@dataclasses.dataclass(frozen=True, init=False)
class PilotComputeDescription:
    """What to allocate (the paper's resource description), composed from
    nested sub-descriptions:

        PilotComputeDescription(
            backend="inprocess", num_devices=1,
            memory=MemoryDescription(memory_gb=0.5, eviction_policy="gdsf"),
            durability=DurabilityDescription(checkpoint_dir="/ckpt"))

    The flat legacy spelling (``memory_gb=0.5``, ``checkpoint_dir=...`` as
    direct kwargs) is still accepted — the compat constructor folds flat
    fields into the nested dataclasses, and read access to the flat names
    keeps working through properties — so descriptions written against
    the v1 API run unchanged.  Mixing a nested block with one of its flat
    fields is an error (ambiguous), as is any unknown kwarg.
    """
    backend: str = "inprocess"       # inprocess | simulated  (adaptor name)
    num_devices: int = 1
    # the pilot's device mesh: axis names and shape (() = no mesh); see
    # backends/inprocess.py for the ranks it spans
    mesh_axes: Tuple[str, ...] = ("data",)
    mesh_shape: Tuple[int, ...] = ()
    # where the pilot's CUs and device tier run: cuda unless the caller
    # asks for the CPU (resolved at construction; raises without CUDA)
    device: torch.device = None
    memory: MemoryDescription = MemoryDescription()
    durability: DurabilityDescription = DurabilityDescription()
    affinity: str = ""               # locality label
    queue_depth: int = 1024
    # simulated-backend knobs (provisioning latency per paper Fig. 6)
    startup_seconds: float = 0.0
    # upper bound on waiting for ONE pre-binding stage-in future before the
    # CU runs against wherever the data currently lives (scheduler config;
    # a stuck stage must delay a CU, never wedge it)
    prebind_wait_s: float = _PREBIND_WAIT_S
    # the pilot's resident task-engine pool (raptor-style function tasks):
    # worker-thread count and the backpressure bound of its dispatch queue
    task_workers: int = 2
    dispatch_queue_depth: int = 1024

    def __init__(self, backend: str = "inprocess", num_devices: int = 1,
                 mesh_axes: Tuple[str, ...] = ("data",),
                 mesh_shape: Tuple[int, ...] = (),
                 memory: Optional[MemoryDescription] = None,
                 durability: Optional[DurabilityDescription] = None,
                 affinity: str = "", queue_depth: int = 1024,
                 startup_seconds: float = 0.0,
                 prebind_wait_s: float = _PREBIND_WAIT_S,
                 task_workers: int = 2, dispatch_queue_depth: int = 1024,
                 device: DeviceLike = None, **legacy):
        unknown = set(legacy) - set(_MEMORY_FIELDS) - set(_DURABILITY_FIELDS)
        if unknown:
            raise TypeError(
                f"PilotComputeDescription: unknown field(s) "
                f"{sorted(unknown)}; valid flat legacy fields are "
                f"{sorted(_MEMORY_FIELDS + _DURABILITY_FIELDS)}")
        mem_kw = {k: v for k, v in legacy.items() if k in _MEMORY_FIELDS}
        dur_kw = {k: v for k, v in legacy.items() if k in _DURABILITY_FIELDS}
        if memory is None:
            memory = MemoryDescription(**mem_kw)
        elif mem_kw:
            raise ValueError(
                f"PilotComputeDescription: got both memory= and flat "
                f"field(s) {sorted(mem_kw)} — pass one spelling, not both")
        if durability is None:
            durability = DurabilityDescription(**dur_kw)
        elif dur_kw:
            raise ValueError(
                f"PilotComputeDescription: got both durability= and flat "
                f"field(s) {sorted(dur_kw)} — pass one spelling, not both")
        if num_devices < 1:
            raise ValueError("PilotComputeDescription: num_devices must be "
                             f">= 1, got {num_devices}")
        if any(int(n) < 1 for n in mesh_shape):
            raise ValueError("PilotComputeDescription: mesh_shape must be "
                             f"positive, got {tuple(mesh_shape)}")
        if queue_depth < 1:
            raise ValueError("PilotComputeDescription: queue_depth must be "
                             f">= 1, got {queue_depth}")
        if prebind_wait_s <= 0:
            raise ValueError("PilotComputeDescription: prebind_wait_s must "
                             f"be > 0, got {prebind_wait_s}")
        if task_workers < 1:
            raise ValueError("PilotComputeDescription: task_workers must "
                             f"be >= 1, got {task_workers}")
        if dispatch_queue_depth < 1:
            raise ValueError("PilotComputeDescription: dispatch_queue_depth "
                             f"must be >= 1, got {dispatch_queue_depth}")
        for k, v in (("backend", backend), ("num_devices", num_devices),
                     ("mesh_axes", tuple(mesh_axes)),
                     ("mesh_shape", tuple(int(n) for n in mesh_shape)),
                     ("device", resolve_device(device)),
                     ("memory", memory),
                     ("durability", durability), ("affinity", affinity),
                     ("queue_depth", queue_depth),
                     ("startup_seconds", startup_seconds),
                     ("prebind_wait_s", prebind_wait_s),
                     ("task_workers", task_workers),
                     ("dispatch_queue_depth", dispatch_queue_depth)):
            object.__setattr__(self, k, v)

    # -- flat legacy read access (v1 compat) ----------------------------
    @property
    def memory_gb(self) -> float:
        return self.memory.memory_gb

    @property
    def host_memory_gb(self) -> float:
        return self.memory.host_memory_gb

    @property
    def eviction_policy(self) -> str:
        return self.memory.eviction_policy

    @property
    def hysteresis(self) -> int:
        return self.memory.hysteresis

    @property
    def stager_workers(self) -> int:
        return self.memory.stager_workers

    @property
    def checkpoint_dir(self) -> str:
        return self.durability.checkpoint_dir

    @property
    def checkpoint_gb(self) -> float:
        return self.durability.checkpoint_gb


@dataclasses.dataclass
class ComputeUnitDescription:
    """A self-contained piece of work (paper's CU: an 'executable')."""
    fn: Callable
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    input_data: Sequence[Any] = ()          # DataUnits the CU reads
    prefetch_parts: Optional[Sequence[int]] = None  # partitions of the first
    #                                         input DU the CU reads first
    #                                         (ensure-availability hint)
    stage_inputs: bool = False              # promote cold DUs to host first
    output_tier: Optional[str] = None       # stage result into this tier
    affinity: str = ""
    name: str = ""
    # per-CU override of the pilot's prebind_wait_s (None = pilot default);
    # map_reduce threads its own prebind_wait_s through here
    prebind_wait_s: Optional[float] = None


class ComputeUnit:
    def __init__(self, desc: ComputeUnitDescription):
        self.desc = desc
        self.id = desc.name or f"cu-{uuid.uuid4().hex[:8]}"
        self.state = State.NEW
        self.future: Future = Future()
        self.submit_time: float = 0.0
        self.start_time: float = 0.0
        self.end_time: float = 0.0
        self.pilot_id: Optional[str] = None
        # pre-binding stage-in futures (paper: ensure data availability
        # before the CU starts): the manager queues them at bind time; the
        # pilot waits for them to land before running the CU body
        self.prebind_futures: List[Future] = []

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)

    def wait(self, timeout: Optional[float] = None):
        self.future.exception(timeout)
        return self.state


class PilotCompute:
    """A running pilot: device slice + worker + warm executable cache."""

    def __init__(self, desc: PilotComputeDescription,
                 devices: Sequence[torch.device], pilot_id: str = "",
                 mesh=None):
        self.desc = desc
        self.id = pilot_id or f"pilot-{uuid.uuid4().hex[:8]}"
        self.devices: List[torch.device] = list(devices)
        # a torch.distributed DeviceMesh over the ranks that run this
        # pilot with this rank (None: a pilot of this process alone)
        self.mesh = mesh
        self.state = State.PENDING
        self._queue: "queue.Queue[Optional[ComputeUnit]]" = queue.Queue(
            maxsize=desc.queue_depth)
        self._jit_cache: Dict[Any, Callable] = {}
        self._running = 0
        self._completed = 0
        self._pending = 0            # CUs accepted but not yet finished
        self._lock = threading.Lock()
        self._idle_cond = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None
        # liveness stamp (monotonic): beaten by the worker loop every tick
        # and by task-engine chunks; the supervisor's failure detector reads
        # it through ComputeBackend.health()
        self._last_heartbeat: float = time.monotonic()
        self.provision_time: float = 0.0
        self.failed_devices: set = set()   # runtime fault injection target
        # the pilot's retained in-memory resources (Pilot-Data Memory): a
        # TierManager whose device-tier budget is this pilot's HBM share
        self.tier_manager = None           # Optional[TierManager]
        # the pilot's resident task-engine worker pool (attached by the
        # backend at provision time; lazily by the TaskEngine otherwise)
        self.worker_pool = None            # Optional[taskengine.WorkerPool]

    # ------------------------------------------------------------------
    def start(self):
        self._worker = threading.Thread(target=self._run_loop, daemon=True,
                                        name=f"{self.id}-worker")
        self.state = State.RUNNING
        self._worker.start()
        return self

    def _run_loop(self):
        while True:
            try:
                cu = self._queue.get(timeout=_HEARTBEAT_TICK_S)
            except queue.Empty:
                self.beat()           # idle liveness: still here, just bored
                continue
            if cu is None:
                break
            if cu.state == State.CANCELED:
                self._cu_finished(ran=False)
                continue
            try:
                self._execute(cu)
            finally:
                self._cu_finished(ran=True)
        self.state = State.DONE

    def _cu_finished(self, ran: bool = True):
        """Retire one accepted CU and wake idle-waiters when the last one
        drains.  Lives here (not in _execute) so backend overrides with
        early-return paths can't leak the pending count."""
        with self._idle_cond:
            self._pending -= 1
            if ran:
                self._completed += 1
            if self._pending == 0:
                self._idle_cond.notify_all()
        self.beat()

    # -- liveness --------------------------------------------------------
    def beat(self) -> None:
        """Stamp the heartbeat (monotonic).  Called from the worker loop's
        idle tick, from CU retirement, and from task-engine chunk
        boundaries; a chaos 'stall' fault freezes it."""
        self._last_heartbeat = time.monotonic()

    @property
    def last_heartbeat(self) -> float:
        return self._last_heartbeat

    def heartbeat_age(self) -> float:
        return max(0.0, time.monotonic() - self.last_heartbeat)

    def _execute(self, cu: ComputeUnit):
        cu.state = State.RUNNING
        cu.start_time = time.monotonic()
        with self._lock:
            self._running += 1
        try:
            # pre-binding stage-in: the copies toward this pilot's tiers
            # were queued at bind time and overlapped the queue wait; they
            # must LAND before the CU body runs (refused/raced stages
            # resolve without raising — reads then pull through instead).
            # The wait is bounded per future by the pilot's configured
            # prebind_wait_s, so a wedged stager delays the CU, never
            # hangs it.
            wait_s = getattr(cu.desc, "prebind_wait_s", None)
            if wait_s is None:
                wait_s = getattr(self.desc, "prebind_wait_s",
                                 _PREBIND_WAIT_S)
            for f in cu.prebind_futures:
                try:
                    f.result(timeout=wait_s)
                except Exception:   # noqa: BLE001
                    pass
            # optional stage-in (cache promotion): off by default so cold
            # tiers keep their re-read cost semantics (paper's file backend)
            if cu.desc.stage_inputs:
                for du in cu.desc.input_data:
                    if du.tier in ("file", "object"):
                        du.to_tier("host", delete_source=False)
            with contextlib.ExitStack() as stack:
                if self.devices and self.devices[0].type == "cuda":
                    # the current CUDA device is per thread, and the CU
                    # runs on this pilot's worker thread
                    stack.enter_context(torch.cuda.device(self.devices[0]))
                if self.mesh is not None:
                    from repro_torch.parallel.sharding import sharding_context
                    stack.enter_context(sharding_context(self.mesh))
                result = cu.desc.fn(*cu.desc.args, **cu.desc.kwargs)
            cu.state = State.DONE
            cu.future.set_result(result)
        except Exception as e:  # noqa: BLE001 - CU failure is a state
            cu.state = State.FAILED
            cu.future.set_exception(e)
        finally:
            cu.end_time = time.monotonic()
            with self._lock:
                self._running -= 1

    # ------------------------------------------------------------------
    def submit_cu(self, cu: ComputeUnit) -> ComputeUnit:
        cu.state = State.PENDING
        cu.submit_time = time.monotonic()
        cu.pilot_id = self.id
        with self._lock:
            self._pending += 1
        try:
            self._queue.put(cu)
        except BaseException:
            self._cu_finished(ran=False)
            raise
        return cu

    def jit_cached(self, key, build: Callable[[], Callable]) -> Callable:
        """The retained-executable cache (warm-start across CUs)."""
        if key not in self._jit_cache:
            self._jit_cache[key] = build()
        return self._jit_cache[key]

    def attach_tier_manager(self, tm) -> "PilotCompute":
        self.tier_manager = tm
        return self

    @property
    def retained_memory_bytes(self) -> int:
        """The pilot's retained in-memory allocation: the device-tier budget
        of its TierManager (0 = unbounded/unmanaged)."""
        if self.tier_manager is not None:
            budget = self.tier_manager.budget("device")
            if budget is not None:
                return int(budget)
        return int(self.desc.memory_gb * 2 ** 30)

    @property
    def utilization(self) -> float:
        with self._lock:
            u = self._pending           # accepted CUs: queued + running
        pool = self.worker_pool
        if pool is not None:
            u += pool.queue.depth       # engine backlog counts as load
        return u

    def cancel(self):
        self._queue.put(None)
        if self._worker:
            self._worker.join(timeout=10)
        if self.worker_pool is not None:
            # drain the task-engine pool BEFORE closing the tiers: queued
            # function tasks may still read managed partitions
            self.worker_pool.close()
        if self.tier_manager is not None:
            self.tier_manager.close()   # stop the stager threads
        # a released pilot keeps no warm state: its cached executables and
        # what they hold (a serving replica's weights on the card) go
        # with it, even while something still refers to the pilot; so does
        # its mesh, which keeps its process groups alive (a gloo group that
        # outlives destroy_process_group still runs its workers when the
        # interpreter exits, and one dropping its last work's tensors then
        # aborts the process)
        self._jit_cache.clear()
        self.mesh = None
        self.state = State.CANCELED if self.state != State.DONE else self.state

    def wait_idle(self, timeout: float = 60.0):
        """Block until every accepted CU has retired (queued + running ==
        0).  Event-driven: CU retirement notifies the condition, so the
        wait wakes immediately instead of on a poll tick; the deadline is
        monotonic, immune to wall-clock jumps."""
        deadline = time.monotonic() + timeout
        with self._idle_cond:
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle_cond.wait(remaining)
            return True

    def __repr__(self):
        dev = len(self.devices)
        return (f"PilotCompute({self.id}, backend={self.desc.backend!r}, "
                f"devices={dev}, state={self.state.value})")
