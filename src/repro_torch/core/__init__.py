"""Pilot-API: the paper's unified abstraction, in PyTorch.

v2 (the PilotSession façade — one declarative surface, one lifecycle):

    from repro_torch.core import PilotSession

    with PilotSession() as s:               # device="cpu" for the host
        s.add_pilots(2, memory_gb=0.05)
        du = s.data("pts", points, parts=8)
        total = s.map_reduce(du, map_fn, reduce_fn)

v1 (the composable objects underneath — still public, still supported):

    from repro_torch.core import (PilotComputeService, PilotComputeDescription,
                            ComputeDataManager, DataUnit, make_backend)

    svc = PilotComputeService()
    pilot = svc.submit_pilot(PilotComputeDescription(backend="inprocess",
                                                     num_devices=1))
    backends = {"device": make_backend("device")}
    manager = ComputeDataManager(svc)
    du = DataUnit.from_array("pts", points, 8, backends, tier="device")
    cu = manager.run(my_fn, input_data=(du,))
    cu.result()
"""
from repro_torch.core.analytics import KMeansResult, assign_partial, kmeans, make_blobs
from repro_torch.core.autoscaler import (Autoscaler, LoadScalingPolicy,
                                         ScalingDecision, ScalingPolicy,
                                         ScalingSignals)
from repro_torch.core.buf import (Buf, STATS as TRANSPORT_STATS, copy_mode,
                            set_zero_copy, zero_copy_enabled)
from repro_torch.core.codecs import (Codec, PickleCodec, RawCodec, decode_file,
                               encoder_for, file_nbytes, register_codec,
                               unregister_codec)
from repro_torch.core.data import DataUnit, DataUnitDescription
from repro_torch.core.device import resolve_device, to_device
from repro_torch.core.manager import ComputeDataManager, PilotComputeService
from repro_torch.core.mapreduce import map_reduce
from repro_torch.core.memory import (CheckpointBackend, DURABLE_TIERS, PROFILES,
                               TIERS, TierProfile, checkpoint_store,
                               make_backend)
from repro_torch.core.pilot import (ComputeUnit, ComputeUnitDescription,
                              DurabilityDescription, MemoryDescription,
                              PilotCompute, PilotComputeDescription, State)
from repro_torch.core.pilotdata import PilotDataService
from repro_torch.core.rebalance import Migration, Rebalancer
from repro_torch.core.scheduling import (InterconnectModel, Link, LocalityPolicy,
                                   LocalityWeights, SchedulingPolicy)
from repro_torch.core.session import PilotSession
from repro_torch.core.supervisor import (Backoff, FailureDetector, PilotSupervisor,
                                   RespawnEvent)
from repro_torch.core.taskengine import (DispatchQueue, Task, TaskBatch,
                                   TaskEngine, TaskError, WorkerPool,
                                   current_pilot, read_partition)
from repro_torch.core.tiering import (CapacityError, EvictionPolicy, GDSFPolicy,
                                LRUPolicy, TierManager, make_policy,
                                make_tier_manager)

__all__ = [
    "DataUnit", "DataUnitDescription", "ComputeDataManager",
    "PilotComputeService", "map_reduce", "PROFILES", "TIERS", "TierProfile",
    "make_backend", "ComputeUnit", "ComputeUnitDescription", "PilotCompute",
    "PilotComputeDescription", "State", "kmeans", "KMeansResult",
    "assign_partial", "make_blobs", "CapacityError", "TierManager",
    "make_tier_manager", "EvictionPolicy", "LRUPolicy", "GDSFPolicy",
    "make_policy", "PilotDataService", "CheckpointBackend",
    "checkpoint_store", "DURABLE_TIERS",
    # Pilot-API v2
    "PilotSession", "MemoryDescription", "DurabilityDescription",
    "SchedulingPolicy", "LocalityPolicy", "LocalityWeights",
    "InterconnectModel", "Link",
    # the high-throughput task engine (raptor-style batched dispatch)
    "TaskEngine", "TaskBatch", "Task", "TaskError", "WorkerPool",
    "DispatchQueue", "current_pilot", "read_partition",
    # the supervision layer (self-healing sessions)
    "PilotSupervisor", "FailureDetector", "Backoff", "RespawnEvent",
    # the elasticity layer (autoscaling + proactive rebalancing)
    "Autoscaler", "ScalingPolicy", "LoadScalingPolicy", "ScalingSignals",
    "ScalingDecision", "Rebalancer", "Migration",
    # the zero-copy data plane (views, codecs, transport counters)
    "Buf", "TRANSPORT_STATS", "copy_mode", "set_zero_copy",
    "zero_copy_enabled", "Codec", "RawCodec", "PickleCodec",
    "register_codec", "unregister_codec", "encoder_for", "decode_file",
    "file_nbytes",
    # where tensors live (cuda unless the caller asks for the CPU)
    "resolve_device", "to_device",
]
