"""Mesh construction over a ``torch.distributed`` process group.

The port of ``repro/launch/mesh.py``.  Functions, not module-level
constants, so importing never touches the process group.  A mesh is a
``DeviceMesh`` (``init_device_mesh``) over the ranks of the default group,
one rank per device; ``make_abstract_mesh`` builds the device-less mesh
that ``parallel.sharding.resolve_pspec`` needs to plan a mesh no process
group spans (the JAX package's ``AbstractMesh``).

``mesh_axis_types`` and ``compat_shard_map`` have no counterpart: they
bridge JAX versions (explicit axis types, the ``shard_map`` API), and the
port's collectives are written per rank against the mesh's groups, where
the JAX package's run inside ``shard_map``.

``init_distributed`` starts the default group where ``torchrun``'s
environment variables name one (NCCL on the card, gloo on the CPU).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Tuple

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind them."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def init_distributed(device: torch.device) -> bool:
    """Join the default process group that ``torchrun``'s environment
    names (``init_method="env://"``), on `device`'s backend; True if this
    call started it (the caller then destroys it), False if a group was
    already up or the environment names none."""
    if dist.is_initialized() or not all(k in os.environ
                                        for k in TORCHRUN_ENV):
        return False
    cuda = device.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=600),
                            device_id=device if cuda else None)
    return True


def mesh_device_type() -> str:
    """The device type of the default group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_abstract_mesh(shape: Tuple[int, ...],
                       axes: Tuple[str, ...]) -> AbstractMesh:
    """Device-less mesh for PartitionSpec resolution."""
    return AbstractMesh(tuple(shape), tuple(axes))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A DeviceMesh of `shape` over the default group's ranks, in rank
    order, its dims named `axes`."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


# multi_pod -> (shape, axes) of the production mesh
PRODUCTION_MESH = {False: ((16, 16), ("data", "model")),
                   True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*PRODUCTION_MESH[multi_pod])


def make_local_mesh(model_parallel: int = 1):
    """Best-effort mesh over whatever ranks exist (tests / examples)."""
    n = dist.get_world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    return make_mesh((n // mp, mp), ("data", "model"))


def host_device_grid(mesh) -> dict:
    """Telemetry: devices per axis (for launch scripts / logs)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
