"""Carry state into the port from plain numpy arrays, and back.

Two kinds of state cross over, and this module imports nothing of the JAX
package:

- a DataUnit's partitions (the KMeans points): the centroids come from
  the same numpy RNG on both sides (``analytics.kmeans(seed=...)``), so
  only the DataUnit needs carrying::

      parts = [du_ref.partition_copy(i) for i in range(du_ref.num_partitions)]
      du = data_unit_from_numpy("points", parts, backends, tier="device")

- a model's params: the JAX package's param tree as nested dicts of numpy
  arrays (``jax.tree.map(np.asarray, params)``) becomes the port's tree of
  tensors, since init RNGs cannot match::

      params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

numpy has no bfloat16 of its own: a JAX-side bf16 leaf is an ``ml_dtypes``
array, read here through its uint16 bit pattern and viewed as
``torch.bfloat16``, so no ``ml_dtypes`` import is needed.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.data import DataUnit
from repro_torch.core.device import DeviceLike, resolve_device, to_device
from repro_torch.core.memory import StorageBackend
from repro_torch.models.common import tree_map


def data_unit_from_numpy(name: str, partitions: Sequence[np.ndarray],
                         backends: Dict[str, StorageBackend],
                         tier: str = "host") -> DataUnit:
    """A port DataUnit holding `partitions` (copied, one per partition,
    in order) on `tier` of `backends`."""
    return DataUnit.from_partitions(
        name, [np.array(p) for p in partitions], backends, tier=tier)


def tensor_from_numpy(arr: np.ndarray, device: DeviceLike = None,
                      bfloat16: bool = False) -> torch.Tensor:
    """A new tensor on `device` holding a copy of `arr` (``to_device``).
    A bfloat16 leaf (``arr.dtype.name == "bfloat16"``, or its uint16 bit
    pattern with ``bfloat16=True``) becomes a ``torch.bfloat16`` tensor
    bit for bit."""
    if bfloat16 or arr.dtype.name == "bfloat16":
        bits = arr.view(np.uint16).view(np.int16)
        return to_device(bits, device).view(torch.bfloat16)
    return to_device(arr, device)


def _numpy_bfloat16() -> Optional[np.dtype]:
    """numpy's bfloat16 dtype where a library (ml_dtypes) registered one."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return None


def tensor_to_numpy(t: torch.Tensor, bf16_bits: bool = False) -> np.ndarray:
    """A host copy of `t`.  A bf16 tensor comes back as numpy's bfloat16
    where one is registered, else (or with `bf16_bits`) as its uint16 bit
    pattern."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    bits = t.view(torch.int16).numpy().view(np.uint16).copy()
    bf16 = None if bf16_bits else _numpy_bfloat16()
    return bits if bf16 is None else bits.view(bf16)


def params_from_numpy(tree, device: DeviceLike = None):
    """The JAX package's param tree (nested dicts of numpy arrays) as the
    port's tree of tensors on `device`, leaf by leaf, bits unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(np.asarray(a), dev), tree)


def params_to_numpy(tree):
    """The reverse of `params_from_numpy`: nested dicts of host arrays."""
    return tree_map(tensor_to_numpy, tree)
