"""Carry state into the port from plain numpy arrays.

The system has no weights: its state is the points DataUnit and the
centroids.  The centroids come from the same numpy RNG on both sides
(``analytics.kmeans(seed=...)``), so only the DataUnit needs carrying.
This module takes plain arrays and imports nothing of the JAX package,
for example::

    parts = [du_ref.partition_copy(i) for i in range(du_ref.num_partitions)]
    du = data_unit_from_numpy("points", parts, backends, tier="device")
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.data import DataUnit
from repro_torch.core.memory import StorageBackend


def data_unit_from_numpy(name: str, partitions: Sequence[np.ndarray],
                         backends: Dict[str, StorageBackend],
                         tier: str = "host") -> DataUnit:
    """A port DataUnit holding `partitions` (copied, one per partition,
    in order) on `tier` of `backends`."""
    return DataUnit.from_partitions(
        name, [np.array(p) for p in partitions], backends, tier=tier)
