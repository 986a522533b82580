"""Where the port's tensors live.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and with no CUDA it raises rather
than falling back, so a run that was meant for the card never measures
the host by accident.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import warnings
from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises.

    A bare ``cuda`` gets the current device's index, so that two spellings
    of one card compare equal (placement checks use ``==``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(value, device: DeviceLike = None) -> torch.Tensor:
    """A new tensor on `device` holding a copy of the host array `value`.

    It never aliases the caller's buffer (including the read-only views
    the data plane hands out): ``torch.from_numpy`` would share the bytes
    and let a later write reach the store (the mutation contract in
    ``buf.py``).  To a card the transfer is that copy, with no host copy
    before it (a model shard may be tens of GB)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.from_numpy(np.array(value))   # owned, writable copy
    arr = np.asarray(value)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        # a read-only view is only read here, by the host-to-device copy
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(arr).to(dev)
