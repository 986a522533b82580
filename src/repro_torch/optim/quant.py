"""Blockwise int8 quantization for optimizer state.

The port of ``repro/optim/quant.py``.  Symmetric per-block scaling (block
= flat groups of ``block_size``), the layout 8-bit optimizers use in
public literature (Dettmers et al., arXiv:2110.02861).  Scales are
float32; amortized cost about 8 + 32/block bits per element.

QTensor and LogQTensor are dataclasses of tensors with the original shape
beside them.  They are tree nodes for ``models.common.tree_map`` and
``tree_leaves`` (``tree_flatten``/``tree_unflatten``, as the JAX package
registers them as pytrees), whose leaves come in the JAX package's order,
``(data, scale)`` and ``(data, lo, hi)``: checkpoint leaf names depend on
it.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor        # int8 (n_blocks, block)
    scale: torch.Tensor       # float32 (n_blocks, 1)
    shape: Tuple[int, ...]    # original shape

    def tree_flatten(self):
        return (self.data, self.scale), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)


def _blocks(flat: torch.Tensor, block_size: int, fill: float = 0.0):
    pad = (-flat.numel()) % block_size
    if pad:
        flat = F.pad(flat, (0, pad), value=fill)
    return flat.reshape(-1, block_size)


def _unblock(flat: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return flat.reshape(-1)[:math.prod(shape)].reshape(shape)


def quantize(x: torch.Tensor, block_size: int = 256) -> QTensor:
    blocks = _blocks(x.float().reshape(-1), block_size)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale, tuple(x.shape))


def dequantize(q: QTensor) -> torch.Tensor:
    return _unblock(q.data.float() * q.scale, q.shape)


@dataclasses.dataclass
class LogQTensor:
    """Log-domain uint8 quantization for strictly-nonnegative tensors with
    huge dynamic range (Adam's second moment): linear int8 zeroes out small
    entries in a block whose max is large, exploding 1/sqrt(v) steps. Here
    the *multiplicative* error is bounded by exp((hi-lo)/254) per block."""
    data: torch.Tensor        # uint8 (n_blocks, block)
    lo: torch.Tensor          # float32 (n_blocks, 1) log-domain min
    hi: torch.Tensor          # float32 (n_blocks, 1) log-domain max
    shape: Tuple[int, ...]

    def tree_flatten(self):
        return (self.data, self.lo, self.hi), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux)


_LOG_EPS = 1e-30
# log(1e-30) computed in fp32, as the JAX package's ``jnp.log(_LOG_EPS)``
_LOG_EPS_F32 = float(np.log(np.float32(_LOG_EPS)))


def quantize_log(x: torch.Tensor, block_size: int = 256) -> LogQTensor:
    flat = torch.log(torch.clamp(x.float(), min=_LOG_EPS)).reshape(-1)
    blocks = _blocks(flat, block_size, fill=_LOG_EPS_F32)
    lo = blocks.amin(dim=-1, keepdim=True)
    hi = blocks.amax(dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(torch.round((blocks - lo) / span * 254), 0, 254)
    return LogQTensor(q.to(torch.uint8), lo, hi, tuple(x.shape))


def dequantize_log(q: LogQTensor) -> torch.Tensor:
    span = torch.clamp(q.hi - q.lo, min=1e-12)
    logs = q.data.float() / 254 * span + q.lo
    vals = torch.where(logs <= _LOG_EPS_F32 + 1e-6, 0.0, torch.exp(logs))
    return _unblock(vals, q.shape)
