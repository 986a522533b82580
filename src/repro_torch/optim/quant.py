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
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# a sharded leaf's blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """How the blockwise state (`quantize`'s blocks of the flattened
    leaf) of a leaf sharded over a mesh lies on its ranks.

    Where each rank's shard of the leaf, under placements `cut`, is a set
    of whole blocks of the leaf in the leaf's order, a rank quantizes
    that shard and gets the leaf's numbers there: the data is the leaf's
    blocks laid out as ``shape[:k] + (blocks, block)``, k the innermost
    dim `cut` cuts, under `cut` itself.  `cut` is the leaf's own
    placements where they allow it (the state then lies with the
    shards), else the leaf cut on one outer dim over the same ranks (its
    gradient and values are moved to that layout for the update, and
    back).  A leaf cut on no dim is whole on every rank: ``(blocks,
    block)``, replicated.  Where no dim will do (a leaf of a few blocks)
    `cut` is None: the blocks are dealt in equal chunks to the ranks that
    shard the leaf, ``(chunk * ranks, block)`` cut on dim 0 (zero blocks
    past the leaf's end), and a rank updates its chunk from the leaf's
    whole gradient and values (``train/steps.py``)."""
    data_shape: Tuple[int, ...]
    placements: tuple
    cut: Optional[tuple]

    @property
    def scale_shape(self) -> Tuple[int, ...]:
        return self.data_shape[:-1] + (1,)


def block_layout(shape, mesh, place, block_size: int = 256) -> BlockLayout:
    """The `BlockLayout` of a leaf of `shape` held under the DTensor
    placements `place` on `mesh`."""
    from torch.distributed.tensor import Replicate, Shard
    numel = math.prod(shape)
    size = tuple(mesh.shape)            # a DeviceMesh's or an abstract one's
    cuts = [(m, p.dim) for m, p in enumerate(place) if isinstance(p, Shard)]
    if not cuts:
        return BlockLayout((-(-numel // block_size), block_size),
                           tuple(place), tuple(place))

    def blocked(k: int, cut: tuple) -> BlockLayout:
        return BlockLayout(tuple(shape[:k]) + (
            math.prod(shape[k:]) // block_size, block_size), cut, cut)

    k = max(d for _, d in cuts)
    parts = math.prod(size[m] for m, d in cuts if d == k)
    if shape[k] // parts * math.prod(shape[k + 1:]) % block_size == 0:
        return blocked(k, tuple(place))
    ranks = math.prod(size[m] for m, _ in cuts)
    on = lambda dim: tuple(Shard(dim) if isinstance(p, Shard)
                           else Replicate() for p in place)
    for j, n in enumerate(shape):
        if n % ranks == 0 and (n // ranks * math.prod(shape[j + 1:])
                               % block_size == 0):
            return blocked(j, on(j))
    chunk = -(-numel // (block_size * ranks))
    return BlockLayout((chunk * ranks, block_size), on(0), None)


def fit_blocks(x, shape: Tuple[int, ...]):
    """`x` (a tensor or numpy array of blocks, in the flattened leaf's
    order) laid out as `shape`: its rows of ``shape[-1]`` cut or padded
    with zero rows (the blocks past a leaf's end hold nothing)."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    rows = x.reshape(-1, shape[-1])
    want = math.prod(shape[:-1])
    if rows.shape[0] >= want:
        return rows[:want].reshape(shape)
    if isinstance(x, np.ndarray):
        pad = np.zeros((want - rows.shape[0], shape[-1]), dtype=x.dtype)
        return np.concatenate([rows, pad]).reshape(shape)
    return torch.cat([rows, rows.new_zeros(
        (want - rows.shape[0], shape[-1]))]).reshape(shape)
