"""Parameter-spec machinery + shared layer math (norms, RoPE, FFN).

The port of ``repro/models/common.py``.  Models are plain functions on
tensors: ``*_specs(cfg)`` returns a nested dict of ParamSpec (shape +
logical axes + initializer + dtype); ``init_params`` materializes it on a
device from an explicit ``torch.Generator``.  The math keeps the JAX
package's casts: fp32 inside the norm, RoPE and the activation, then back
to the activation dtype.  ``with_logical_constraint`` has no counterpart
(it is a no-op without a mesh), and the loss comes with the training
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled | mamba_a | mamba_dt
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamSpec: shape {self.shape} and logical "
                             f"axes {self.logical} differ in rank")


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a tree of dicts (keys in sorted order,
    the order ``jax.tree_util`` walks a dict in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts (sorted keys), tuples and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def stack_specs(tree, num: int, logical: str = "layers"):
    """Prepend a stacked (layer) dimension to every spec in the tree."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(num,) + s.shape, logical=(logical,) + s.logical), tree)


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "mamba_a":
        # A_log: log of 1..N broadcast over d_inner (shape (..., d, N))
        n = spec.shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a.expand(spec.shape).contiguous()).to(spec.dtype)
    if spec.init == "mamba_dt":
        # dt bias: inverse softplus of uniform in [1e-3, 1e-1]
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=device) * (1e-1 - 1e-3) + 1e-3
        return (u + torch.log(-torch.expm1(-u))).to(spec.dtype)
    if spec.init not in ("normal", "scaled"):
        raise ValueError(f"unknown init {spec.init!r}")
    scale = spec.scale
    if spec.init == "scaled":  # 1/sqrt(fan_in), fan_in as the JAX package
        fan_in = (spec.shape[0] if len(spec.shape) >= 2
                  else max(spec.shape[-1], 1))
        scale = 1.0 / np.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(spec.dtype)


def init_params(spec_tree, generator: torch.Generator,
                device: torch.device) -> Dict[str, Any]:
    """Materialize a ParamSpec tree on `device`, drawing from `generator`
    (which must live on `device`) leaf by leaf in sorted-key order."""
    return tree_map(lambda s: _init_leaf(s, generator, device), spec_tree)


# ---------------------------------------------------------------------------
# Shared math
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs        # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype: fp32 activations against bf16 weights compute
    in fp32, as jnp's type promotion does; a no-op cast when they agree."""
    return x @ w.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = linear(x, w_gate)
    u = linear(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return linear(h, w_down)


def dense_ffn(x: torch.Tensor, ffn_params, act: str = "swiglu"):
    """Dense FFN: 3-matrix SwiGLU or 2-matrix GELU (starcoder2/whisper)."""
    if act == "swiglu":
        return swiglu(x, ffn_params["w_gate"], ffn_params["w_up"],
                      ffn_params["w_down"])
    u = linear(x, ffn_params["w_up"])
    h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return linear(h, ffn_params["w_down"])
