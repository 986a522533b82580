"""Mamba-1 selective SSM block: full-sequence scan (prefill) and
single-token recurrence (decode).

The port of ``repro/models/ssm.py``.  The prefill scan goes through
``selective_scan_op``, which launches the hand-written CUDA kernel
(``kernels/selective_scan``) on a CUDA tensor and runs its plain version on
a CPU tensor; the JAX package runs a chunked associative scan in jnp here
and holds its Pallas kernel to the same recurrence.  Decode is one step of
the recurrence in plain torch, as in the JAX package, and writes the conv
history and the state into the cache in place.  ``with_logical_constraint``
has no counterpart (it is a no-op without a mesh).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan.ops import selective_scan_op
from repro_torch.models.common import ParamSpec, linear


def ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    dt = s.resolved_dt_rank(d)
    n = s.state_dim
    return {
        "w_in": ParamSpec((d, 2 * di), ("embed", "ssm_inner"), "scaled"),
        "conv_w": ParamSpec((s.conv_kernel, di), ("conv_k", "ssm_inner"), "scaled"),
        "conv_b": ParamSpec((di,), ("ssm_inner",), "zeros"),
        "w_x": ParamSpec((di, dt + 2 * n), ("ssm_inner", "dt_rank"), "scaled"),
        "w_dt": ParamSpec((dt, di), ("dt_rank", "ssm_inner"), "scaled"),
        "dt_bias": ParamSpec((di,), ("ssm_inner",), "mamba_dt",
                             dtype=torch.float32),
        "a_log": ParamSpec((di, n), ("ssm_inner", "ssm_state"), "mamba_a",
                           dtype=torch.float32),
        "d_skip": ParamSpec((di,), ("ssm_inner",), "ones", dtype=torch.float32),
        "w_out": ParamSpec((di, d), ("ssm_inner", "embed"), "scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x: (B,S,di); w: (k,di) depthwise. state: (B,k-1,di) carried history.
    Returns (out, new_state); new_state is a view into a new tensor."""
    k = w.shape[0]
    if state is None:
        hist = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    else:
        hist = state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)                     # (B, S+k-1, di)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else hist
    return out, new_state


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                   d_skip: torch.Tensor, h0: Optional[torch.Tensor] = None,
                   scan_dtype="float32"):
    """x, dt: (B,S,di); a: (di,n); b_ssm, c_ssm: (B,S,n); h0: (B,di,n) or
    None (zeros).  Returns (y (B,S,di) in x's dtype, h_end (B,di,n) fp32).

    The state and its sums stay in fp32 and y = h.C + D*x is summed in fp32
    before the cast to x's dtype (the JAX package adds D*x in x's dtype,
    which rounds differently in bf16).  `scan_dtype` must be float32: the
    bf16 scan operands of the JAX package are a training setting that no
    config uses."""
    if scan_dtype not in ("float32", torch.float32):
        raise ValueError(f"selective_scan: scan_dtype {scan_dtype!r} is not "
                         f"supported; the port scans in float32")
    x = x.contiguous()
    return selective_scan_op(
        x, dt.float().contiguous(), a.float().contiguous(),
        b_ssm.to(x.dtype).contiguous(), c_ssm.to(x.dtype).contiguous(),
        d_skip.float().contiguous(), None if h0 is None else h0.float())


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  return_state: bool = False):
    """Full-sequence mamba block. x: (B,S,d). Optionally carries/returns
    state {"conv": (B,k-1,di), "ssm": (B,di,n)} for the prefill->decode
    handoff."""
    s_cfg = cfg.ssm
    dtr = s_cfg.resolved_dt_rank(cfg.d_model)
    n = s_cfg.state_dim

    xi, z = linear(x, params["w_in"]).chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                conv_state)
    xc = F.silu(xc.float()).to(x.dtype)

    dt_low, b_ssm, c_ssm = torch.split(linear(xc, params["w_x"]),
                                       [dtr, n, n], dim=-1)
    dt = linear(dt_low, params["w_dt"]).float()
    dt = F.softplus(dt + params["dt_bias"])
    a = -torch.exp(params["a_log"])

    h0 = state["ssm"] if state is not None else None
    y, h_end = selective_scan(xc, dt, a, b_ssm, c_ssm, params["d_skip"],
                              h0=h0, scan_dtype=s_cfg.scan_dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = linear(y, params["w_out"])
    if return_state:
        return out, {"conv": new_conv.contiguous(), "ssm": h_end}
    return out


def init_ssm_state_spec(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "conv": ((batch, s.conv_kernel - 1, di), ("batch", None, "act_ssm_inner")),
        "ssm": ((batch, di, s.state_dim), ("batch", "act_ssm_inner", "ssm_state")),
    }


def mamba_decode(params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    """Single-token recurrence. x: (B,1,d); state: this layer's
    {"conv", "ssm"} tensors, written in place (they may be views into a
    stacked cache).  Returns (out, state)."""
    s_cfg = cfg.ssm
    dtr = s_cfg.resolved_dt_rank(cfg.d_model)
    n = s_cfg.state_dim

    xi, z = linear(x, params["w_in"]).chunk(2, dim=-1)   # (B,1,di)
    # conv over (history ++ new)
    hist = state["conv"].to(x.dtype)                     # (B,k-1,di)
    window = torch.cat([hist, xi], dim=1)                # (B,k,di)
    xc = ((window * params["conv_w"][None]).sum(dim=1, keepdim=True)
          + params["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)

    dt_low, b_ssm, c_ssm = torch.split(linear(xc, params["w_x"]),
                                       [dtr, n, n], dim=-1)
    dt = linear(dt_low, params["w_dt"]).float()
    dt = F.softplus(dt + params["dt_bias"])[:, 0]        # (B,di)
    a = -torch.exp(params["a_log"])

    h = state["ssm"]                                     # (B,di,n)
    da = torch.exp(dt[..., None] * a[None])
    x0 = xc[:, 0].float()
    bx = (dt * x0)[..., None] * b_ssm[:, 0, None, :].float()
    h_new = da * h + bx
    y = torch.einsum("bdn,bn->bd", h_new, c_ssm[:, 0].float())
    y = (y + x0 * params["d_skip"]).to(x.dtype)[:, None]
    y = y * F.silu(z.float()).to(x.dtype)
    out = linear(y, params["w_out"])
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h_new)
    return out, state
