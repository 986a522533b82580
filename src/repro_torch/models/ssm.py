"""Mamba-1 selective SSM block: full-sequence scan (train / prefill) and
single-token recurrence (decode).

The port of ``repro/models/ssm.py``.  The prefill scan goes through
``selective_scan_op``, which launches the hand-written CUDA kernel
(``kernels/selective_scan``) on a CUDA tensor and runs its plain version on
a CPU tensor; the JAX package runs a chunked associative scan in jnp here
and holds its Pallas kernel to the same recurrence.  Training
(``train=True``) runs that chunked scan, `chunked_scan`: the kernel is
forward-only.  Decode is one step of the recurrence in plain torch, as in
the JAX package, and writes the conv history and the state into the cache
in place.

Over a ``model`` axis (where the reference constrains ``xz`` to
``act_ssm_inner``) a rank runs its shard of the inner channels: ``w_in``
is column-parallel, the depthwise conv, ``A``, ``D``, ``dt`` and the scan
run on the local channels, ``w_x`` is row-parallel, so its (dt, B, C)
are summed over the ranks before ``w_dt``, and ``w_out``'s partial sums
are added over the ranks.  ``w_in`` holds the x and z halves side by
side, so its plain ``model`` shard is not the rank's channels: a rank
holds `paired_columns` of it (``models.transformer.local_leaf``), cut
where `paired_split` says; `unpaired_columns` puts it back.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan.ops import selective_scan_op
from repro_torch.models.common import ParamSpec, linear
from repro_torch.parallel.sharding import (MODEL_AXIS, axis_sizes,
                                           copy_to_model, current_context,
                                           enter_model, leave_model,
                                           model_group, model_placements,
                                           reduce_from_model)


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


def paired_columns(w: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """The x and z columns of ``w_in`` (its last dim, 2 * di) of channel
    block `index` of `parts`, side by side: the rank's ``w_in``."""
    di = w.shape[-1] // 2
    n = di // parts
    lo = index * n
    return torch.cat([w[..., lo:lo + n], w[..., di + lo:di + lo + n]], -1)


def unpaired_columns(w: torch.Tensor, width: int, parts: int,
                     index: int) -> torch.Tensor:
    """The inverse of `paired_columns`: the rank's ``w_in`` (or its
    gradient) `w` in its x and z columns of a zero leaf whose last dim is
    `width` (2 * di)."""
    out = w.new_zeros(w.shape[:-1] + (width,))
    di, n = width // 2, w.shape[-1] // 2
    lo = index * n
    out[..., lo:lo + n] = w[..., :n]
    out[..., di + lo:di + lo + n] = w[..., n:]
    return out


def paired_split(spec: ParamSpec, mesh, rules) -> bool:
    """Whether ``w_in`` (`spec`) is cut on `mesh`: the rules shard its
    inner channels and their count divides the ``model`` axis."""
    from torch.distributed.tensor import Shard
    place = model_placements(spec.logical, spec.shape, mesh, rules)
    m = axis_sizes(mesh).get(MODEL_AXIS, 1)
    return (any(isinstance(p, Shard) for p in place)
            and (spec.shape[-1] // 2) % m == 0)


def split_inner(params, cfg: ModelConfig) -> bool:
    """Whether the block's params are the rank's shard of the inner
    channels (fewer than the config's)."""
    di = params["w_in"].shape[-1] // 2
    if di == cfg.ssm.expand * cfg.d_model:
        return False
    mg = model_group()
    if mg is None or di * mg.size != cfg.ssm.expand * cfg.d_model:
        raise ValueError(f"{di} SSM channels outside a sharding context "
                         f"over the model axis")
    return True


def local_inner(cfg: ModelConfig) -> int:
    """The inner channels a rank holds under the current sharding context:
    a shard where the context's rules cut ``w_in`` (`paired_split`)."""
    di = cfg.ssm.expand * cfg.d_model
    ctx, mg = current_context(), model_group()
    if mg is None or not paired_split(ssm_specs(cfg)["w_in"], ctx.mesh,
                                      ctx.rules):
        return di
    return di // mg.size


def _x_proj(xc: torch.Tensor, w_x: torch.Tensor, split: bool):
    """The row-parallel ``w_x``: (dt_low, B, C) whole on every rank, their
    gradient summed over the ranks (each rank's channels use them)."""
    x_dbl = linear(xc, w_x)
    return copy_to_model(reduce_from_model(x_dbl)) if split else x_dbl


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


# time steps per chunk of the training scan (the JAX package's)
SCAN_CHUNK = 256


def _chunk_scan(da: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """h_t = da_t * h_{t-1} + bx_t within one chunk, h_{-1} = h0, as a
    doubling (Hillis-Steele) scan with the JAX package's ``combine``:
    log2(c) steps, each combining every step with the one `off` before it.

    da, bx: (B, c, di, n); h0: (B, di, n).  Returns (states, h_end)."""
    # fold the incoming state into the first step
    a, b = da, torch.cat([bx[:, :1] + da[:, :1] * h0[:, None], bx[:, 1:]], 1)
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b, b[:, -1]


def _scan_chunk(h, xc, dtc, bc, cc, a, scan_dtype):
    """One chunk of `chunked_scan` -> (h_end fp32, y in xc's dtype)."""
    da = torch.exp(dtc[..., None] * a[None, None])           # (B,c,di,n)
    bx = (dtc * xc)[..., None] * bc[:, :, None, :]            # (B,c,di,n)
    states, h_end = _chunk_scan(da.to(scan_dtype), bx.to(scan_dtype),
                                h.to(scan_dtype))
    y = torch.einsum("bcdn,bcn->bcd", states, cc.to(scan_dtype))
    return h_end.float(), y.to(xc.dtype)


def chunked_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                 d_skip: torch.Tensor, h0: Optional[torch.Tensor] = None,
                 chunk: int = SCAN_CHUNK, scan_dtype="float32"):
    """The training scan: x, dt (B,S,di); a (di,n); b_ssm, c_ssm (B,S,n) ->
    (y (B,S,di) in x's dtype, h_end (B,di,n) fp32), as the JAX package's
    ``selective_scan``.  `chunk` steps at a time, each chunk checkpointed
    (recomputed in the backward pass) with the state carried between
    chunks in fp32; inside a chunk the operands are cast to `scan_dtype`.
    D*x is added in x's dtype, as the reference adds it (the kernel sums
    it in fp32)."""
    bsz, s, di = x.shape
    sd = getattr(torch, scan_dtype)
    h = (torch.zeros((bsz, di, a.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    dt, b_ssm, c_ssm = dt.float(), b_ssm.float(), c_ssm.float()
    ys = []
    for t in range(0, s, chunk):
        sl = slice(t, t + chunk)
        h, y = checkpoint(_scan_chunk, h, x[:, sl], dt[:, sl], b_ssm[:, sl],
                          c_ssm[:, sl], a, sd, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, 1) + x * d_skip.to(x.dtype), h


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  return_state: bool = False, train: bool = False,
                  seq=None):
    """Full-sequence mamba block. x: (B,S,d). Optionally carries/returns
    state {"conv": (B,k-1,di), "ssm": (B,di,n)} for the prefill->decode
    handoff.  `train` scans with `chunked_scan`, else with the kernel.
    Under sequence parallelism (`seq`) `x` is the gathered sequence (the
    scan needs all of it) and the output the rank's slice; the state is
    the whole sequence's."""
    s_cfg = cfg.ssm
    dtr = s_cfg.resolved_dt_rank(cfg.d_model)
    n = s_cfg.state_dim
    split = split_inner(params, cfg)
    x = enter_model(x, split, seq)

    xi, z = linear(x, params["w_in"]).chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                conv_state)
    xc = F.silu(xc.float()).to(x.dtype)

    dt_low, b_ssm, c_ssm = torch.split(_x_proj(xc, params["w_x"], split),
                                       [dtr, n, n], dim=-1)
    dt = linear(dt_low, params["w_dt"]).float()
    dt = F.softplus(dt + params["dt_bias"])
    a = -torch.exp(params["a_log"])

    h0 = state["ssm"] if state is not None else None
    scan = chunked_scan if train else selective_scan
    y, h_end = scan(xc, dt, a, b_ssm, c_ssm, params["d_skip"], h0=h0,
                    scan_dtype=s_cfg.scan_dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = leave_model(linear(y, params["w_out"]), split, seq)
    if return_state:
        return out, {"conv": new_conv.contiguous(), "ssm": h_end}
    return out


def init_ssm_state_spec(cfg: ModelConfig, batch: int, local: bool = False):
    """The state's (shape, logical axes); with `local`, the rank's inner
    channels (`local_inner`)."""
    s = cfg.ssm
    di = local_inner(cfg) if local else s.expand * cfg.d_model
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
    split = split_inner(params, cfg)

    xi, z = linear(x, params["w_in"]).chunk(2, dim=-1)   # (B,1,di)
    # conv over (history ++ new)
    hist = state["conv"].to(x.dtype)                     # (B,k-1,di)
    window = torch.cat([hist, xi], dim=1)                # (B,k,di)
    xc = ((window * params["conv_w"][None]).sum(dim=1, keepdim=True)
          + params["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)

    dt_low, b_ssm, c_ssm = torch.split(_x_proj(xc, params["w_x"], split),
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
    if split:
        out = reduce_from_model(out)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h_new)
    return out, state
