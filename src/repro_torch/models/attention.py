"""Attention: GQA (full / sliding-window), prefill and decode.

The port of the GQA half of ``repro/models/attention.py``; MLA, encoder
and cross attention come with the other model families.  Prefill
attention goes through ``flash_attention_op``, which launches the
hand-written CUDA kernel on a CUDA tensor and runs its plain version on a
CPU tensor: fp32 scores, softmax and P.V, the output in the activation
dtype.  (The JAX package computes prefill in jnp, with bf16 probabilities
and a bf16 P.V product in bf16 models, and names its Pallas kernel as the
drop-in for it.)

Decode uses a unified cache layout: (B, Sc, nkv, hd) K/V plus a (B, Sc)
int32 ``pos`` tensor holding the absolute position stored in each slot
(-1 = empty).  A rolling (sliding-window) cache is the same structure with
Sc = window and slot = pos % Sc, so full and SWA caches share one code
path.  `gqa_decode` writes the new token's K/V/pos into the cache in
place; with ``cfg.decode_kernel`` the attention itself goes through
``decode_attention_op``, which launches the hand-written CUDA kernel on a
CUDA tensor and runs its plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.common import ParamSpec, apply_rope, linear

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": ParamSpec((d, nq, hd), ("embed", "heads", "head_dim"), "scaled"),
        "wk": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wv": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wo": ParamSpec((nq, hd, d), ("heads", "head_dim", "embed"), "scaled"),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bsd,dhe->bshe" as one matmul."""
    return linear(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """"bshe,hed->bsd" as one matmul."""
    return linear(o.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def gqa_forward(params, x, *, cfg: ModelConfig, positions,
                window: int) -> torch.Tensor:
    """Full-sequence (prefill) GQA with RoPE.  `positions` must be
    ``arange(S)`` in every row (``model._positions``): the attention
    kernel places query and kv row i at position i."""
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    out = flash_attention_op(q, k, v, causal=True, window=window)
    return _out_proj(out, params["wo"])


def gqa_prefill_kv(params, x, *, cfg: ModelConfig, positions):
    """K/V for cache population during prefill (post-RoPE)."""
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    return k, v


def init_gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                        window: int) -> Dict[str, Tuple[Tuple[int, ...], tuple]]:
    sc = min(max_len, window) if window else max_len
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    long = max_len >= 2 ** 18 or batch == 1
    seq_ax = "long_seq" if long else "kv_seq"
    return {
        "k": ((batch, sc, nkv, hd), ("batch", seq_ax, "act_kv_heads", "act_head_dim")),
        "v": ((batch, sc, nkv, hd), ("batch", seq_ax, "act_kv_heads", "act_head_dim")),
        "pos": ((batch, sc), ("batch", seq_ax)),
    }


def gqa_decode(params, x, cache, *, cfg: ModelConfig, positions,
               window: int):
    """One-token decode. x: (B,1,d); positions: (B,) int32 absolute
    position; cache: this layer's {"k","v","pos"} tensors, written in
    place (they may be views into a stacked cache).  Returns (y, cache)."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = nq // nkv
    b = x.shape[0]
    pos2 = positions[:, None]
    q = apply_rope(_project(x, params["wq"]), pos2, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), pos2, cfg.rope_theta)
    v = _project(x, params["wv"])
    k_cache, v_cache, pos_cache = cache["k"], cache["v"], cache["pos"]
    sc = k_cache.shape[1]
    idx = (torch.arange(b, device=x.device), (positions % sc).long())
    k_cache.index_put_(idx, k[:, 0].to(k_cache.dtype))
    v_cache.index_put_(idx, v[:, 0].to(v_cache.dtype))
    pos_cache.index_put_(idx, positions.to(pos_cache.dtype))

    if cfg.decode_kernel:  # the hand-written decode-attention kernel
        out = decode_attention_op(q[:, 0], k_cache, v_cache, pos_cache,
                                  positions, window=window)
        out = out[:, None]                               # (B,1,Nq,Hd)
    else:
        scale = hd ** -0.5
        qg = q.reshape(b, 1, nkv, g, hd)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                              k_cache.float()) * scale
        rel = positions[:, None] - pos_cache             # (B,Sc)
        valid = (pos_cache >= 0) & (rel >= 0)
        if window:
            valid &= rel < window
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v_cache.dtype),
                           v_cache)
        out = out.reshape(b, 1, nq, hd)
    return _out_proj(out, params["wo"]), cache
