"""Decoder assembly for the dense GQA family (llama, yi, starcoder2, ...).

The port of the dense-GQA half of ``repro/models/transformer.py``.  The
stacked ``(L, ...)`` layer leaves run in a Python loop over layers, in
place of ``lax.scan``; nothing here is differentiated, so there is no
remat.  MoE, MLA, SSM, hybrid, enc-dec and vision stacks come with the
other model families (``models/model.py`` raises for them).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, dense_ffn, linear,
                                       rms_norm, stack_specs, tree_map)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def dense_ffn_specs(cfg: ModelConfig, d_ff: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    specs = {
        "w_up": ParamSpec((d, d_ff), ("embed", "mlp"), "scaled"),
        "w_down": ParamSpec((d_ff, d), ("mlp", "embed"), "scaled"),
    }
    if cfg.ffn_act == "swiglu":
        specs["w_gate"] = ParamSpec((d, d_ff), ("embed", "mlp"), "scaled")
    return specs


def layer_specs(cfg: ModelConfig,
                d_ff: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    specs: Dict[str, Any] = {"norm1": ParamSpec((d,), ("embed",), "ones"),
                             "attn": attn.gqa_specs(cfg)}
    if d_ff or cfg.d_ff:
        specs["norm2"] = ParamSpec((d,), ("embed",), "ones")
        specs["ffn"] = dense_ffn_specs(cfg, d_ff or cfg.d_ff)
    return specs


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), "normal", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
        "layers": stack_specs(layer_specs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), "scaled")
    return specs


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _layer_window(cfg: ModelConfig, layer_idx: Optional[int]) -> int:
    if layer_idx is not None and layer_idx in cfg.global_attn_layers:
        return 0
    return cfg.sliding_window


def layer_slice(stack: Params, i: int) -> Params:
    """Layer `i`'s views into stacked ``(L, ...)`` leaves (params or
    cache)."""
    return tree_map(lambda t: t[i], stack)


def layer_forward(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions, window: int, need_cache: bool = False):
    """Full-sequence layer. Returns (x, (k, v) or None)."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    a = attn.gqa_forward(lp["attn"], h, cfg=cfg, positions=positions,
                         window=window)
    cache_kv = (attn.gqa_prefill_kv(lp["attn"], h, cfg=cfg,
                                    positions=positions)
                if need_cache else None)
    x = x + a.to(x.dtype)
    if "ffn" in lp:
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + dense_ffn(h2, lp["ffn"], cfg.ffn_act).to(x.dtype)
    return x, cache_kv


def layer_decode(lp: Params, x: torch.Tensor, cache, cfg: ModelConfig, *,
                 positions, window: int) -> torch.Tensor:
    """One-token layer step; ``cache["kv"]`` is written in place."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    a, _ = attn.gqa_decode(lp["attn"], h, cache["kv"], cfg=cfg,
                           positions=positions, window=window)
    x = x + a.to(x.dtype)
    if "ffn" in lp:
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + dense_ffn(h2, lp["ffn"], cfg.ffn_act).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def decoder_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, need_cache: bool = False):
    """Runs the decoder stack on embedded inputs -> (hidden, caches), with
    caches ``{"main": (k, v)}`` stacked ``(L,B,S,nkv,hd)`` when asked."""
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for i in range(cfg.num_layers):
        x, kv = layer_forward(layer_slice(params["layers"], i), x, cfg,
                              positions=positions,
                              window=_layer_window(cfg, i),
                              need_cache=need_cache)
        if need_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    caches = ({"main": (torch.stack(ks), torch.stack(vs))} if need_cache
              else None)
    return x, caches


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def lm_logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return linear(x, head)
