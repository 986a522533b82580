"""Decoder assembly for the dense GQA, SSM and hybrid families (llama, yi,
starcoder2, falcon-mamba, hymba, ...).

The port of the dense, SSM and parallel-SSM half of
``repro/models/transformer.py``.  One layer definition parameterized by
the attention kind (gqa | none) and the parallel-SSM flag; the stacked
``(L, ...)`` layer leaves run in a Python loop over layers, in place of
``lax.scan``, each layer with its own window (hymba's global layers attend
in full).  Nothing here is differentiated, so there is no remat.  MoE,
MLA, enc-dec and vision stacks come with the other model families
(``models/model.py`` raises for them).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
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
    specs: Dict[str, Any] = {"norm1": ParamSpec((d,), ("embed",), "ones")}
    if cfg.attention == "gqa":
        specs["attn"] = attn.gqa_specs(cfg)
    if cfg.ssm is not None:
        specs["ssm"] = ssm_mod.ssm_specs(cfg)
        if cfg.parallel_ssm:
            specs["ssm_norm"] = ParamSpec((d,), ("embed",), "ones")
            specs["attn_norm"] = ParamSpec((d,), ("embed",), "ones")
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


def _ffn(lp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "ffn" not in lp:
        return x
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + dense_ffn(h2, lp["ffn"], cfg.ffn_act).to(x.dtype)


def layer_forward(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions, window: int, need_cache: bool = False):
    """Full-sequence layer.  Returns (x, (k, v) or None, ssm state or
    None); the caches only with `need_cache`."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    cache_kv = new_ssm_state = None
    branch = 0.0
    if cfg.attention == "gqa":
        a = attn.gqa_forward(lp["attn"], h, cfg=cfg, positions=positions,
                             window=window)
        if cfg.parallel_ssm:
            a = rms_norm(a, lp["attn_norm"], cfg.norm_eps)
        branch = branch + a
        if need_cache:
            cache_kv = attn.gqa_prefill_kv(lp["attn"], h, cfg=cfg,
                                           positions=positions)
    if cfg.ssm is not None:
        if need_cache:
            s_out, new_ssm_state = ssm_mod.mamba_forward(
                lp["ssm"], h, cfg, return_state=True)
        else:
            s_out = ssm_mod.mamba_forward(lp["ssm"], h, cfg)
        if cfg.parallel_ssm:
            s_out = rms_norm(s_out, lp["ssm_norm"], cfg.norm_eps)
            branch = 0.5 * (branch + s_out)
        else:
            branch = branch + s_out
    x = x + branch.to(x.dtype)
    return _ffn(lp, x, cfg), cache_kv, new_ssm_state


def layer_decode(lp: Params, x: torch.Tensor, cache, cfg: ModelConfig, *,
                 positions, window: int) -> torch.Tensor:
    """One-token layer step; ``cache["kv"]`` and ``cache["ssm"]`` (those
    the layer has) are written in place."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    branch = 0.0
    if cfg.attention == "gqa":
        a, _ = attn.gqa_decode(lp["attn"], h, cache["kv"], cfg=cfg,
                               positions=positions, window=window)
        if cfg.parallel_ssm:
            a = rms_norm(a, lp["attn_norm"], cfg.norm_eps)
        branch = branch + a
    if cfg.ssm is not None:
        s_out, _ = ssm_mod.mamba_decode(lp["ssm"], h, cache["ssm"], cfg)
        if cfg.parallel_ssm:
            s_out = rms_norm(s_out, lp["ssm_norm"], cfg.norm_eps)
            branch = 0.5 * (branch + s_out)
        else:
            branch = branch + s_out
    x = x + branch.to(x.dtype)
    return _ffn(lp, x, cfg)


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def decoder_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, need_cache: bool = False):
    """Runs the decoder stack on embedded inputs -> (hidden, caches).  With
    `need_cache`, caches is ``{"kv": [(k, v) per layer] or None, "ssm":
    [{"conv", "ssm"} per layer] or None}``, k/v (B,S,nkv,hd); else None."""
    kvs: List[Any] = []
    states: List[Any] = []
    for i in range(cfg.num_layers):
        x, kv, st = layer_forward(layer_slice(params["layers"], i), x, cfg,
                                  positions=positions,
                                  window=_layer_window(cfg, i),
                                  need_cache=need_cache)
        kvs.append(kv)
        states.append(st)
    if not need_cache:
        return x, None
    return x, {"kv": kvs if cfg.attention == "gqa" else None,
               "ssm": states if cfg.ssm is not None else None}


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def lm_logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return linear(x, head)
