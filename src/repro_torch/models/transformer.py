"""Decoder assembly for the dense GQA, MoE, SSM, hybrid and vision
families (llama, yi, starcoder2, mixtral, falcon-mamba, hymba, internvl2,
...).

The port of the decoder half of ``repro/models/transformer.py``.  One
layer definition parameterized by the attention kind (gqa | none), the
FFN kind (dense | moe) and the parallel-SSM flag; the stacked ``(L, ...)``
layer leaves run in a Python loop over layers, in place of ``lax.scan``,
each layer with its own window (hymba's global layers attend in full).  A
config with ``moe.first_k_dense`` keeps its leading dense layers in a
stack of their own (``layers_dense``) before the MoE stack (``layers``);
a vision config adds the projector (``proj1``, ``proj2``) that
``models/model.py`` applies to the patch embeddings.  Nothing here is
differentiated, so there is no remat; the MoE aux loss is summed and
returned, and the serving stack drops it.  MLA, MTP and enc-dec stacks
come with their model families (``models/model.py`` raises for them).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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


def layer_specs(cfg: ModelConfig, ffn: str = "dense",
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
    if ffn == "dense" and (d_ff or cfg.d_ff):
        specs["norm2"] = ParamSpec((d,), ("embed",), "ones")
        specs["ffn"] = dense_ffn_specs(cfg, d_ff or cfg.d_ff)
    elif ffn == "moe":
        specs["norm2"] = ParamSpec((d,), ("embed",), "ones")
        specs["moe"] = moe_mod.moe_specs(cfg)
    return specs


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), "normal", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), "scaled")
    if cfg.vision_tokens:  # vlm projector (stubbed ViT -> LM)
        dv = cfg.vision_embed_dim
        specs["proj1"] = ParamSpec((dv, d), (None, "embed"), "scaled")
        specs["proj2"] = ParamSpec((d, d), ("embed", None), "scaled")
    if cfg.is_moe and cfg.moe.first_k_dense:
        dense_ff = cfg.moe.first_dense_d_ff or cfg.d_ff
        specs["layers_dense"] = stack_specs(
            layer_specs(cfg, ffn="dense", d_ff=dense_ff),
            cfg.moe.first_k_dense)
        specs["layers"] = stack_specs(
            layer_specs(cfg, ffn="moe"),
            cfg.num_layers - cfg.moe.first_k_dense)
    else:
        specs["layers"] = stack_specs(
            layer_specs(cfg, ffn="moe" if cfg.is_moe else "dense"),
            cfg.num_layers)
    return specs


def stacks(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    """The decoder's layer stacks in order: (cache name, param name, layer
    count) -- ``("dense", "layers_dense", k)`` first where the config has
    ``moe.first_k_dense``, then ``("main", "layers", ...)``."""
    k = cfg.moe.first_k_dense if cfg.is_moe else 0
    out = [("dense", "layers_dense", k)] if k else []
    return out + [("main", "layers", cfg.num_layers - k)]


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


def _ffn(lp: Params, x: torch.Tensor, cfg: ModelConfig):
    """The layer's FFN half with its residual -> (x, MoE aux loss or 0)."""
    if "ffn" in lp:
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + dense_ffn(h2, lp["ffn"], cfg.ffn_act).to(x.dtype), 0.0
    if "moe" in lp:
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        y, aux = moe_mod.moe_ffn(lp["moe"], h2, cfg)
        return x + y.to(x.dtype), aux
    return x, 0.0


def layer_forward(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions, window: int, need_cache: bool = False):
    """Full-sequence layer.  Returns (x, MoE aux loss or 0, (k, v) or
    None, ssm state or None); the caches only with `need_cache`."""
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
    x, aux = _ffn(lp, x, cfg)
    return x, aux, cache_kv, new_ssm_state


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
    return _ffn(lp, x, cfg)[0]


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def decoder_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, need_cache: bool = False):
    """Runs the decoder stacks on embedded inputs -> (hidden, aux, caches).
    aux sums the MoE layers' aux losses (0 without MoE).  With
    `need_cache`, caches maps each stack's cache name (``stacks``) to
    ``{"kv": [(k, v) per layer] or None, "ssm": [{"conv", "ssm"} per
    layer] or None}``, k/v (B,S,nkv,hd); else None."""
    aux = 0.0
    caches: Dict[str, Any] = {}
    for name, key, n in stacks(cfg):
        kvs: List[Any] = []
        states: List[Any] = []
        for i in range(n):
            # the dense stack attends with the config's window throughout
            window = (_layer_window(cfg, i) if name == "main"
                      else cfg.sliding_window)
            x, a, kv, st = layer_forward(layer_slice(params[key], i), x,
                                         cfg, positions=positions,
                                         window=window,
                                         need_cache=need_cache)
            aux = aux + a
            kvs.append(kv)
            states.append(st)
        caches[name] = {"kv": kvs if cfg.attention == "gqa" else None,
                        "ssm": states if cfg.ssm is not None else None}
    return x, aux, (caches if need_cache else None)


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def lm_logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return linear(x, head)
