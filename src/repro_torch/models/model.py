"""build_model(cfg) -> Model: a functional bundle exposing

  specs                          parameter ParamSpec tree
  init(generator, device=None)   materialize params (on the card by default)
  prefill(p, batch, max_len)     -> (last_logits, cache)
  decode(p, cache, tokens, positions) -> (logits, cache), cache in place
  cache_spec(batch, max_len)     -> tree of (shape, logical_axes)

The port of ``repro/models/model.py`` for the dense GQA family.  Prefill
and decode run under ``torch.inference_mode()``.  Decode walks the stacked
layers in a Python loop and writes each layer's slice of the stacked
cache in place (``_scan_decode`` in the JAX package carries the cache
through a scan for the same reason), so `decode` returns the very cache
objects it was given.  Training (``train_forward``) comes with the
training slice; the other families raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    specs: Dict[str, Any]
    init: Callable
    prefill: Callable
    decode: Callable
    cache_spec: Callable


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding -> (x, positions)."""
    x = tfm.embed_tokens(params, batch["tokens"], cfg)
    b, s = x.shape[:2]
    return x, _positions(b, s, x.device)


def _kv_cache_from_prefill(kv, positions, max_len: int, window: int):
    """(k,v) stacked (L,B,S,nkv,hd) -> decode cache {"k","v","pos"}, each
    leaf its own contiguous tensor (decode writes them in place)."""
    k, v = kv
    l, b, s = k.shape[:3]
    sc = min(max_len, window) if window else max_len
    if not window or s <= sc:
        take = min(s, sc)
        kc = k.new_zeros((l, b, sc) + tuple(k.shape[3:]))
        vc = v.new_zeros((l, b, sc) + tuple(v.shape[3:]))
        kc[:, :, :take] = k[:, :, :take]
        vc[:, :, :take] = v[:, :, :take]
        pos = torch.full((b, sc), -1, dtype=torch.int32, device=k.device)
        pos[:, :take] = positions[:, :take]
    else:
        shift = (s - sc) % sc
        kc = torch.roll(k[:, :, -sc:], shift, dims=2)
        vc = torch.roll(v[:, :, -sc:], shift, dims=2)
        pos = torch.roll(positions[:, -sc:], shift, dims=1)
    pos = pos[None].expand((l,) + tuple(pos.shape)).to(torch.int32)
    return {"k": kc, "v": vc, "pos": pos.contiguous()}


def _stack_cache_spec(cfg: ModelConfig, num_layers: int, batch: int,
                      max_len: int, window: int):
    """(shape, logical) specs for the stacked decode cache."""
    spec = attn.init_gqa_cache_spec(cfg, batch, max_len, window)
    return {"kv": {k: ((num_layers,) + sh, ("layers",) + lg)
                   for k, (sh, lg) in spec.items()}}


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.is_moe:
        return "MoE"
    if cfg.attention != "gqa":
        return f"attention={cfg.attention!r}"
    if cfg.ssm is not None or cfg.parallel_ssm:
        return "SSM / hybrid"
    if cfg.encoder_layers:
        return "enc-dec"
    if cfg.vision_tokens:
        return "vision"
    if cfg.mtp_depth:
        return "multi-token prediction"
    return None


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def build_model(cfg: ModelConfig) -> Model:
    kind = _unsupported(cfg)
    if kind is not None:
        raise NotImplementedError(
            f"build_model({cfg.name}): the {kind} family is not ported yet "
            f"(ROADMAP.md, 'Model families'); the port serves dense GQA "
            f"models")
    specs = tfm.model_specs(cfg)

    def init(generator: torch.Generator, device: DeviceLike = None):
        return init_params(specs, generator, resolve_device(device))

    @torch.inference_mode()
    def prefill(params, batch, max_len: int):
        x, pos = _embed_inputs(params, batch, cfg)
        h, collected = tfm.decoder_forward(params, x, cfg, positions=pos,
                                           need_cache=True)
        cache = {"main": {"kv": _kv_cache_from_prefill(
            collected["main"], pos, max_len, cfg.sliding_window)}}
        logits = tfm.lm_logits(params, h[:, -1:], cfg)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode(params, cache, tokens, positions):
        """tokens: (B,1) int; positions: (B,) int32 absolute position."""
        x = tfm.embed_tokens(params, tokens, cfg)
        positions = positions.to(torch.int32)
        stack = cache["main"]["kv"]
        for i in range(cfg.num_layers):
            x = tfm.layer_decode(tfm.layer_slice(params["layers"], i), x,
                                 {"kv": tfm.layer_slice(stack, i)}, cfg,
                                 positions=positions,
                                 window=cfg.sliding_window)
        logits = tfm.lm_logits(params, x, cfg)
        return logits[:, 0], cache

    def cache_spec(batch: int, max_len: int):
        return {"main": _stack_cache_spec(cfg, cfg.num_layers, batch,
                                          max_len, cfg.sliding_window)}

    return Model(cfg=cfg, specs=specs, init=init, prefill=prefill,
                 decode=decode, cache_spec=cache_spec)
