"""build_model(cfg) -> Model: a functional bundle exposing

  specs                          parameter ParamSpec tree
  init(generator, device=None)   materialize params (on the card by default)
  prefill(p, batch, max_len)     -> (last_logits, cache)
  decode(p, cache, tokens, positions) -> (logits, cache), cache in place
  cache_spec(batch, max_len)     -> tree of (shape, logical_axes)

The port of ``repro/models/model.py`` for the dense GQA, SSM and hybrid
families.  Prefill and decode run under ``torch.inference_mode()``.  Cache
layouts follow the JAX package: the dense and SSM families stack their
layers' caches, ``{"main": {"kv": {"k","v","pos"}}}`` and ``{"main":
{"ssm": {"conv","ssm"}}}`` with a leading layer axis; the hybrid (parallel
SSM) family keeps a tuple of per-layer ``{"kv", "ssm"}`` dicts, each
layer's KV cache as long as its own window (a rolling ``window``-slot
cache on sliding-window layers, ``max_len`` slots on global ones).  Decode
walks the layers in a Python loop and writes each layer's cache in place
(``_scan_decode`` in the JAX package carries the cache through a scan for
the same reason), so `decode` returns the very cache objects it was
given.  Training (``train_forward``) comes with the training slice; the
other families raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
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
    out: Dict[str, Any] = {}
    if cfg.attention == "gqa":
        spec = attn.init_gqa_cache_spec(cfg, batch, max_len, window)
        out["kv"] = {k: ((num_layers,) + sh, ("layers",) + lg)
                     for k, (sh, lg) in spec.items()}
    if cfg.ssm is not None:
        spec = ssm_mod.init_ssm_state_spec(cfg, batch)
        out["ssm"] = {k: ((num_layers,) + sh, ("layers",) + lg)
                      for k, (sh, lg) in spec.items()}
    return out


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.is_moe:
        return "MoE"
    if cfg.attention not in ("gqa", "none"):
        return f"attention={cfg.attention!r}"
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
            f"(ROADMAP.md, 'Model families'); the port serves dense GQA, "
            f"SSM and hybrid models")
    specs = tfm.model_specs(cfg)

    def init(generator: torch.Generator, device: DeviceLike = None):
        return init_params(specs, generator, resolve_device(device))

    @torch.inference_mode()
    def prefill(params, batch, max_len: int):
        x, pos = _embed_inputs(params, batch, cfg)
        h, collected = tfm.decoder_forward(params, x, cfg, positions=pos,
                                           need_cache=True)
        kvs, states = collected["kv"], collected["ssm"]
        if cfg.parallel_ssm:  # hybrid: per-layer caches, per-layer windows
            cache: Any = []
            for i in range(cfg.num_layers):
                k, v = kvs[i]
                one = _kv_cache_from_prefill(
                    (k[None], v[None]), pos, max_len,
                    tfm._layer_window(cfg, i))
                cache.append({"kv": {n: t[0] for n, t in one.items()},
                              "ssm": states[i]})
            cache = tuple(cache)
        else:
            entry: Dict[str, Any] = {}
            if kvs is not None:
                entry["kv"] = _kv_cache_from_prefill(
                    (torch.stack([k for k, _ in kvs]),
                     torch.stack([v for _, v in kvs])),
                    pos, max_len, cfg.sliding_window)
            if states is not None:
                entry["ssm"] = {n: torch.stack([st[n] for st in states])
                                for n in ("conv", "ssm")}
            cache = {"main": entry}
        logits = tfm.lm_logits(params, h[:, -1:], cfg)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode(params, cache, tokens, positions):
        """tokens: (B,1) int; positions: (B,) int32 absolute position."""
        x = tfm.embed_tokens(params, tokens, cfg)
        positions = positions.to(torch.int32)
        for i in range(cfg.num_layers):
            if cfg.parallel_ssm:
                lc, window = cache[i], tfm._layer_window(cfg, i)
            else:
                lc = tfm.layer_slice(cache["main"], i)
                window = cfg.sliding_window
            x = tfm.layer_decode(tfm.layer_slice(params["layers"], i), x,
                                 lc, cfg, positions=positions, window=window)
        logits = tfm.lm_logits(params, x, cfg)
        return logits[:, 0], cache

    def cache_spec(batch: int, max_len: int):
        if cfg.parallel_ssm:
            return tuple(
                {"kv": attn.init_gqa_cache_spec(cfg, batch, max_len,
                                                tfm._layer_window(cfg, i)),
                 "ssm": ssm_mod.init_ssm_state_spec(cfg, batch)}
                for i in range(cfg.num_layers))
        return {"main": _stack_cache_spec(cfg, cfg.num_layers, batch,
                                          max_len, cfg.sliding_window)}

    return Model(cfg=cfg, specs=specs, init=init, prefill=prefill,
                 decode=decode, cache_spec=cache_spec)
