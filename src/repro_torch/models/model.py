"""build_model(cfg) -> Model: a functional bundle exposing

  specs                          parameter ParamSpec tree
  init(generator, device=None)   materialize params (on the card by default)
  train_forward(p, batch)        -> {"logits", "aux", ["mtp_logits"]}
  prefill(p, batch, max_len)     -> (last_logits, cache)
  decode(p, cache, tokens, positions) -> (logits, cache), cache in place
  decode_graphs                  the decode step's CUDA graphs and counts
  cache_spec(batch, max_len)     -> tree of (shape, logical_axes)
  token_seq_len(seq_len)         text tokens in a sequence of seq_len

The port of ``repro/models/model.py``, for every family of
``repro_torch.configs``.  Prefill and decode run under
``torch.inference_mode()``; ``train_forward`` runs the training routes
(``train=True``: no kernel, layers checkpointed by ``cfg.remat``) under
whatever grad mode its caller set, and keeps no tensor across calls.
Cache layouts follow the JAX package:
- the dense, MoE, vision and SSM families stack their layers' caches,
  ``{"main": {"kv": {"k","v","pos"}}}`` and ``{"main": {"ssm":
  {"conv","ssm"}}}`` with a leading layer axis, and a config with
  ``moe.first_k_dense`` puts its leading dense layers' cache under
  ``"dense"`` beside ``"main"``;
- MLA (DeepSeek-V3) caches the compressed latent the same way,
  ``{"kv": {"c_kv","k_rope","pos"}}`` of ``max_len`` slots (no window);
- enc-dec (Whisper) keeps ``{"main": {"kv": {"k","v","pos"}, "cross":
  (k, v)}}``, the cross K/V of the encoder's output (L,B,T,nkv,hd),
  computed once in prefill from ``batch["frames"]`` (B,T,d) and read by
  every decode step;
- the hybrid (parallel SSM) family keeps a tuple of per-layer ``{"kv",
  "ssm"}`` dicts, each layer's KV cache as long as its own window (a
  rolling ``window``-slot cache on sliding-window layers, ``max_len``
  slots on global ones).
A vision config prepends the projected patch embeddings
(``batch["patch_embeds"]``, (B, Nv, Dv)) to the text, so text position t
sits at sequence position Nv + t.  Decode walks the layers in a Python
loop and writes each layer's cache in place (``_scan_decode`` in the JAX
package carries the cache through a scan for the same reason), so
`decode` returns the very cache objects it was given.  On a CUDA device
with no sharding_context, `decode` replays one CUDA graph of the whole step
per cache (``models/decode_graphs.py``; ``decode_graphs.step`` is the eager
step).  Only ``train_forward`` runs DeepSeek-V3's multi-token prediction.

Under a sharding_context over a ``model`` axis (tensor parallelism,
``models/transformer.py``) every entry point takes the rank's local params
(``transformer.tp_layouts``) and returns the rank's vocabulary slice of
the logits; the caches prefill builds hold the rank's kv heads and SSM
channels, and ``cache_spec(batch, max_len, local=True)`` gives their
shapes.  Where the rules put ``seq`` on the ``model`` axis the residual
runs sequence-parallel (``models/transformer.py``): the logits and the
caches are still the whole sequence's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params, linear
from repro_torch.models.decode_graphs import DecodeGraphs
from repro_torch.parallel.sharding import seq_group


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    specs: Dict[str, Any]
    init: Callable
    train_forward: Callable
    prefill: Callable
    decode: Callable
    cache_spec: Callable
    decode_graphs: Optional[DecodeGraphs] = None

    def token_seq_len(self, seq_len: int) -> int:
        """Text-token count for a given total sequence length."""
        return seq_len - self.cfg.vision_tokens


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token (+ vision) embedding -> (x, positions, seq): positions of the
    whole sequence, `seq` its ``sharding.seq_group`` and, where that is
    not None, x the rank's slice of the sequence."""
    tokens = batch["tokens"]
    b, s = tokens.shape[0], tokens.shape[1] + cfg.vision_tokens
    seq = seq_group(s)
    v = None
    if cfg.vision_tokens:
        dtype = getattr(torch, cfg.dtype)
        pe = batch["patch_embeds"].to(dtype)               # (B, Nv, Dv)
        v = linear(pe, params["proj1"])
        # jax.nn.gelu's default is the tanh approximation
        v = F.gelu(v.float(), approximate="tanh").to(dtype)
        v = linear(v, params["proj2"])
    x = tfm.embed_tokens(params, tokens, cfg, seq, prefix=v)
    return x, _positions(b, s, x.device), seq


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


def _mla_cache_from_prefill(kv, positions, max_len: int):
    """(c_kv, k_rope) stacked (L,B,S,...) -> decode cache {"c_kv",
    "k_rope","pos"} of max_len slots, each leaf its own contiguous tensor
    (decode writes them in place)."""
    c_kv, k_rope = kv
    l, b, s = c_kv.shape[:3]
    cc = c_kv.new_zeros((l, b, max_len, c_kv.shape[3]))
    rc = k_rope.new_zeros((l, b, max_len, k_rope.shape[3]))
    cc[:, :, :s] = c_kv
    rc[:, :, :s] = k_rope
    pos = torch.full((b, max_len), -1, dtype=torch.int32, device=c_kv.device)
    pos[:, :s] = positions
    return {"c_kv": cc, "k_rope": rc,
            "pos": pos[None].expand((l,) + tuple(pos.shape)).contiguous()}


def _stack_cache_spec(cfg: ModelConfig, num_layers: int, batch: int,
                      max_len: int, window: int, local: bool = False):
    """(shape, logical) specs for the stacked decode cache."""
    out: Dict[str, Any] = {}
    spec = None
    if cfg.attention == "gqa":
        spec = attn.init_gqa_cache_spec(cfg, batch, max_len, window, local)
    elif cfg.attention == "mla":
        spec = attn.init_mla_cache_spec(cfg, batch, max_len)
    if spec is not None:
        out["kv"] = {k: ((num_layers,) + sh, ("layers",) + lg)
                     for k, (sh, lg) in spec.items()}
    if cfg.ssm is not None:
        spec = ssm_mod.init_ssm_state_spec(cfg, batch, local)
        out["ssm"] = {k: ((num_layers,) + sh, ("layers",) + lg)
                      for k, (sh, lg) in spec.items()}
    return out


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def build_model(cfg: ModelConfig) -> Model:
    specs = tfm.model_specs(cfg)

    def init(generator: torch.Generator, device: DeviceLike = None):
        return init_params(specs, generator, resolve_device(device))

    def train_forward(params, batch):
        dtype = getattr(torch, cfg.dtype)
        if cfg.encoder_layers:
            enc_out = tfm.encoder_forward(params, batch["frames"].to(dtype),
                                          cfg, train=True)
            x, pos, seq = _embed_inputs(params, batch, cfg)
            x, _ = tfm.encdec_decoder_forward(params, x, enc_out, cfg,
                                              positions=pos, train=True)
            return {"logits": tfm.lm_logits(params, x, cfg, seq),
                    "aux": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}
        x, pos, seq = _embed_inputs(params, batch, cfg)
        h, aux, _ = tfm.decoder_forward(params, x, cfg, positions=pos,
                                        train=True)
        out = {"aux": torch.as_tensor(aux, dtype=torch.float32,
                                      device=x.device)}
        out["logits"] = tfm.lm_logits(params, h, cfg, seq,
                                      skip=cfg.vision_tokens)
        if cfg.mtp_depth:              # no config has vision tokens too
            nxt = torch.roll(batch["tokens"], -1, dims=1)
            out["mtp_logits"] = tfm.mtp_forward(params, h, nxt, cfg,
                                                positions=pos)
        return out

    def encdec_prefill(params, batch, max_len: int):
        enc_out = tfm.encoder_forward(
            params, batch["frames"].to(getattr(torch, cfg.dtype)), cfg)
        x, pos, seq = _embed_inputs(params, batch, cfg)
        x, (kv, cross) = tfm.encdec_decoder_forward(
            params, x, enc_out, cfg, positions=pos, need_cache=True)
        cache = {"main": {"kv": _kv_cache_from_prefill(kv, pos, max_len, 0),
                          "cross": cross}}
        logits = tfm.lm_logits(params, tfm.last_hidden(x, seq), cfg)
        return logits[:, 0], cache

    @torch.inference_mode()
    def prefill(params, batch, max_len: int):
        if cfg.encoder_layers:
            return encdec_prefill(params, batch, max_len)
        x, pos, seq = _embed_inputs(params, batch, cfg)
        h, _, collected = tfm.decoder_forward(params, x, cfg, positions=pos,
                                              need_cache=True)
        if cfg.parallel_ssm:  # hybrid: per-layer caches, per-layer windows
            kvs, states = collected["main"]["kv"], collected["main"]["ssm"]
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
            cache = {}
            for name, got in collected.items():
                kvs, states = got["kv"], got["ssm"]
                entry: Dict[str, Any] = {}
                if kvs is not None:
                    stacked = tuple(torch.stack(t) for t in zip(*kvs))
                    entry["kv"] = (
                        _mla_cache_from_prefill(stacked, pos, max_len)
                        if cfg.attention == "mla" else _kv_cache_from_prefill(
                            stacked, pos, max_len, cfg.sliding_window))
                if states is not None:
                    entry["ssm"] = {n: torch.stack([st[n] for st in states])
                                    for n in ("conv", "ssm")}
                cache[name] = entry
        logits = tfm.lm_logits(params, tfm.last_hidden(h, seq), cfg)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode_step(params, cache, tokens, positions):
        """tokens: (B,1) int; positions: (B,) int32 absolute position."""
        x = tfm.embed_tokens(params, tokens, cfg)
        positions = positions.to(torch.int32)
        if cfg.parallel_ssm:
            for i in range(cfg.num_layers):
                x = tfm.layer_decode(
                    tfm.layer_slice(params["layers"], i), x, cache[i], cfg,
                    positions=positions, window=tfm._layer_window(cfg, i))
        else:
            for name, key, n in tfm.stacks(cfg):
                for i in range(n):
                    x = tfm.layer_decode(
                        tfm.layer_slice(params[key], i), x,
                        tfm.layer_slice(cache[name], i), cfg,
                        positions=positions, window=cfg.sliding_window,
                        d_ff=tfm.stack_d_ff(cfg, name))
        logits = tfm.lm_logits(params, x, cfg)
        return logits[:, 0], cache

    graphs = DecodeGraphs(decode_step)

    @torch.inference_mode()
    def decode(params, cache, tokens, positions):
        """`decode_step`, as a CUDA graph where one engages."""
        return graphs(params, cache, tokens, positions)

    def cache_spec(batch: int, max_len: int, local: bool = False):
        """The cache's tree of (shape, logical axes); with `local`, its kv
        heads and SSM channels are the rank's under the current
        sharding_context (``attention.local_heads``,
        ``ssm.local_inner``); MLA's latent cache is whole on every rank
        (its heads split, the latent does not)."""
        if cfg.parallel_ssm:
            return tuple(
                {"kv": attn.init_gqa_cache_spec(cfg, batch, max_len,
                                                tfm._layer_window(cfg, i),
                                                local),
                 "ssm": ssm_mod.init_ssm_state_spec(cfg, batch, local)}
                for i in range(cfg.num_layers))
        if cfg.encoder_layers:
            spec = _stack_cache_spec(cfg, cfg.num_layers, batch, max_len, 0,
                                     local)
            nkv = (attn.local_heads(cfg)[1] if local
                   else cfg.num_kv_heads)
            shape = (cfg.num_layers, batch, cfg.encoder_seq_len,
                     nkv, cfg.resolved_head_dim)
            logical = ("layers", "batch", None, "act_kv_heads",
                       "act_head_dim")
            spec["cross"] = ((shape, logical), (shape, logical))
            return {"main": spec}
        return {name: _stack_cache_spec(cfg, n, batch, max_len,
                                        cfg.sliding_window, local)
                for name, _, n in tfm.stacks(cfg)}

    return Model(cfg=cfg, specs=specs, init=init,
                 train_forward=train_forward, prefill=prefill,
                 decode=decode, cache_spec=cache_spec,
                 decode_graphs=graphs)
