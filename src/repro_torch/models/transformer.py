"""Decoder and enc-dec assembly for every family of ``repro_torch.configs``:
dense GQA, MoE, MLA, SSM, hybrid, vision and enc-dec (llama, yi,
starcoder2, mixtral, deepseek-v3, falcon-mamba, hymba, internvl2,
whisper, ...).

The port of ``repro/models/transformer.py``.  One layer definition
parameterized by the attention kind (gqa | mla | none), the FFN kind
(dense | moe) and the parallel-SSM flag; the stacked ``(L, ...)`` layer
leaves run in a Python loop over layers, in place of ``lax.scan``, each
layer with its own window (hymba's global layers attend in full).  A
config with ``moe.first_k_dense`` keeps its leading dense layers in a
stack of their own (``layers_dense``) before the MoE stack (``layers``);
a vision config adds the projector (``proj1``, ``proj2``) that
``models/model.py`` applies to the patch embeddings; an enc-dec config
has an encoder stack (``enc_layers``, ``enc_norm``) and decoder layers
with cross attention (``norm_x``, ``xattn``).  DeepSeek-V3's
multi-token-prediction module (``mtp``) runs in training only
(`mtp_forward`).  The MoE aux loss is summed and returned; the serving
stack drops it.

``train=True`` (from ``Model.train_forward``) selects the differentiable
attention and scan routes and checkpoints each layer by ``cfg.remat``, as
the JAX package's ``jax.checkpoint`` of its scanned layer body: "full"
recomputes the layer in the backward pass, "dots" saves its matmul
outputs and recomputes the rest (``checkpoint_dots``), "none" saves all.

Over a ``model`` axis of more than one rank (a sharding_context, as the
reference's ``with_logical_constraint`` sites) every function here runs
on the rank's local params, `tp_layouts`: the attention, FFN and SSM
blocks whose weights are split add their row-parallel outputs over the
ranks before the residual (``models/common.py``), the embedding is
vocab-parallel (each rank looks up its rows and the ranks' lookups are
summed) and so are the logits (`lm_logits` gives the rank's slice of
the vocabulary).  A block whole on every rank (heads that do not divide
the axis) gives the whole output and adds nothing.  MLA splits its heads
(``attention.mla_split``) and MoE its experts, or each expert's FFN
columns where the experts do not divide the axis
(``moe.expert_plan``); MoE's router is whole on every rank.

Where the rules also put ``seq`` on that axis (sequence parallelism,
``sharding.seq_group`` of the sequence's length), the residual between
blocks is the rank's S/M slice: the norms and residual adds run on the
slice, each layer gathers its normed input over the sequence once for
its blocks (``sharding.gather_seq``) and each block's output comes back
reduce-scattered, a whole block's by its slice
(``sharding.leave_model``); the embedding's sum is reduce-scattered, and
the final norm runs on the slice before the head takes the gathered
sequence.  Whisper's encoder, whose frames no rule splits, runs whole.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamSpec, dense_ffn, draw_leaf,
                                       linear, rms_norm, stack_specs,
                                       tree_leaves, tree_map, vocab_offset)
from repro_torch.parallel.sharding import (enter_model, gather_seq,
                                           local_index, local_slice,
                                           model_placements,
                                           reduce_from_model, scatter_seq,
                                           seq_group, seq_slice, split_grad)

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
    elif cfg.attention == "mla":
        specs["attn"] = attn.mla_specs(cfg)
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


def encoder_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "norm1": ParamSpec((d,), ("embed",), "ones"),
        "attn": attn.gqa_specs(cfg),
        "norm2": ParamSpec((d,), ("embed",), "ones"),
        "ffn": dense_ffn_specs(cfg, cfg.d_ff),
    }


def decoder_xattn_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs = layer_specs(cfg, ffn="dense")
    specs["norm_x"] = ParamSpec((cfg.d_model,), ("embed",), "ones")
    specs["xattn"] = attn.gqa_specs(cfg)
    return specs


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), "normal", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), "scaled")
    if cfg.encoder_layers:  # enc-dec (whisper)
        specs["enc_layers"] = stack_specs(encoder_layer_specs(cfg),
                                          cfg.encoder_layers)
        specs["enc_norm"] = ParamSpec((d,), ("embed",), "ones")
        specs["layers"] = stack_specs(decoder_xattn_layer_specs(cfg),
                                      cfg.num_layers)
        return specs
    if cfg.vision_tokens:  # vlm projector (stubbed ViT -> LM)
        dv = cfg.vision_embed_dim
        specs["proj1"] = ParamSpec((dv, d), (None, "embed"), "scaled")
        specs["proj2"] = ParamSpec((d, d), ("embed", None), "scaled")
    if cfg.is_moe and cfg.moe.first_k_dense:
        specs["layers_dense"] = stack_specs(
            layer_specs(cfg, ffn="dense", d_ff=dense_d_ff(cfg)),
            cfg.moe.first_k_dense)
        specs["layers"] = stack_specs(
            layer_specs(cfg, ffn="moe"),
            cfg.num_layers - cfg.moe.first_k_dense)
    else:
        specs["layers"] = stack_specs(
            layer_specs(cfg, ffn="moe" if cfg.is_moe else "dense"),
            cfg.num_layers)
    if cfg.mtp_depth:  # DeepSeek-V3 multi-token prediction module
        specs["mtp"] = {
            "norm_h": ParamSpec((d,), ("embed",), "ones"),
            "norm_e": ParamSpec((d,), ("embed",), "ones"),
            "proj": ParamSpec((2 * d, d), (None, "embed"), "scaled"),
            "layer": layer_specs(cfg, ffn="dense", d_ff=dense_d_ff(cfg)),
            "final_norm": ParamSpec((d,), ("embed",), "ones"),
        }
    return specs


def dense_d_ff(cfg: ModelConfig) -> int:
    """The FFN width of the dense layers before a MoE stack and of the
    MTP module's layer."""
    return (cfg.moe.first_dense_d_ff if cfg.is_moe else 0) or cfg.d_ff


def stack_d_ff(cfg: ModelConfig, name: str) -> int:
    """The dense FFN width of the layers of stack `name` (``stacks``)."""
    return dense_d_ff(cfg) if name == "dense" else cfg.d_ff


# ---------------------------------------------------------------------------
# A rank's leaves over the "model" axis
# ---------------------------------------------------------------------------

def tp_layouts(specs, cfg: ModelConfig, path: Tuple = ()):
    """For each leaf of `specs`, how a rank of the ``model`` axis holds it
    in the tensor-parallel models: "whole" (MoE's ``router`` and
    ``router_bias``: every rank routes every token to every expert),
    "paired" (the SSM's ``w_in``: `ssm.paired_columns`) or "shard" (its
    ``model`` shard under the rules, which may be all of it where the dim
    does not divide)."""
    if isinstance(specs, dict):
        return {k: tp_layouts(v, cfg, path + (k,)) for k, v in specs.items()}
    if path[-2:] in (("moe", "router"), ("moe", "router_bias")):
        return "whole"
    if path[-2:] == ("ssm", "w_in"):
        return "paired"
    return "shard"


def seq_whole(specs) -> List[bool]:
    """For each leaf of `specs` (in ``tree_leaves`` order), whether the
    model reads it on whole sequences under sequence parallelism too:
    Whisper's encoder (``enc_layers``, ``enc_norm``), whose frames no
    rule splits."""
    return [key in ("enc_layers", "enc_norm") for key in sorted(specs)
            for _ in tree_leaves(specs[key])]


def local_leaf(x, spec: ParamSpec, layout: str, mesh, rules):
    """The rank's leaf of the whole `x` (a tensor or numpy array) in the
    tensor-parallel models, by `layout` (`tp_layouts`); no collective."""
    if layout == "whole":
        return x
    if layout == "paired":
        if not ssm_mod.paired_split(spec, mesh, rules):
            return x
        return ssm_mod.paired_columns(torch.as_tensor(x), mesh.size(
            mesh.mesh_dim_names.index("model")),
            mesh.get_local_rank("model"))
    return local_slice(x, mesh, model_placements(spec.logical, spec.shape,
                                                 mesh, rules))


def local_draw(spec: ParamSpec, seed: int, layout: str, mesh, rules,
               device) -> torch.Tensor:
    """The rank's leaf by `layout`, drawn from `seed` (``common.draw_leaf``):
    only the blocks it holds are drawn (a rank's experts of a stacked
    expert leaf, each layer of the rest), and it equals `local_leaf` of
    the whole leaf the seed draws.  No collective."""
    if layout == "whole":
        return draw_leaf(spec, seed, device)
    if layout == "paired":
        if not ssm_mod.paired_split(spec, mesh, rules):
            return draw_leaf(spec, seed, device)
        m = mesh.size(mesh.mesh_dim_names.index("model"))
        return draw_leaf(spec, seed, device, cut=lambda t: (
            ssm_mod.paired_columns(t, m, mesh.get_local_rank("model"))))
    return draw_leaf(spec, seed, device, index=local_index(
        spec.shape, mesh, model_placements(spec.logical, spec.shape, mesh,
                                           rules)))


def stacks(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    """The decoder's layer stacks in order: (cache name, param name, layer
    count) -- ``("dense", "layers_dense", k)`` first where the config has
    ``moe.first_k_dense``, then ``("main", "layers", ...)``.  A stack of
    no layers (DeepSeek-V3 cut to its first 3, dense, layers) is left
    out: it has no cache."""
    k = cfg.moe.first_k_dense if cfg.is_moe else 0
    out = [("dense", "layers_dense", k),
           ("main", "layers", cfg.num_layers - k)]
    return [st for st in out if st[2]]


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


def _ffn(lp: Params, x: torch.Tensor, cfg: ModelConfig,
         d_ff: Optional[int] = None, seq=None):
    """The layer's FFN half with its residual -> (x, MoE aux loss or 0);
    a dense FFN of `d_ff` (default ``cfg.d_ff``) whose local width is
    less is the rank's ``mlp`` shard.  Under sequence parallelism (`seq`)
    `x` is the rank's slice: the norm runs on it, the FFN on the gathered
    sequence."""
    if "ffn" in lp:
        h2 = gather_seq(rms_norm(x, lp["norm2"], cfg.norm_eps), seq)
        split = lp["ffn"]["w_up"].shape[-1] < (d_ff or cfg.d_ff)
        return x + dense_ffn(h2, lp["ffn"], cfg.ffn_act, split=split,
                             seq=seq).to(x.dtype), 0.0
    if "moe" in lp:
        h2 = gather_seq(rms_norm(x, lp["norm2"], cfg.norm_eps), seq)
        y, aux = moe_mod.moe_ffn(lp["moe"], h2, cfg, seq)
        return x + y.to(x.dtype), aux
    return x, 0.0


def layer_forward(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions, window: int, need_cache: bool = False,
                  train: bool = False, d_ff: Optional[int] = None):
    """Full-sequence layer.  Returns (x, MoE aux loss or 0, the attention
    cache's entries -- (k, v) for GQA, (c_kv, k_rope) for MLA -- or None,
    ssm state or None); the caches only with `need_cache`.  `positions`
    are the whole sequence's; where the context runs sequence-parallel at
    its length (``sharding.seq_group``), `x` and the result are the
    rank's slice of the residual, and the caches the whole sequence's."""
    seq = seq_group(positions.shape[-1])
    # the blocks' input: the whole sequence, gathered once for them all
    h = gather_seq(rms_norm(x, lp["norm1"], cfg.norm_eps), seq)
    cache_kv = new_ssm_state = None
    branch = 0.0
    if cfg.attention == "gqa":
        a = attn.gqa_forward(lp["attn"], h, cfg=cfg, positions=positions,
                             window=window, train=train, seq=seq)
        if cfg.parallel_ssm:
            a = rms_norm(a, lp["attn_norm"], cfg.norm_eps)
        branch = branch + a
        if need_cache:
            cache_kv = attn.gqa_prefill_kv(lp["attn"], h, cfg=cfg,
                                           positions=positions)
    elif cfg.attention == "mla":
        a = attn.mla_forward(lp["attn"], h, cfg=cfg, positions=positions,
                             return_cache=need_cache, train=train, seq=seq)
        if need_cache:
            a, cache_kv = a
        branch = branch + a
    if cfg.ssm is not None:
        if need_cache:
            s_out, new_ssm_state = ssm_mod.mamba_forward(
                lp["ssm"], h, cfg, return_state=True, seq=seq)
        else:
            s_out = ssm_mod.mamba_forward(lp["ssm"], h, cfg, train=train,
                                          seq=seq)
        if cfg.parallel_ssm:
            s_out = rms_norm(s_out, lp["ssm_norm"], cfg.norm_eps)
            branch = 0.5 * (branch + s_out)
        else:
            branch = branch + s_out
    x = x + branch.to(x.dtype)
    x, aux = _ffn(lp, x, cfg, d_ff, seq)
    return x, aux, cache_kv, new_ssm_state


def layer_decode(lp: Params, x: torch.Tensor, cache, cfg: ModelConfig, *,
                 positions, window: int,
                 d_ff: Optional[int] = None) -> torch.Tensor:
    """One-token layer step; ``cache["kv"]`` and ``cache["ssm"]`` (those
    the layer has) are written in place; an enc-dec decoder layer reads
    its encoder K/V from ``cache["cross"]``."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if "xattn" in lp:  # enc-dec decoder layer: self-attn then cross-attn
        a, _ = attn.gqa_decode(lp["attn"], h, cache["kv"], cfg=cfg,
                               positions=positions, window=window)
        x = x + a.to(x.dtype)
        hx = rms_norm(x, lp["norm_x"], cfg.norm_eps)
        ek, ev = cache["cross"]
        x = x + attn.cross_attention(lp["xattn"], hx, ek, ev,
                                     cfg=cfg).to(x.dtype)
        return _ffn(lp, x, cfg)[0]
    branch = 0.0
    if cfg.attention == "gqa":
        a, _ = attn.gqa_decode(lp["attn"], h, cache["kv"], cfg=cfg,
                               positions=positions, window=window)
        if cfg.parallel_ssm:
            a = rms_norm(a, lp["attn_norm"], cfg.norm_eps)
        branch = branch + a
    elif cfg.attention == "mla":
        a, _ = attn.mla_decode(lp["attn"], h, cache["kv"], cfg=cfg,
                               positions=positions)
        branch = branch + a
    if cfg.ssm is not None:
        s_out, _ = ssm_mod.mamba_decode(lp["ssm"], h, cache["ssm"], cfg)
        if cfg.parallel_ssm:
            s_out = rms_norm(s_out, lp["ssm_norm"], cfg.norm_eps)
            branch = 0.5 * (branch + s_out)
        else:
            branch = branch + s_out
    x = x + branch.to(x.dtype)
    return _ffn(lp, x, cfg, d_ff)[0]


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

# the matmul outputs that remat="dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _remat(fn: Callable, cfg: ModelConfig, train: bool) -> Callable:
    """`fn` (one layer) checkpointed by ``cfg.remat`` when training."""
    if not train or cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, list(_DOTS)))
    raise ValueError(f"remat must be full, dots or none, got {cfg.remat!r}")


def decoder_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, need_cache: bool = False,
                    train: bool = False):
    """Runs the decoder stacks on embedded inputs -> (hidden, aux, caches).
    aux sums the MoE layers' aux losses (0 without MoE).  With
    `need_cache`, caches maps each stack's cache name (``stacks``) to
    ``{"kv": [(k, v) or (c_kv, k_rope) per layer] or None, "ssm":
    [{"conv", "ssm"} per layer] or None}``, k/v (B,S,nkv,hd), c_kv
    (B,S,kv_lora_rank), k_rope (B,S,qk_rope_head_dim); else None."""
    aux = 0.0
    caches: Dict[str, Any] = {}
    for name, key, n in stacks(cfg):
        kvs: List[Any] = []
        states: List[Any] = []
        for i in range(n):
            # the dense stack attends with the config's window throughout
            window = (_layer_window(cfg, i) if name == "main"
                      else cfg.sliding_window)
            layer = _remat(functools.partial(
                layer_forward, cfg=cfg, positions=positions, window=window,
                need_cache=need_cache, train=train,
                d_ff=stack_d_ff(cfg, name)), cfg, train)
            x, a, kv, st = layer(layer_slice(params[key], i), x)
            aux = aux + a
            kvs.append(kv)
            states.append(st)
        caches[name] = {"kv": kvs if cfg.attention in ("gqa", "mla")
                        else None,
                        "ssm": states if cfg.ssm is not None else None}
    return x, aux, (caches if need_cache else None)


def _encoder_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   positions, train: bool):
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = x + attn.encoder_attention(lp["attn"], h, cfg=cfg,
                                   positions=positions,
                                   train=train).to(x.dtype)
    return _ffn(lp, x, cfg)[0]


def encoder_forward(params: Params, frames: torch.Tensor, cfg: ModelConfig,
                    train: bool = False):
    """Whisper-style encoder over (stubbed) frame embeddings (B,T,d)."""
    b, t = frames.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device).expand(b, t)
    layer = _remat(functools.partial(_encoder_layer, cfg=cfg,
                                     positions=positions, train=train),
                   cfg, train)
    x = frames
    for i in range(cfg.encoder_layers):
        x = layer(layer_slice(params["enc_layers"], i), x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _encdec_layer(lp: Params, x: torch.Tensor, enc_out: torch.Tensor,
                  cfg: ModelConfig, *, positions, need_cache: bool,
                  train: bool):
    """One Whisper decoder layer -> (x, its cache entries or None); `x`
    the rank's slice under sequence parallelism, as in `layer_forward`."""
    seq = seq_group(positions.shape[-1])
    h = gather_seq(rms_norm(x, lp["norm1"], cfg.norm_eps), seq)
    x = x + attn.gqa_forward(lp["attn"], h, cfg=cfg, positions=positions,
                             window=0, train=train, seq=seq).to(x.dtype)
    hx = gather_seq(rms_norm(x, lp["norm_x"], cfg.norm_eps), seq)
    ek, ev = attn.cross_kv(lp["xattn"], enc_out, cfg, seq)
    x = x + attn.cross_attention(lp["xattn"], hx, ek, ev, cfg=cfg,
                                 train=train, seq=seq).to(x.dtype)
    x = _ffn(lp, x, cfg, seq=seq)[0]
    if not need_cache:
        return x, None
    return x, (attn.gqa_prefill_kv(lp["attn"], h, cfg=cfg,
                                   positions=positions), (ek, ev))


def encdec_decoder_forward(params: Params, x: torch.Tensor,
                           enc_out: torch.Tensor, cfg: ModelConfig, *,
                           positions, need_cache: bool = False,
                           train: bool = False):
    """Whisper decoder: self-attn + cross-attn + ffn per layer ->
    (hidden, caches).  With `need_cache`, caches is ((k, v), (ek, ev)),
    each stacked over the layers: the self-attention's (L,B,S,nkv,hd)
    and the encoder's cross K/V (L,B,T,nkv,hd); else None."""
    layer = _remat(functools.partial(_encdec_layer, cfg=cfg,
                                     positions=positions,
                                     need_cache=need_cache, train=train),
                   cfg, train)
    kvs, crosses = [], []
    for i in range(cfg.num_layers):
        x, got = layer(layer_slice(params["layers"], i), x, enc_out)
        if need_cache:
            kvs.append(got[0])
            crosses.append(got[1])
    if not need_cache:
        return x, None
    stack = lambda pairs: tuple(torch.stack(t) for t in zip(*pairs))
    return x, (stack(kvs), stack(crosses))


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 seq=None, prefix: Optional[torch.Tensor] = None):
    """The tokens' embeddings, after `prefix` (B, Nv, d) where given (the
    projected patches, whole on every rank); from a vocab-parallel table
    (the rank's rows), each rank looks up the tokens it holds and the
    ranks' lookups are summed.  Under sequence parallelism (`seq`, the
    ``sharding.seq_group`` of the whole length) the result is the rank's
    slice of the sequence: the sum reduce-scattered (a whole prefix added
    in by the first rank alone), or a whole table's lookup cut."""
    table = params["embed"]
    dtype = getattr(torch, cfg.dtype)
    split = table.shape[0] < cfg.vocab_size
    if not split:
        x = table[tokens.long()].to(dtype)
    else:
        local = tokens.long() - vocab_offset(table.shape[0], cfg.vocab_size)
        mine = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(mine, local, 0)].to(dtype)
        x = torch.where(mine[..., None], x, 0)
    if seq is None:
        x = reduce_from_model(x) if split else x
        return x if prefix is None else torch.cat([prefix.to(x.dtype), x], 1)
    if prefix is not None:
        if split and seq.rank:
            prefix = torch.zeros_like(prefix)
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return scatter_seq(x, seq) if split else seq_slice(x, seq)


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig, seq=None):
    """The logits of normed `x`: the rank's vocabulary slice of them where
    the head is vocab-parallel (its input then enters through
    ``copy_to_model``).  Under sequence parallelism (`seq`) `x` is the
    gathered sequence; a whole head then gives every rank the same
    logits, whose gradients count once over the ranks
    (``sharding.split_grad``)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if head.shape[-1] < cfg.vocab_size:
        x = enter_model(x, True, seq)
    elif seq is not None:
        x, head = split_grad(x, seq), split_grad(head, seq)
    return linear(x, head)


def lm_logits(params: Params, x: torch.Tensor, cfg: ModelConfig, seq=None,
              skip: int = 0):
    """(..., V) logits, or the rank's (..., V / model) slice of them, of
    the positions of `x` after its first `skip` (the vision tokens).
    Under sequence parallelism (`seq`) `x` is the rank's slice: the final
    norm runs on it, and the logits are the whole sequence's."""
    x = gather_seq(rms_norm(x, params["final_norm"], cfg.norm_eps), seq)
    return _head(params, x[:, skip:] if skip else x, cfg, seq)


def last_hidden(h: torch.Tensor, seq=None) -> torch.Tensor:
    """(B, 1, d): the sequence's last position of `h`, the whole sequence
    or, under sequence parallelism (`seq`), the rank's slice of it (the
    last rank's last row, gathered from every rank's)."""
    return h[:, -1:] if seq is None else gather_seq(h[:, -1:], seq)[:, -1:]


def mtp_forward(params: Params, h: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, *, positions) -> torch.Tensor:
    """DeepSeek-V3 MTP (depth 1), a training path: combine the final
    hidden h_t with the embedding of token_{t+1}; the shared head then
    predicts token_{t+2}.  Its layer is not checkpointed (the JAX
    package's is not either).  Under sequence parallelism `h` is the
    rank's slice, as the decoder leaves it."""
    mp = params["mtp"]
    seq = seq_group(positions.shape[-1])
    emb_next = embed_tokens(params, tokens, cfg, seq)    # (B,S,d) of t+1
    h_n = rms_norm(h, mp["norm_h"], cfg.norm_eps)
    e_n = rms_norm(emb_next, mp["norm_e"], cfg.norm_eps)
    z = linear(torch.cat([h_n, e_n], dim=-1), mp["proj"])
    z, _, _, _ = layer_forward(mp["layer"], z, cfg, positions=positions,
                               window=cfg.sliding_window, train=True,
                               d_ff=dense_d_ff(cfg))
    z = gather_seq(rms_norm(z, mp["final_norm"], cfg.norm_eps), seq)
    return _head(params, z, cfg, seq)
