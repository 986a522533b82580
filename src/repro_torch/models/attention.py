"""Attention: GQA (full / sliding-window), MLA (DeepSeek-V3), and the
bidirectional encoder and cross attention of the enc-dec (Whisper) family;
prefill and decode.

The port of ``repro/models/attention.py``.  GQA prefill, encoder and
cross attention go through ``flash_attention_op`` (causal for GQA
prefill, non-causal for the encoder and for cross attention, whose
queries, the prompt or one decode token, attend to all the encoder's
frames), which launches the hand-written CUDA kernel on a CUDA tensor
and runs its plain version on a CPU tensor: fp32 scores, softmax and
P.V, the output in the activation dtype.  (The JAX package computes
these in jnp, with bf16 probabilities and a bf16 P.V product in bf16
models, and names its Pallas kernel as the drop-in for it.)

Decode uses a unified cache layout: (B, Sc, nkv, hd) K/V plus a (B, Sc)
int32 ``pos`` tensor holding the absolute position stored in each slot
(-1 = empty).  A rolling (sliding-window) cache is the same structure with
Sc = window and slot = pos % Sc, so full and SWA caches share one code
path.  `gqa_decode` writes the new token's K/V/pos into the cache in
place; with ``cfg.decode_kernel`` the attention itself goes through
``decode_attention_op``, which launches the hand-written CUDA kernel on a
CUDA tensor and runs its plain version on a CPU tensor.

MLA runs in plain PyTorch (cuBLAS products on the card), as the JAX
package runs it in jnp outside any Pallas kernel: its prefill expands the
latent to per-head K (qk_nope + qk_rope = 192 wide) and V (128 wide),
which the flash kernel, one head width for q, k and v, does not take, so
it attends in `_attend_chunked` (fp32 scores and softmax, probabilities
cast to V's dtype before P.V, ``MLA_CHUNK`` query rows at a time).  Its
decode caches the compressed latent (kv_lora_rank + rope_dim per token,
slot pos % max_len, no window) and uses the absorbed-matmul trick, which
is the point of MLA's serving efficiency.

Over a ``model`` axis (tensor parallelism, ``models/common.py``) a GQA
block reads its head counts from its local weights: column-parallel
``wq``/``wk``/``wv`` give the rank's heads, the row-parallel ``wo``'s
partial sums are added over the ranks.  Where the q heads divide the axis
and the kv heads do not, ``wk``/``wv`` are whole on every rank and each
rank projects only the kv heads its q heads read (`kv_select`); their
gradients on each rank are partial sums, which ``copy_to_model`` on the
weights adds up.  Where the q heads do not divide (Hymba, Whisper over 16)
the block runs whole on every rank.  MLA splits its heads the same way
(`mla_split`): column-parallel ``wq_b``/``wk_b``/``wv_b``, row-parallel
``wo``, on latents whole on every rank (``wq_a``, ``wkv_a`` and their
norms are whole); its decode cache, the latent, is whole on every rank
too (the reference shards its ``kv_seq`` over ``model`` instead).
Under sequence parallelism (``seq``, ``models/transformer.py``) every
block takes the gathered sequence, RoPE at the absolute positions, and
gives the rank's slice of its output; the prefill cache is the whole
sequence's.

Training (``train=True``, passed down from ``Model.train_forward``) never
reaches a kernel: the flash kernel is forward-only (its op refuses inputs
that require grad), and the JAX package trains through jnp
`_attend_chunked`.  GQA, encoder and cross attention then attend in
`_attend_chunked` at the reference's ``TRAIN_CHUNK`` query rows, MLA at
``MLA_CHUNK``, each chunk checkpointed: its scores and probabilities are
recomputed in the backward pass, as the reference's
``jax.checkpoint(body)`` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.common import (ParamSpec, apply_rope, linear,
                                       rms_norm)
from repro_torch.parallel.sharding import (copy_to_model, enter_model,
                                           leave_model, model_group,
                                           model_local_shape,
                                           reduce_from_model)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# query rows per chunk of MLA's prefill attention.  The chunk does not
# change the result; it bounds the fp32 scores a chunk holds: at
# DeepSeek-V3's 128 heads, B=8 and 1024 keys, 256 rows are 1.07 GB (the
# JAX package's 1024 would be 4.3 GB, twice over for the softmax).
MLA_CHUNK = 256
# query rows per chunk of the training attention (the JAX package's)
TRAIN_CHUNK = 1024


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


def kv_select(nq: int, nkv: int, nq_local: int, rank: int):
    """The kv heads that q heads ``rank * nq_local ...`` read (q head h
    reads kv head ``h // (nq // nkv)``), as a slice where they take equal
    groups of those q heads, else one kv head per q head (a list)."""
    g = nq // nkv
    ids = [(rank * nq_local + j) // g for j in range(nq_local)]
    lo, hi = ids[0], ids[-1] + 1
    if nq_local % (hi - lo) == 0 and all(
            ids.count(i) == nq_local // (hi - lo) for i in range(lo, hi)):
        return slice(lo, hi)
    return ids


def tp_heads(params, cfg: ModelConfig):
    """How a GQA block's params lie over the ``model`` axis -> (split,
    kv): `split` when the q heads are the rank's shard (fewer than the
    config's), `kv` the `kv_select` of the whole ``wk``/``wv`` that the
    rank's q heads read where the kv heads did not divide, else None."""
    nq_local = params["wq"].shape[-2]
    if nq_local == cfg.num_heads:
        return False, None
    mg = model_group()
    if mg is None or nq_local * mg.size != cfg.num_heads:
        raise ValueError(f"{nq_local} of {cfg.num_heads} q heads outside a "
                         f"sharding context over the model axis")
    if params["wk"].shape[-2] < cfg.num_kv_heads:
        return True, None
    return True, kv_select(cfg.num_heads, cfg.num_kv_heads, nq_local,
                           mg.rank)


def local_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(q heads, kv heads) a rank's GQA cache and kernels see under the
    current sharding context: the heads of its ``wq``/``wk`` shards under
    the context's rules (`model_local_shape`), and where its q heads are
    a shard but its ``wk`` is whole, the `kv_select` of the kv heads."""
    specs = gqa_specs(cfg)
    nq = model_local_shape(specs["wq"].logical, specs["wq"].shape)[-2]
    nkv = model_local_shape(specs["wk"].logical, specs["wk"].shape)[-2]
    if nq == cfg.num_heads or nkv < cfg.num_kv_heads:
        return nq, nkv
    sel = kv_select(cfg.num_heads, nkv, nq, model_group().rank)
    return nq, (sel.stop - sel.start if isinstance(sel, slice)
                else len(sel))


def _kv_weight(w: torch.Tensor, kv, seq=None) -> torch.Tensor:
    """``wk``/``wv`` cut to the heads `kv` selects; the whole weight's
    gradient then sums the ranks' parts (under sequence parallelism the
    sharded step sums them, as every leaf whole on the ``model`` ranks)."""
    if kv is None:
        return w
    return (w if seq is not None else copy_to_model(w))[:, kv]


def gqa_forward(params, x, *, cfg: ModelConfig, positions,
                window: int, train: bool = False, seq=None) -> torch.Tensor:
    """Full-sequence (train / prefill) GQA with RoPE.  `positions` must be
    ``arange(S)`` in every row (``model._positions``): the attention
    kernel places query and kv row i at position i.  On the rank's local
    heads (`tp_heads`); under sequence parallelism (`seq`) `x` is the
    gathered sequence and the output the rank's slice
    (``sharding.leave_model``)."""
    split, kv = tp_heads(params, cfg)
    x = enter_model(x, split, seq)
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, _kv_weight(params["wk"], kv, seq)), positions,
                   cfg.rope_theta)
    v = _project(x, _kv_weight(params["wv"], kv, seq))
    if train:
        out = _attend_train(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            window=window)
    else:
        out = flash_attention_op(q, k, v, causal=True, window=window)
    return leave_model(_out_proj(out, params["wo"]), split, seq)


def gqa_prefill_kv(params, x, *, cfg: ModelConfig, positions):
    """K/V for cache population during prefill (post-RoPE), the rank's
    local kv heads."""
    _, kv = tp_heads(params, cfg)
    k = apply_rope(_project(x, _kv_weight(params["wk"], kv)), positions,
                   cfg.rope_theta)
    v = _project(x, _kv_weight(params["wv"], kv))
    return k, v


def init_gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                        window: int, local: bool = False
                        ) -> Dict[str, Tuple[Tuple[int, ...], tuple]]:
    """The cache's (shape, logical axes); with `local`, its kv heads are
    the rank's (`local_heads`)."""
    sc = min(max_len, window) if window else max_len
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if local:
        nkv = local_heads(cfg)[1]
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
    place (they may be views into a stacked cache).  Returns (y, cache).
    The head counts are the local weights' and cache's (`tp_heads`)."""
    split, kv = tp_heads(params, cfg)
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    pos2 = positions[:, None]
    q = apply_rope(_project(x, params["wq"]), pos2, cfg.rope_theta)
    k = apply_rope(_project(x, _kv_weight(params["wk"], kv)), pos2,
                   cfg.rope_theta)
    v = _project(x, _kv_weight(params["wv"], kv))
    nq, nkv = q.shape[2], k.shape[2]
    g = nq // nkv
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
    y = _out_proj(out, params["wo"])
    return (reduce_from_model(y) if split else y), cache


def _attend_chunk(qc, qp, k32, v, kv_positions, causal: bool, window: int):
    """One query chunk of `_attend_chunked`."""
    # out of place: remat="dots" keeps the product itself for the
    # backward pass, so it must not be written over
    scores = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), k32) * (
        qc.shape[-1] ** -0.5)
    rel = qp[:, :, None] - kv_positions[:, None, :]
    mask = torch.ones_like(rel, dtype=torch.bool)        # (B,c,Skv)
    if causal:
        mask &= rel >= 0
    if window:
        mask &= rel < window
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _attend_chunked(q, k, v, *, q_positions, kv_positions, causal: bool,
                    window: int, chunk: int,
                    remat: bool = False) -> torch.Tensor:
    """q: (B,S,nkv,g,hd); k: (B,Skv,nkv,hd); v: (B,Skv,nkv,vd) ->
    (B,S,nkv,g,vd).  Per query chunk: fp32 scores (the JAX package's
    ``preferred_element_type``) scaled by hd**-0.5, the causal/window mask
    from the positions, an fp32 softmax, the probabilities cast to v's
    dtype before P.V.  With `remat`, each chunk is checkpointed."""
    k32 = k.float()
    outs = []
    for a in range(0, q.shape[1], chunk):
        args = (q[:, a:a + chunk], q_positions[:, a:a + chunk], k32, v,
                kv_positions, causal, window)
        outs.append(checkpoint(_attend_chunk, *args, use_reentrant=False)
                    if remat else _attend_chunk(*args))
    return torch.cat(outs, dim=1)


def _attend_train(q, k, v, *, q_positions, kv_positions, causal: bool,
                  window: int = 0) -> torch.Tensor:
    """q (B,S,nq,hd); k, v (B,Skv,nkv,hd) -> (B,S,nq,hd): the training
    route, `_attend_chunked` at ``TRAIN_CHUNK`` rows, chunks checkpointed."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    out = _attend_chunked(q.reshape(b, s, nkv, nq // nkv, hd), k, v,
                          q_positions=q_positions, kv_positions=kv_positions,
                          causal=causal, window=window, chunk=TRAIN_CHUNK,
                          remat=True)
    return out.reshape(b, s, nq, v.shape[-1])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, nq, m = cfg.d_model, cfg.num_heads, cfg.mla
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "mla_rank"), "scaled"),
        "q_norm": ParamSpec((m.q_lora_rank,), ("mla_rank",), "ones"),
        "wq_b": ParamSpec((m.q_lora_rank, nq, qh), ("mla_rank", "heads", "head_dim"), "scaled"),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "mla_rank"), "scaled"),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("mla_rank",), "ones"),
        "wk_b": ParamSpec((m.kv_lora_rank, nq, m.qk_nope_head_dim),
                          ("mla_rank", "heads", "head_dim"), "scaled"),
        "wv_b": ParamSpec((m.kv_lora_rank, nq, m.v_head_dim),
                          ("mla_rank", "heads", "head_dim"), "scaled"),
        "wo": ParamSpec((nq, m.v_head_dim, d), ("heads", "head_dim", "embed"), "scaled"),
    }


def mla_split(params, cfg: ModelConfig) -> bool:
    """Whether an MLA block's heads are the rank's shard over the
    ``model`` axis (its ``wq_b`` holds fewer than the config's heads)."""
    nq_local = params["wq_b"].shape[-2]
    if nq_local == cfg.num_heads:
        return False
    mg = model_group()
    if mg is None or nq_local * mg.size != cfg.num_heads:
        raise ValueError(f"{nq_local} of {cfg.num_heads} MLA heads outside "
                         f"a sharding context over the model axis")
    return True


def _mla_qkv_latent(params, x, *, cfg: ModelConfig, positions,
                    split: bool = False):
    """Shared projection path: returns per-head q (nope, rope), the
    latent c_kv and the shared k_rope (post-RoPE).  With `split` the
    heads are the rank's, and the latents, whole on every rank, feed
    only them: ``q_lat``, c_kv and k_rope go through ``copy_to_model``
    (after their norms, whose weights' gradients are then whole; under
    sequence parallelism `mla_forward` passes no `split`: the gathered
    input's backward sums the ranks' parts, and the sharded step the
    latent weights')."""
    m = cfg.mla
    enter = copy_to_model if split else (lambda t: t)
    q_lat = enter(rms_norm(linear(x, params["wq_a"]), params["q_norm"],
                           cfg.norm_eps))
    q = _project(q_lat, params["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    kv = linear(x, params["wkv_a"])
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], params["kv_norm"],
                    cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, enter(c_kv), enter(k_rope[..., 0, :])


def mla_forward(params, x, *, cfg: ModelConfig, positions,
                chunk: int = MLA_CHUNK, return_cache: bool = False,
                train: bool = False, seq=None):
    """Train / prefill MLA: the latent expanded to per-head K/V, causal
    attention with the scale of the full QK head width, (qk_nope +
    qk_rope)**-0.5; with `train`, each chunk is checkpointed.  With
    `return_cache`, returns (y, (c_kv, k_rope)), the decode cache's
    entries from the same projection.  On the rank's heads
    (`mla_split`), its ``wo``'s partial sums added over the ranks; under
    sequence parallelism (`seq`) `x` is the gathered sequence, the output
    the rank's slice and the cache whole."""
    m = cfg.mla
    split = mla_split(params, cfg)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(
        params, x, cfg=cfg, positions=positions,
        split=split and seq is None)
    k_nope = _project(c_kv, params["wk_b"])
    v = _project(c_kv, params["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_nope.shape[:3] + (m.qk_rope_head_dim,))], dim=-1)
    out = _attend_chunked(q[:, :, :, None, :], k, v, q_positions=positions,
                          kv_positions=positions, causal=True, window=0,
                          chunk=chunk, remat=train)      # g=1 (nkv == nq)
    y = leave_model(_out_proj(out[..., 0, :], params["wo"]), split, seq)
    return (y, (c_kv, k_rope)) if return_cache else y


def init_mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """The latent cache's (shape, logical axes): the same on every
    ``model`` rank (the heads' split leaves it whole)."""
    m = cfg.mla
    return {
        "c_kv": ((batch, max_len, m.kv_lora_rank), ("batch", "kv_seq", "mla_rank")),
        "k_rope": ((batch, max_len, m.qk_rope_head_dim), ("batch", "kv_seq", None)),
        "pos": ((batch, max_len), ("batch", "kv_seq")),
    }


def mla_decode(params, x, cache, *, cfg: ModelConfig, positions):
    """Absorbed-matmul MLA decode against the compressed latent cache.
    x: (B,1,d); positions: (B,) int32; cache: this layer's {"c_kv",
    "k_rope", "pos"}, the new token written in place at slot
    pos % max_len.  Returns (y, cache).  The absorbed products run on
    the rank's heads (`mla_split`); the cache is whole on every rank."""
    m = cfg.mla
    b = x.shape[0]
    split = mla_split(params, cfg)
    q_nope, q_rope, c_new, r_new = _mla_qkv_latent(
        params, x, cfg=cfg, positions=positions[:, None], split=split)
    c_cache, r_cache, pos_cache = cache["c_kv"], cache["k_rope"], cache["pos"]
    idx = (torch.arange(b, device=x.device),
           (positions % c_cache.shape[1]).long())
    c_cache.index_put_(idx, c_new[:, 0].to(c_cache.dtype))
    r_cache.index_put_(idx, r_new[:, 0].to(r_cache.dtype))
    pos_cache.index_put_(idx, positions.to(pos_cache.dtype))
    # absorb: q_lat[b,s,h,r] = q_nope[b,s,h,e] @ wk_b[r,h,e]
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope,
                         params["wk_b"].to(q_nope.dtype))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_cache.float())
              + torch.einsum("bshe,bte->bhst", q_rope.float(),
                             r_cache.float())) * scale
    valid = (pos_cache >= 0) & (pos_cache <= positions[:, None])
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhst,btr->bshr", probs.to(c_cache.dtype),
                           c_cache)
    out = torch.einsum("bshr,rhe->bshe", out_lat,
                       params["wv_b"].to(out_lat.dtype))
    y = _out_proj(out, params["wo"])
    return (reduce_from_model(y) if split else y), cache


# ---------------------------------------------------------------------------
# Bidirectional (encoder) + cross attention, for the enc-dec (whisper) family
# ---------------------------------------------------------------------------

def encoder_attention(params, x, *, cfg: ModelConfig, positions,
                      train: bool = False):
    """Bidirectional GQA with RoPE over the encoder's frames, on the
    rank's local heads (`tp_heads`)."""
    split, kv = tp_heads(params, cfg)
    if split:
        x = copy_to_model(x)
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, _kv_weight(params["wk"], kv)), positions,
                   cfg.rope_theta)
    v = _project(x, _kv_weight(params["wv"], kv))
    if train:
        out = _attend_train(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=False)
    else:
        out = flash_attention_op(q, k, v, causal=False)
    y = _out_proj(out, params["wo"])
    return reduce_from_model(y) if split else y


def cross_attention(params, x, enc_k, enc_v, *, cfg: ModelConfig,
                    train: bool = False, seq=None):
    """x: (B,S,d) decoder side (the prompt, or one decode token); enc_k,
    enc_v: (B,T,nkv,hd) precomputed (`cross_kv`, the rank's kv heads).
    No RoPE, no mask.  Under sequence parallelism (`seq`) `x` is the
    gathered sequence and the output the rank's slice."""
    split, _ = tp_heads(params, cfg)
    x = enter_model(x, split, seq)
    q = _project(x, params["wq"])
    if train:
        b, s, t = x.shape[0], x.shape[1], enc_k.shape[1]
        zeros = lambda n: torch.zeros((b, n), dtype=torch.int32,
                                      device=x.device)
        out = _attend_train(q, enc_k, enc_v, q_positions=zeros(s),
                            kv_positions=zeros(t), causal=False)
    else:
        out = flash_attention_op(q, enc_k, enc_v, causal=False)
    return leave_model(_out_proj(out, params["wo"]), split, seq)


def cross_kv(params, enc_out, cfg: Optional[ModelConfig] = None, seq=None):
    """The encoder's K/V for cross attention: the rank's kv heads (whole
    params without `cfg`).  The encoder runs whole on every rank; under
    sequence parallelism (`seq`) each rank's queries are its slice's, so
    the gradient of `enc_out` sums the ranks' parts whether or not the
    heads split."""
    split, kv = (False, None) if cfg is None else tp_heads(params, cfg)
    if split or seq is not None:
        enc_out = copy_to_model(enc_out)
    return (_project(enc_out, _kv_weight(params["wk"], kv, seq)),
            _project(enc_out, _kv_weight(params["wv"], kv, seq)))
