"""A dense decoder with grouped-query attention, plain fp32.

Per layer: x += Wo . attn(RoPE(Wq h), RoPE(Wk h), Wv h) with h =
RMSNorm(x) * norm1, causal (within `sliding_window` keys where set), query
head j reading kv head j // (heads / kv heads), scores scaled by
head_dim**-0.5; then x += W_down act(W_up h2) with h2 = RMSNorm(x) * norm2
(GELU, tanh form; SwiGLU where ``ffn_act`` says).  The logits are
RMSNorm(x) * final_norm times the head.  The weights are read by the
program's names: ``layers/attn/wq`` (d, heads, hd), ``wk``/``wv`` (d,
kv heads, hd), ``wo`` (heads, hd, d), ``layers/ffn/w_up`` (d, d_ff),
``w_down`` (d_ff, d), each stacked over the layers.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import ops

# the draws' scale of the query and key projections: scores of standard
# deviation about 4, so that attention picks few keys and its output
# weighs in the logits
QK_SCALE = 2.0
# query rows a block of the attention holds
BLOCK = 512


def _dims(cfg):
    d, nq = cfg["d_model"], cfg["num_heads"]
    return d, nq, cfg["num_kv_heads"], cfg.get("head_dim") or d // nq


def layout(cfg: dict):
    """(path, shape, dtype, draw) of every weight."""
    d, nq, nkv, hd = _dims(cfg)
    L, v, f = cfg["num_layers"], cfg["vocab_size"], cfg["d_ff"]
    inv = lambda n: 1.0 / math.sqrt(n)           # noqa: E731
    out = [
        (("embed",), (v, d), "bfloat16", {"std": 1.0}),
        (("final_norm",), (d,), "bfloat16", {"mean": 1.0, "std": 0.1}),
        (("layers", "norm1"), (L, d), "bfloat16", {"mean": 1.0, "std": 0.1}),
        (("layers", "norm2"), (L, d), "bfloat16", {"mean": 1.0, "std": 0.1}),
        (("layers", "attn", "wq"), (L, d, nq, hd), "bfloat16",
         {"std": QK_SCALE * inv(d)}),
        (("layers", "attn", "wk"), (L, d, nkv, hd), "bfloat16",
         {"std": QK_SCALE * inv(d)}),
        (("layers", "attn", "wv"), (L, d, nkv, hd), "bfloat16",
         {"std": inv(d)}),
        (("layers", "attn", "wo"), (L, nq, hd, d), "bfloat16",
         {"std": inv(nq * hd)}),
        (("layers", "ffn", "w_up"), (L, d, f), "bfloat16", {"std": inv(d)}),
        (("layers", "ffn", "w_down"), (L, f, d), "bfloat16",
         {"std": inv(f)}),
    ]
    if cfg.get("ffn_act", "swiglu") == "swiglu":
        out.append((("layers", "ffn", "w_gate"), (L, d, f), "bfloat16",
                    {"std": inv(d)}))
    if not cfg.get("tie_embeddings", False):
        out.append((("lm_head",), (d, v), "bfloat16", {"std": inv(d)}))
    return out


def _attention(q, k, v, window: int):
    """q (T, nq, hd), k and v (T, nkv, hd) -> (T, nq, hd), causal."""
    t, nq, hd = q.shape
    g = nq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(t, device=q.device)
    for a in range(0, t, BLOCK):
        qb = q[a:a + BLOCK]
        s = torch.einsum("qhd,khd->hqk", qb, k) * hd ** -0.5
        rel = torch.arange(a, a + len(qb), device=q.device)[:, None] - kpos
        ok = rel >= 0
        if window:
            ok &= rel < window
        s = s.masked_fill(~ok[None], float("-inf"))
        out[a:a + BLOCK] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                        v)
    return out


def _layer(cfg, lp, x, mm):
    d, nq, nkv, hd = _dims(cfg)
    eps, t = cfg.get("norm_eps", 1e-5), x.shape[0]
    h = ops.rms_norm(x, lp["norm1"], eps)
    q = mm(h, lp["wq"].reshape(d, -1)).view(t, nq, hd)
    k = mm(h, lp["wk"].reshape(d, -1)).view(t, nkv, hd)
    v = mm(h, lp["wv"].reshape(d, -1)).view(t, nkv, hd)
    theta = cfg.get("rope_theta", 10000.0)
    o = _attention(ops.rope(q, theta), ops.rope(k, theta), v,
                   cfg.get("sliding_window", 0))
    x = x + mm(o.reshape(t, -1), lp["wo"].reshape(-1, d))
    h = ops.rms_norm(x, lp["norm2"], eps)
    if "w_gate" in lp:
        u = torch.nn.functional.silu(mm(h, lp["w_gate"])) * mm(h, lp["w_up"])
    else:
        u = ops.gelu_tanh(mm(h, lp["w_up"]))
    return x + mm(u, lp["w_down"])


def logits(cfg: dict, params: dict, seqs, wanted, mm=ops.exact):
    """fp32 logits (len(w), vocab) at positions `w` of each sequence."""
    xs = [params["embed"][s].float() for s in seqs]
    layers = params["layers"]
    for i in range(cfg["num_layers"]):
        lp = {k: w[i].float() for k, w in layers["attn"].items()}
        lp.update({k: w[i].float() for k, w in layers["ffn"].items()})
        lp.update(norm1=layers["norm1"][i].float(),
                  norm2=layers["norm2"][i].float())
        xs = [_layer(cfg, lp, x, mm) for x in xs]
        del lp
    head = (params["embed"].T if cfg.get("tie_embeddings", False)
            else params["lm_head"]).float()
    fn = params["final_norm"].float()
    return [mm(ops.rms_norm(x[w], fn, cfg.get("norm_eps", 1e-5)), head)
            for x, w in zip(xs, wanted)]
