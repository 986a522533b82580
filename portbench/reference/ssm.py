"""A Mamba-1 decoder (attention-free), plain fp32.

Per layer, with h = RMSNorm(x) * norm1: (xi, z) = h W_in (the two halves
of its 2*Di columns); xc = SiLU(causal depthwise conv of xi, kernel k,
plus its bias), tap j of the conv weight on step t - (k-1) + j; (dt_low,
B, C) = xc W_x; dt = softplus(dt_low W_dt + dt_bias); A = -exp(a_log);
the state h_t = exp(dt_t A) h_{t-1} + (dt_t xc_t) B_t, from zero, one step
at a time; y_t = h_t C_t + D xc_t; x += (y * SiLU(z)) W_out.  The logits
are RMSNorm(x) * final_norm times the head.  The weights are read by the
program's names under ``layers/ssm`` (``w_in``, ``conv_w`` (k, Di),
``conv_b``, ``w_x``, ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip``,
``w_out``), each stacked over the layers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import ops

# time steps whose per-step factors a block of the scan holds at once
SCAN_BLOCK = 128


def _dims(cfg):
    d, s = cfg["d_model"], cfg["ssm"]
    di = s["expand"] * d
    return d, di, s.get("dt_rank") or -(-d // 16), s["state_dim"], \
        s["conv_kernel"]


def layout(cfg: dict):
    """(path, shape, dtype, draw) of every weight."""
    d, di, r, n, k = _dims(cfg)
    L, v = cfg["num_layers"], cfg["vocab_size"]
    inv = lambda m: 1.0 / math.sqrt(m)           # noqa: E731
    s = ("layers", "ssm")
    out = [
        (("embed",), (v, d), "bfloat16", {"std": 1.0}),
        (("final_norm",), (d,), "bfloat16", {"mean": 1.0, "std": 0.1}),
        (("layers", "norm1"), (L, d), "bfloat16", {"mean": 1.0, "std": 0.1}),
        (s + ("w_in",), (L, d, 2 * di), "bfloat16", {"std": inv(d)}),
        (s + ("conv_w",), (L, k, di), "bfloat16", {"std": inv(k)}),
        (s + ("conv_b",), (L, di), "bfloat16", {"std": 0.1}),
        (s + ("w_x",), (L, di, r + 2 * n), "bfloat16", {"std": inv(di)}),
        (s + ("w_dt",), (L, r, di), "bfloat16", {"std": inv(r)}),
        (s + ("dt_bias",), (L, di), "float32", {"dt_bias": [1e-3, 1e-1]}),
        (s + ("a_log",), (L, di, n), "float32", {"log_arange": n}),
        (s + ("d_skip",), (L, di), "float32", {"mean": 1.0, "std": 0.1}),
        (s + ("w_out",), (L, di, d), "bfloat16", {"std": inv(di)}),
    ]
    if not cfg.get("tie_embeddings", False):
        out.append((("lm_head",), (d, v), "bfloat16", {"std": inv(d)}))
    return out


def _conv(x, w, b):
    """Causal depthwise conv of x (T, Di) by w (k, Di), plus b."""
    k = w.shape[0]
    xp = torch.cat([x.new_zeros((k - 1, x.shape[1])), x])
    return sum(xp[j:j + x.shape[0]] * w[j] for j in range(k)) + b


def _scan(xc, dt, a, bm, cm):
    """xc, dt (S, T, Di); a (Di, n); bm, cm (S, T, n) -> y (S, T, Di) of
    the recurrence from a zero state, one step at a time."""
    ns, t, di = xc.shape
    h = xc.new_zeros((ns, di, a.shape[1]))
    y = torch.empty_like(xc)
    for lo in range(0, t, SCAN_BLOCK):
        sl = slice(lo, min(t, lo + SCAN_BLOCK))
        da = torch.exp(dt[:, sl, :, None] * a)               # (S, c, Di, n)
        bx = (dt[:, sl] * xc[:, sl])[..., None] * bm[:, sl, None, :]
        states = torch.empty((da.shape[1],) + h.shape, device=xc.device)
        for j in range(da.shape[1]):
            h = torch.addcmul(bx[:, j], da[:, j], h, out=states[j])
        y[:, sl] = torch.einsum("csdn,scn->scd", states, cm[:, sl])
    return y


def _layer(cfg, lp, xs, mm):
    d, di, r, n, k = _dims(cfg)
    eps = cfg.get("norm_eps", 1e-5)
    parts = []
    for x in xs:
        xz = mm(ops.rms_norm(x, lp["norm1"], eps), lp["w_in"])
        xi, z = xz[:, :di], xz[:, di:]
        xc = F.silu(_conv(xi, lp["conv_w"], lp["conv_b"]))
        dbl = mm(xc, lp["w_x"])
        dt = F.softplus(mm(dbl[:, :r], lp["w_dt"]) + lp["dt_bias"])
        parts.append((xc, z, dt, dbl[:, r:r + n], dbl[:, r + n:]))
    t = max(x.shape[0] for x in xs)
    pad = lambda m: torch.stack([F.pad(p, (0, 0, 0, t - p.shape[0]))  # noqa
                                 for p in m])
    xc, dt, bm, cm = (pad([p[i] for p in parts]) for i in (0, 2, 3, 4))
    y = _scan(xc, dt, -torch.exp(lp["a_log"]), bm, cm) + xc * lp["d_skip"]
    out = []
    for i, (x, (_, z, _, _, _)) in enumerate(zip(xs, parts)):
        yi = y[i, :x.shape[0]] * F.silu(z)
        out.append(x + mm(yi, lp["w_out"]))
    return out


def logits(cfg: dict, params: dict, seqs, wanted, mm=ops.exact):
    """fp32 logits (len(w), vocab) at positions `w` of each sequence."""
    xs = [params["embed"][s].float() for s in seqs]
    layers = params["layers"]
    for i in range(cfg["num_layers"]):
        lp = {k: w[i].float() for k, w in layers["ssm"].items()}
        lp["norm1"] = layers["norm1"][i].float()
        xs = _layer(cfg, lp, xs, mm)
        del lp
    head = (params["embed"].T if cfg.get("tie_embeddings", False)
            else params["lm_head"]).float()
    fn = params["final_norm"].float()
    return [mm(ops.rms_norm(x[w], fn, cfg.get("norm_eps", 1e-5)), head)
            for x, w in zip(xs, wanted)]
