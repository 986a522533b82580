"""The yardstick's arithmetic, frozen: the H100's peaks, each kernel's
operations and bytes per call, and the useful model FLOPs of served tokens.

The peaks and the three kernels' costs are a copy of
``src/repro_torch/roofline/analysis.py`` as it stood when the benchmark
was written (``PEAK_BF16_FLOPS`` ... ``scan_cost``, ``_bound``), kept here
so that a later change to the program cannot move the yardstick.  The
model FLOPs are counted here from a configuration's shapes alone: 2 FLOP
per parameter of the layers (neither the embedding nor the head) per
token, causal attention per context, and the head at each sampled
position only.  They are the same whatever implements them.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOPS = 989e12      # bf16 tensor-core FLOP/s
PEAK_FP32_FLOPS = 67e12       # fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12    # HBM3 bytes/s


def bound(flops: float, nbytes: float, peak: float):
    """The larger of the operations' and the bytes' time (s), and which."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_cost(b: int, sc: int, nq: int, nkv: int, h: int, esize: int,
                   valid: int):
    """Decode attention: the K and V rows of the `valid` slots read once,
    cache_pos and positions read once, q read and the output written
    once; 4*H fp32 FLOP per valid slot and query head."""
    nbytes = (2 * valid * nkv * h * esize + 2 * b * nq * h * esize
              + 4 * b * sc + 4 * b)
    flops = 4.0 * valid * (nq // nkv) * h
    return flops, nbytes, PEAK_FP32_FLOPS


def causal_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a causal or sliding-window attention of
    `sq` queries over `skv` keys computes (query i at position i)."""
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_cost(b, sq, skv, nq, nkv, h, esize, causal, window):
    """Flash attention: 4*H FLOP per valid (q, kv) pair and query head
    against the tensor-core peak of bf16 (fp32 at the fp32 peak), q, k, v
    read and the output written once.  -> (FLOPs, bytes, peak, pairs)"""
    pairs = causal_pairs(sq, skv, causal, window)
    flops = 4.0 * b * nq * h * pairs
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_FP32_FLOPS
    nbytes = (2 * b * sq * nq * h + 2 * b * skv * nkv * h) * esize
    return flops, nbytes, peak, pairs


def scan_cost(b, s, di, n, esize):
    """The selective scan: x, B, C read and y written in the input type,
    dt read and h_end written in fp32, once each; 7 fp32 operations per
    (b, t, d, n) at the fp32 peak."""
    nbytes = (2 * b * s * di + 2 * b * s * n) * esize + (b * s * di
                                                         + b * di * n) * 4
    flops = 7.0 * b * s * di * n
    return flops, nbytes, PEAK_FP32_FLOPS


# ---------------------------------------------------------------------------
# useful model FLOPs, from a configuration file's sizes
# ---------------------------------------------------------------------------

def layer_params(cfg: dict) -> int:
    """Parameters of one decoder layer (its norm included)."""
    d = cfg["d_model"]
    n = d                                                   # the layer norm
    if cfg.get("attention", "gqa") == "gqa":
        nq, nkv = cfg["num_heads"], cfg["num_kv_heads"]
        h = cfg.get("head_dim") or d // nq
        n += 2 * d * nq * h + 2 * d * nkv * h
    ssm = cfg.get("ssm")
    if ssm:
        di = ssm["expand"] * d
        r = ssm.get("dt_rank") or -(-d // 16)
        s = ssm["state_dim"]
        n += (2 * d * di + ssm["conv_kernel"] * di + di + di * (r + 2 * s)
              + r * di + di + di * s + di + di * d)
    if cfg.get("d_ff"):
        mats = 3 if cfg.get("ffn_act", "swiglu") == "swiglu" else 2
        n += d + mats * d * cfg["d_ff"]                     # norm + FFN
    return n


def attention_flops_per_pair(cfg: dict) -> float:
    """FLOP of one (query, key) pair over all layers: QK^T and P.V, 2*H
    each, for every query head."""
    if cfg.get("attention", "gqa") != "gqa":
        return 0.0
    h = cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]
    return 4.0 * cfg["num_heads"] * h * cfg["num_layers"]


def head_flops(cfg: dict) -> float:
    """FLOP of the head at one sampled position."""
    return 2.0 * cfg["d_model"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, rows: int, s: int) -> float:
    """A prefill of `rows` prompts of `s` tokens: every token through the
    layers, causal attention over the prompt, the head at its last
    position."""
    w = cfg.get("sliding_window", 0)
    pairs = causal_pairs(s, s, True, w)
    return rows * (2.0 * cfg["num_layers"] * layer_params(cfg) * s
                   + attention_flops_per_pair(cfg) * pairs + head_flops(cfg))


def decode_flops(cfg: dict, positions) -> float:
    """One decode step of the rows at `positions` (each row attends to
    position + 1 keys, fewer under a window)."""
    w = cfg.get("sliding_window", 0)
    keys = np.asarray(positions, dtype=np.int64) + 1
    if w:
        keys = np.minimum(keys, w)
    return (len(keys) * (2.0 * cfg["num_layers"] * layer_params(cfg)
                         + head_flops(cfg))
            + attention_flops_per_pair(cfg) * float(keys.sum()))
