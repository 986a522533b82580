"""Three-term roofline of one rank's step on an NVIDIA H100, and the least
time of each of the port's kernels.

The port of ``repro/roofline/analysis.py``:

  compute    = FLOPs_per_rank / PEAK_FLOPS
  memory     = bytes_per_rank / HBM_BW
  collective = collective_bytes_per_rank / LINK_BW

The counts come from ``roofline.op_cost`` (the eager ops of one step run
on fake tensors), where the reference reads the compiled HLO.  Each term
assumes its resource runs at its peak the whole time and the three
overlap perfectly, so the roofline time is a lower bound on a measured
step.

The hardware model is one H100 SXM5 (NVIDIA H100 Tensor Core GPU
datasheet, SXM5 column; dense rates, no sparsity, at the 700 W limit).
The link term is NVLink 4 inside one 8-GPU node.  A mesh larger than one
node crosses the network between nodes at much less than NVLink (one
400 Gb/s NIC a GPU is 50 GB/s); that fourth term is not modelled, as the
reference has none.

The per-kernel bounds below (``kmeans_bound``, ``attention_bound``,
``flash_bound``, ``scan_bound``) are the least time of one call: its
inputs read once and outputs written once at HBM_BW, against its
operations at the peak of their type.  ``chip_smoke.py`` holds each
kernel's measured time against them, and ``op_cost`` charges a planned
kernel call with the same FLOPs and bytes (``*_cost``).

Two model-FLOP counts: ``model_flops_estimate`` is the reference's
6 * N_active * tokens (train; 2 * N_active * tokens to serve), the
dry-run's useful-FLOP floor; ``train_flops`` adds causal attention to
6 * N per token, the share of peak that ``chip_smoke.py`` reports for a
measured training step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
PEAK_FP32_FLOPS = 67e12       # fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12    # HBM3 bytes/s
# the SFUs' exp rate: 16 per clock per SM, 132 SMs at the 1.98 GHz boost
PEAK_EXP_PER_S = 16 * 132 * 1.98e9
LINK_BW = 450e9               # NVLink 4, bytes/s each way (900 GB/s both)
# torch.cuda.get_device_properties(0).total_memory of an H100 80GB HBM3
# (chip_smoke.py's dry-run phase checks it on the card)
HBM_PER_CHIP = 85_017_493_504

# the roofline's names (the reference's): the models run bf16
PEAK_FLOPS = PEAK_BF16_FLOPS
HBM_BW = PEAK_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_kind: Dict[str, float]
    peak_mem_bytes: float
    arg_bytes: float
    model_flops: float            # 6*N*D (global, analytic)
    hlo_flops_global: float       # the counted FLOPs of every rank
    extras: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """compute-term / max-term: 1.0 = perfectly compute-bound."""
        t = self.roofline_time
        return self.t_compute / t if t > 0 else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        return (self.model_flops / self.hlo_flops_global
                if self.hlo_flops_global else 0.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 roofline_time=self.roofline_time,
                 roofline_fraction=self.roofline_fraction,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def analyze(cost, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, peak_mem_bytes: float,
            arg_bytes: float) -> Roofline:
    """The roofline of one rank's ``op_cost.Cost``."""
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=cost.flops, bytes_per_device=cost.hbm_bytes,
        coll_bytes_per_device=cost.coll_bytes,
        coll_by_kind=dict(cost.coll_by_kind),
        peak_mem_bytes=peak_mem_bytes, arg_bytes=arg_bytes,
        model_flops=model_flops, hlo_flops_global=cost.flops * chips)
    r.extras = {
        "top_opcode_bytes": dict(sorted(cost.by_opcode_bytes.items(),
                                        key=lambda kv: -kv[1])[:10]),
        "num_collectives": cost.coll_count,
        "kernel_calls": dict(cost.kernel_calls),
    }
    return r


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D with N = active params (MoE) — the 'useful' flop floor."""
    n = cfg.num_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per row


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N per token (forward 2N, backward
    4N; N all parameters, the tied head counted once) plus causal
    attention, 6 * layers * heads * head_dim * S per token (QK^T and P.V,
    2 * 2 * S * heads * head_dim per token forward over the S/2 keys a
    causal row sees on average, times 3 for the backward)."""
    n = cfg.num_params()
    attn = (6 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim
            * seq)
    return (6 * n + attn) * tokens


# ---------------------------------------------------------------------------
# the kernels: (FLOPs, bytes, peak FLOP/s) of one call, and its least time
# ---------------------------------------------------------------------------

def _bound(flops: float, nbytes: float, peak: float):
    """The larger of the operations' and the bytes' time (s), and which."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kmeans_cost(n: int, k: int, d: int, esize: int):
    """2NKD fp32 FLOP for the distances; the points and centroids read
    once, the sums, counts and SSE written once."""
    flops = 2.0 * n * k * d
    nbytes = (n * d + k * d) * esize + (k * d + k + 1) * 4
    return flops, nbytes, PEAK_FP32_FLOPS


def kmeans_bound(n: int, k: int, d: int, esize: int):
    """Least time for kmeans_assign (s) and what bounds it."""
    return _bound(*kmeans_cost(n, k, d, esize))


def attention_cost(b: int, sc: int, nq: int, nkv: int, h: int, esize: int,
                   valid: int):
    """Decode attention: the K and V rows of the `valid` slots read once
    (no kernel needs an empty slot's row), cache_pos and positions read
    once, q read and the output written once; 4*H fp32 FLOP per valid
    slot and query head (the two products)."""
    nbytes = (2 * valid * nkv * h * esize + 2 * b * nq * h * esize
              + 4 * b * sc + 4 * b)
    flops = 4.0 * valid * (nq // nkv) * h
    return flops, nbytes, PEAK_FP32_FLOPS


def attention_bound(b: int, sc: int, nq: int, nkv: int, h: int, esize: int,
                    valid: int):
    """Least time for decode attention (s) and what bounds it.  With
    valid = b*sc it counts every row, empty slots too."""
    return _bound(*attention_cost(b, sc, nq, nkv, h, esize, valid))


def flash_cost(b, sq, skv, nq, nkv, h, esize, causal, window):
    """Flash attention: 4*H FLOP per valid (q, kv) pair and query head
    against the tensor-core peak of the input type (bf16; fp32 runs
    outside the tensor cores, at the fp32 peak), and q, k, v read and the
    output written once.  -> (FLOPs, bytes, peak, valid pairs)"""
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    flops = 4.0 * b * nq * h * pairs
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_FP32_FLOPS
    nbytes = (2 * b * sq * nq * h + 2 * b * skv * nkv * h) * esize
    return flops, nbytes, peak, pairs


def flash_bound(b, sq, skv, nq, nkv, h, esize, causal, window):
    """Least time for flash attention (s), what bounds it and the valid
    (q, kv) pairs."""
    flops, nbytes, peak, pairs = flash_cost(b, sq, skv, nq, nkv, h, esize,
                                            causal, window)
    return _bound(flops, nbytes, peak) + (pairs,)


def scan_cost(b, s, di, n, esize):
    """The selective scan: x, B, C read and y written in the input type,
    dt read and h_end written in fp32, once each; 7 fp32 operations per
    (b, t, d, n) (the exp counted as one) at the fp32 peak."""
    nbytes = (2 * b * s * di + 2 * b * s * n) * esize + (b * s * di
                                                         + b * di * n) * 4
    flops = 7.0 * b * s * di * n
    return flops, nbytes, PEAK_FP32_FLOPS


def scan_bound(b, s, di, n, esize):
    """Least time for the selective scan (s) and what bounds it."""
    return _bound(*scan_cost(b, s, di, n, esize))
