#!/usr/bin/env python3
"""Where the bf16 flash_attention kernel and the transcription of its
rounding part ways, on an NVIDIA card.

    PYTHONPATH=src python3 tools/flash_rounding_check.py

For each shape and seed it runs the tensor-core kernel and
``tests/test_torch_flash_attention.py::_rounded_p_attention`` (the plain
attention rounded as the kernel rounds it) on the same inputs, and prints
the largest error over the card test's strict limit (2 bf16 ulps of the
output + 1e-3), how many outputs pass that limit and where, and both
results' largest error against the fp32 plain version.  A diagnostic: it
asserts nothing.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "src"))

import test_torch_flash_attention as T  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_op  # noqa: E402

SHAPES = [((8, 640, 16, 8, 128), 8), ((8, 640, 16, 8, 128), 3),
          ((8, 640, 16, 8, 128), 5), ((2, 640, 16, 8, 128), 8),
          ((8, 640, 16, 8, 64), 8), ((2, 384, 36, 4, 128), 8),
          ((8, 384, 36, 4, 128), 8), ((1, 4608, 48, 8, 128), 8)]

for shape, seed in SHAPES:
    args = T._inputs(*shape, seed=seed)
    qd, kd, vd = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                  for x in args)
    got = flash_attention_op(qd, kd, vd, causal=True, window=0, impl="cuda")
    close = T._rounded_p_attention(qd, kd, vd, causal=True,
                                   window=0).float()
    err = (got.float() - close).abs()
    limit = T.TC_ULPS * T._bf16_ulp(close) + T.TC_ATOL
    ratio = err / limit
    bad = (ratio > 1).nonzero()
    print(shape, "seed", seed, "max ratio", round(float(ratio.max()), 3),
          "n>1", len(bad), "max err", float(err.max()), "elements",
          err.numel(), "first bad (b,i,h,d):", bad[:6].tolist(),
          "|close| there",
          [round(float(close[tuple(x)]), 4) for x in bad[:6].tolist()],
          flush=True)
    want = T.flash_attention_ref(*(t.float() for t in (qd, kd, vd)),
                                 causal=True, window=0)
    print("   vs fp32: kernel", float((got.float() - want).abs().max()),
          "rounded plain", float((close - want).abs().max()), flush=True)
