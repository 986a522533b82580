"""A model's weights from the seed, on the device, in a few large calls.

A family's `layout` lists every weight: its name path, shape, dtype and
draw, ``{"mean", "std"}`` (normal), ``{"dt_bias": [lo, hi]}`` (the
inverse softplus of a step log-uniform in [lo, hi], Mamba's) or
``{"log_arange": n}`` (log 1..n along the last dim, Mamba's A).  The
normal draws of one dtype come from one flat buffer filled by a
``torch.Generator`` on the device, `CHUNK` elements a call, and every
weight is a view of its buffer, scaled in place.  The same seed on the
same device gives the same weights, so the output check draws them again
for the reference instead of keeping a copy beside the program's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

CHUNK = 1 << 28


def _fill_normal(buf: torch.Tensor, gen: torch.Generator) -> None:
    for a in range(0, buf.numel(), CHUNK):
        n = min(CHUNK, buf.numel() - a)
        buf[a:a + n] = torch.randn(n, generator=gen, device=buf.device,
                                   dtype=torch.float32)


def _fill_uniform(buf: torch.Tensor, gen: torch.Generator) -> None:
    for a in range(0, buf.numel(), CHUNK):
        n = min(CHUNK, buf.numel() - a)
        buf[a:a + n] = torch.rand(n, generator=gen, device=buf.device,
                                  dtype=torch.float32)


def make(layout, seed: int, device) -> Dict:
    """The nested dict of weights that `layout` describes."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat: Dict[str, torch.Tensor] = {}
    sizes: Dict[str, int] = {}
    for _, shape, dtype, draw in layout:
        kind = "uniform" if "dt_bias" in draw else (
            "normal" if "std" in draw else None)
        if kind:
            key = f"{kind}.{dtype}"
            sizes[key] = sizes.get(key, 0) + math.prod(shape)
    for key in sorted(sizes):
        kind, dtype = key.split(".")
        flat[key] = torch.empty(sizes[key], dtype=getattr(torch, dtype),
                                device=device)
        (_fill_normal if kind == "normal" else _fill_uniform)(flat[key], gen)
    used = {key: 0 for key in flat}
    out: Dict = {}
    for path, shape, dtype, draw in layout:
        dt = getattr(torch, dtype)
        n = math.prod(shape)
        if "log_arange" in draw:
            t = torch.log(torch.arange(1, draw["log_arange"] + 1,
                                       dtype=torch.float32, device=device))
            t = t.expand(shape).contiguous().to(dt)
        else:
            key = ("uniform." if "dt_bias" in draw else "normal.") + dtype
            t = flat[key][used[key]:used[key] + n].view(shape)
            used[key] += n
            if "dt_bias" in draw:
                lo, hi = draw["dt_bias"]
                step = torch.exp(t * (math.log(hi) - math.log(lo))
                                 + math.log(lo)).clamp(min=1e-4)
                t.copy_(step + torch.log(-torch.expm1(-step)))
            else:
                t.mul_(draw["std"])
                if draw.get("mean"):
                    t.add_(draw["mean"])
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out
