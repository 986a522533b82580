"""Plain PyTorch version of single-token decode attention against a
positional KV cache (the layout of ``repro_torch.models.attention.
gqa_decode``); a transcription of ``repro/kernels/decode_attention/ref.py``.

Scores and softmax in fp32, output cast to q's dtype.  A row with no
valid slot gets the softmax of an all-``NEG_INF`` row, i.e. the mean of v
(the kernel writes 0 there; the serving path never meets such a row)."""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_pos: torch.Tensor,
                         positions: torch.Tensor,
                         window: int = 0) -> torch.Tensor:
    """q (B,Nq,H); k/v_cache (B,Sc,Nkv,H); cache_pos (B,Sc) int32 (absolute
    position stored in each slot, -1 = empty); positions (B,) current pos.
    Returns (B,Nq,H)."""
    b, nq, h = q.shape
    nkv = k_cache.shape[2]
    g = nq // nkv
    qg = q.reshape(b, nkv, g, h)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) * (h ** -0.5)
    rel = positions[:, None] - cache_pos                      # (B,Sc)
    valid = (cache_pos >= 0) & (rel >= 0)
    if window:
        valid &= rel < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, nq, h).to(q.dtype)
