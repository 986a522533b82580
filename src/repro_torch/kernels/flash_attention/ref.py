"""Plain PyTorch version of causal / sliding-window GQA self-attention; a
transcription of ``repro/kernels/flash_attention/ref.py``.

Positions are the implicit iota: q row i sits at position i and kv row j
at position j.  Scores, softmax and the P.V product in fp32, the output
cast to q's dtype."""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Sq,Nq,H); k, v (B,Skv,Nkv,H); Nq % Nkv == 0 -> (B,Sq,Nq,H)."""
    b, sq, nq, h = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, sq, nkv, g, h)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (h ** -0.5)
    rel = (torch.arange(sq, device=q.device)[:, None]
           - torch.arange(skv, device=q.device)[None, :])
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rel >= 0
    if window:
        mask &= rel < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, nq, h).to(q.dtype)
