"""Plain PyTorch version of the Mamba-1 selective scan; a transcription of
``repro/kernels/selective_scan/ref.py`` (sequential recurrence in fp32,
here a Python loop over the sequence).

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      (B, Di, N)
    y_t = h_t . C_t + D * x_t

y comes back in x's dtype, the final state in fp32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                       d_skip: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B,S,Di); a (Di,N); b_ssm, c_ssm (B,S,N); d_skip (Di,);
    h0 (B,Di,N) or None (zeros).  Returns (y (B,S,Di), h_end (B,Di,N))."""
    bsz, s, di = x.shape
    n = a.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf, af = b_ssm.float(), c_ssm.float(), a.float()
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * af[None])           # (B,Di,N)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * d_skip.float()
    return y.to(x.dtype), h
