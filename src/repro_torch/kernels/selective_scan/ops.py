"""Dispatch for the selective scan: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (selective_scan.py), a CPU tensor runs the plain
PyTorch version (ref.py).  ``impl="cuda"`` on a CPU tensor raises.  There
is no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan.selective_scan import selective_scan

IMPLS = ("auto", "cuda", "ref")


def selective_scan_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                      d_skip: torch.Tensor,
                      h0: Optional[torch.Tensor] = None, *,
                      impl: str = "auto"):
    """x, dt (B,S,Di); a (Di,N); b_ssm, c_ssm (B,S,N); d_skip (Di,);
    h0 (B,Di,N) or None -> (y (B,S,Di), h_end (B,Di,N) fp32).

    impl: auto | cuda | ref"""
    if impl not in IMPLS:
        raise ValueError(f"selective_scan_op: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    if impl == "auto":
        kind = x.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"selective_scan_op: no implementation for "
                             f"device {x.device}")
        impl = "cuda" if kind == "cuda" else "ref"
    if impl == "ref":
        return selective_scan_ref(x, dt, a, b_ssm, c_ssm, d_skip, h0)
    return selective_scan(x, dt, a, b_ssm, c_ssm, d_skip, h0)
