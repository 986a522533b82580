"""Dispatch for the selective scan: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (selective_scan.py), a CPU tensor runs the plain
PyTorch version (ref.py).  ``impl="cuda"`` on a CPU tensor raises.  There
is no fallback from a failed build or launch to the plain version.  A fake
or meta tensor (a plan: ``launch.dryrun``) gets empty outputs of the
kernel's shapes, and the kernel's FLOPs and bytes are charged to the active
``roofline.op_cost.OpCost`` as one op.  The op is forward-only: it raises
on an argument that requires grad while grad mode is on
(``kernels.refuse_autograd``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import is_abstract, refuse_autograd
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan.selective_scan import selective_scan
from repro_torch.roofline.analysis import scan_cost
from repro_torch.roofline.op_cost import record_kernel

IMPLS = ("auto", "cuda", "ref")


def _planned(x, b_ssm):
    """Empty outputs, and the kernel's work charged to the counter."""
    bsz, s, di = x.shape
    n = b_ssm.shape[-1]
    flops, nbytes, _ = scan_cost(bsz, s, di, n, x.element_size())
    record_kernel("selective_scan", flops, nbytes)
    return (torch.empty_like(x),
            x.new_empty((bsz, di, n), dtype=torch.float32))


def selective_scan_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                      d_skip: torch.Tensor,
                      h0: Optional[torch.Tensor] = None, *,
                      impl: str = "auto"):
    """x, dt (B,S,Di); a (Di,N); b_ssm, c_ssm (B,S,N); d_skip (Di,);
    h0 (B,Di,N) or None -> (y (B,S,Di), h_end (B,Di,N) fp32).

    impl: auto | cuda | ref"""
    refuse_autograd("selective_scan_op", x, dt, a, b_ssm, c_ssm, d_skip,
                    h0)
    if impl not in IMPLS:
        raise ValueError(f"selective_scan_op: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    if impl == "auto":
        kind = x.device.type
        if kind == "cuda":
            impl = "cuda"
        elif is_abstract(x):
            return _planned(x, b_ssm)
        elif kind == "cpu":
            impl = "ref"
        else:
            raise ValueError(f"selective_scan_op: no implementation for "
                             f"device {x.device}")
    if impl == "ref":
        return selective_scan_ref(x, dt, a, b_ssm, c_ssm, d_skip, h0)
    return selective_scan(x, dt, a, b_ssm, c_ssm, d_skip, h0)
