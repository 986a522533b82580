"""Dispatch for flash attention: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (flash_attention.py), a CPU tensor runs the plain
PyTorch version (ref.py).  ``impl="cuda"`` on a CPU tensor raises.  There
is no fallback from a failed build or launch to the plain version.  A fake
or meta tensor (a plan: ``launch.dryrun``) gets empty outputs of the
kernel's shapes, and the kernel's FLOPs and bytes are charged to the active
``roofline.op_cost.OpCost`` as one op.  The op is forward-only: it raises
on an argument that requires grad while grad mode is on
(``kernels.refuse_autograd``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import is_abstract, refuse_autograd
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.roofline.analysis import flash_cost
from repro_torch.roofline.op_cost import record_kernel

IMPLS = ("auto", "cuda", "ref")


def _planned(q, k, v, causal, window):
    """An empty output, and the kernel's work charged to the counter."""
    b, sq, nq, h = q.shape
    flops, nbytes, _, _ = flash_cost(b, sq, k.shape[1], nq, k.shape[2], h,
                                     q.element_size(), causal, window)
    record_kernel("flash_attention", flops, nbytes)
    return torch.empty_like(q)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       impl: str = "auto") -> torch.Tensor:
    """q (B,Sq,Nq,H); k, v (B,Skv,Nkv,H) -> (B,Sq,Nq,H).

    impl: auto | cuda | ref"""
    refuse_autograd("flash_attention_op", q, k, v)
    if impl not in IMPLS:
        raise ValueError(f"flash_attention_op: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    if impl == "auto":
        kind = q.device.type
        if kind == "cuda":
            impl = "cuda"
        elif is_abstract(q):
            return _planned(q, k, v, causal, window)
        elif kind == "cpu":
            impl = "ref"
        else:
            raise ValueError(f"flash_attention_op: no implementation for "
                             f"device {q.device}")
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)
