"""Dispatch for flash attention: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (flash_attention.py), a CPU tensor runs the plain
PyTorch version (ref.py).  ``impl="cuda"`` on a CPU tensor raises.  There
is no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

IMPLS = ("auto", "cuda", "ref")


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       impl: str = "auto") -> torch.Tensor:
    """q (B,Sq,Nq,H); k, v (B,Skv,Nkv,H) -> (B,Sq,Nq,H).

    impl: auto | cuda | ref"""
    if impl not in IMPLS:
        raise ValueError(f"flash_attention_op: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    if impl == "auto":
        kind = q.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"flash_attention_op: no implementation for "
                             f"device {q.device}")
        impl = "cuda" if kind == "cuda" else "ref"
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)
