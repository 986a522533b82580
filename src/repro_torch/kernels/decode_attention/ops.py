"""Dispatch for decode attention: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (decode_attention.py), a CPU tensor runs the plain
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
from repro_torch.kernels.decode_attention.decode_attention import \
    decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.roofline.analysis import attention_cost
from repro_torch.roofline.op_cost import record_kernel

IMPLS = ("auto", "cuda", "ref")


def _planned(q, k_cache):
    """An empty output, and the kernel's work charged to the counter:
    every slot of the cache, since a plan cannot read which are valid."""
    b, nq, h = q.shape
    _, sc, nkv, _ = k_cache.shape
    flops, nbytes, _ = attention_cost(b, sc, nq, nkv, h,
                                      k_cache.element_size(), b * sc)
    record_kernel("decode_attention", flops, nbytes)
    return torch.empty_like(q)


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, cache_pos: torch.Tensor,
                        positions: torch.Tensor, *, window: int = 0,
                        impl: str = "auto") -> torch.Tensor:
    """q (B,Nq,H); k/v_cache (B,Sc,Nkv,H); cache_pos (B,Sc); positions (B,)
    -> (B,Nq,H).

    impl: auto | cuda | ref"""
    refuse_autograd("decode_attention_op", q, k_cache, v_cache, cache_pos,
                    positions)
    if impl not in IMPLS:
        raise ValueError(f"decode_attention_op: impl must be one of "
                         f"{IMPLS}, got {impl!r}")
    if impl == "auto":
        kind = q.device.type
        if kind == "cuda":
            impl = "cuda"
        elif is_abstract(q):
            return _planned(q, k_cache)
        elif kind == "cpu":
            impl = "ref"
        else:
            raise ValueError(f"decode_attention_op: no implementation for "
                             f"device {q.device}")
    if impl == "ref":
        return decode_attention_ref(q, k_cache, v_cache, cache_pos,
                                    positions, window=window)
    return decode_attention(q, k_cache, v_cache, cache_pos, positions,
                            window=window)
