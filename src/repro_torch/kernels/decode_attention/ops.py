"""Dispatch for decode attention: the CUDA kernel or its plain version.

``impl="auto"`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (decode_attention.py), a CPU tensor runs the plain
PyTorch version (ref.py).  ``impl="cuda"`` on a CPU tensor raises.  There
is no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.decode_attention import \
    decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

IMPLS = ("auto", "cuda", "ref")


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, cache_pos: torch.Tensor,
                        positions: torch.Tensor, *, window: int = 0,
                        impl: str = "auto") -> torch.Tensor:
    """q (B,Nq,H); k/v_cache (B,Sc,Nkv,H); cache_pos (B,Sc); positions (B,)
    -> (B,Nq,H).

    impl: auto | cuda | ref"""
    if impl not in IMPLS:
        raise ValueError(f"decode_attention_op: impl must be one of "
                         f"{IMPLS}, got {impl!r}")
    if impl == "auto":
        kind = q.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"decode_attention_op: no implementation for "
                             f"device {q.device}")
        impl = "cuda" if kind == "cuda" else "ref"
    if impl == "ref":
        return decode_attention_ref(q, k_cache, v_cache, cache_pos,
                                    positions, window=window)
    return decode_attention(q, k_cache, v_cache, cache_pos, positions,
                            window=window)
