"""The references' shared math, fp32: RMSNorm, RoPE, GELU, the products.

`exact` is the fp32 product (TF32 off: `fp32_only` sets the flags).
`fp8` is the control's product: both operands rounded to float8 e4m3,
each row of the activations and each column of the weights scaled to the
format's largest value (448) first, then multiplied in fp32.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def fp32_only() -> None:
    """fp32 products stay fp32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = FP8_MAX / t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(x, -1) @ _fp8(w, 0)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (T, heads, hd) at positions 0..T-1: each
    dimension i of the first half turns with dimension i of the second
    half by position * theta**(-2i/hd)."""
    t, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))
