"""LR schedules (pure functions of the step counter).

The port of ``repro/optim/schedules.py``: fp32 arithmetic on a tensor
step, so the rate stays on the step's device."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def warmup_cosine(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.learning_rate`` over ``cfg.warmup_steps``,
    then a cosine decay to 0 at ``cfg.total_steps``; fp32, on step's
    device."""
    step = step.float()
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.learning_rate * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)
