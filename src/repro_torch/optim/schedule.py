"""LR schedules (cosine with linear warmup), port of
``repro.optim.schedule``: float32 arithmetic in the JAX function's
order, on the step tensor's device."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step: torch.Tensor, *, peak_lr: float, warmup: int,
                  total: int, floor: float = 0.1) -> torch.Tensor:
    """``step`` an integer tensor → the learning rate, float32."""
    s = step.to(torch.float32)
    warm = peak_lr * s / max(1, warmup)
    t = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
