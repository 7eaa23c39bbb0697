"""LR schedules (PyTorch port of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to `peak_lr` over `warmup_steps`, then a cosine decay
    to ``final_frac * peak_lr`` at `total_steps`; a float32 scalar on
    `step`'s device, computed op for op as the JAX package does."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
