"""Shared model components: RMS norm, rotary embeddings, initializer
(PyTorch port of ``repro/models/common.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(dt)


def normal_init(gen: torch.Generator, shape: Sequence[int],
                fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) f32 on the generator's device (fan_in defaults to
    shape[0])."""
    fan = fan_in if fan_in is not None else shape[0]
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32) * (1.0 / math.sqrt(max(fan, 1)))


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, S, H, hd], positions [B, S] -> rotated x (same dtype)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)             # [hd/2]
    ang = positions[..., None].to(torch.float32) * freqs       # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
