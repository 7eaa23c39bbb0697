"""Shared model components: RMS norm, rotary (RoPE, M-RoPE) and sinusoidal
position embeddings, initializer (PyTorch port of
``repro/models/common.py``), and the activations as XLA evaluates the JAX
package's ``jax.nn.gelu`` and ``jax.nn.silu``: op by op, each op rounding
to the activation dtype (a fused PyTorch activation rounds once, and in
bf16 that one-step difference can move a whole row's int4 scale in the
next projection)."""

from __future__ import annotations

import functools
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: x [B, S, H, hd], positions [3, B, S] (the
    temporal, height and width streams); the hd/2 rotary frequency slots
    split into ``sections`` (summing to hd/2), section s driven by stream
    s.  The op order is the JAX package's: each section's f32 angle, the
    angles joined, cos/sin, then the split halves; with three equal
    streams it is `apply_rope` bit for bit."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)             # [hd/2]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"hd/2 = {hd // 2}")
    parts, start = [], 0
    for s, sec in enumerate(sections):
        parts.append(positions[s][..., None].to(torch.float32)
                     * freqs[start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                             # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_embed(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Non-learned absolute positional embedding [B, S, d_model] f32 (the
    JAX package adds it to the embeddings of every ``rope="none"`` stack)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs       # [B, S, half]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (JAX rounds a Python scalar to the array's
    dtype before the op; PyTorch would apply it at float32 precision), as
    a Python float: a scalar operand, so nothing is copied to the device
    (which a CUDA graph capture refuses)."""
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default):
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))``, op by op in
    x's dtype."""
    inner = _rounded(math.sqrt(2 / math.pi), x.dtype) * (
        x + _rounded(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x) with logistic = 1 / (1 + exp(-x)),
    op by op in x's dtype."""
    return x * (1.0 / (1.0 + torch.exp(-x)))
