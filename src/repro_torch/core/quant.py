"""int4 quantization (PyTorch port of ``repro/core/quant.py``): symmetric
signed int4 (q in [-8, 7], scale = amax / 7) and nibble packing.

``torch.round`` rounds half to even, as ``jnp.round`` does, so quantized
values and packed bytes are the JAX package's exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INT4_MIN, INT4_MAX = -8, 7


def _qrange(bits: int) -> Tuple[int, int]:
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def quant_scale(x: torch.Tensor, axis: Optional[int] = None, bits: int = 4,
                eps: float = 1e-8) -> torch.Tensor:
    """Symmetric scale; `axis=None` -> per-tensor, else reduce over `axis`."""
    _, qmax = _qrange(bits)
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(amax, eps) / qmax


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int = 4) -> torch.Tensor:
    qmin, qmax = _qrange(bits)
    return torch.clamp(torch.round(x / scale), qmin, qmax).to(torch.int8)


def pack_int4(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int8 holding int4 values in [-8, 7] into uint8 nibbles along
    `axis` (even length): element 2i in the low nibble, 2i+1 in the high."""
    q = torch.movedim(q, axis, -1)
    assert q.shape[-1] % 2 == 0, q.shape
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = q[..., 1::2].to(torch.int32) & 0xF
    packed = (lo | (hi << 4)).to(torch.uint8)
    return torch.movedim(packed, -1, axis)


def unpack_int4(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_int4: uint8 nibbles -> int8 tensor of int4 values."""
    p = torch.movedim(p, axis, -1)
    lo = (((p & 0xF).to(torch.int8) ^ 8) - 8).to(torch.int8)
    hi = ((((p >> 4) & 0xF).to(torch.int8) ^ 8) - 8).to(torch.int8)
    out = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                p.shape[-1] * 2)
    return torch.movedim(out, -1, axis)
