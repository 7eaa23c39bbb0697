"""int4 quantization (PyTorch port of ``repro/core/quant.py``): symmetric
signed int4 (q in [-8, 7], scale = amax / 7) per tensor, channel or group,
straight-through fake-quant, and nibble packing.

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
    """Symmetric scale; `axis=None` -> per-tensor, else reduce over `axis`.

    The divisor is a 0-dim tensor on x's device: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which can round one ulp
    away from the quotient; a tensor divisor divides with IEEE rounding on
    every device, so the card's scales are the CPU's and the JAX
    package's."""
    _, qmax = _qrange(bits)
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    amax = torch.clamp_min(amax, eps)
    return amax / amax.new_full((), qmax)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int = 4) -> torch.Tensor:
    qmin, qmax = _qrange(bits)
    return torch.clamp(torch.round(x / scale), qmin, qmax).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def fake_quant(x: torch.Tensor, axis: Optional[int] = None,
               bits: int = 4) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT).  The
    scale and grid math runs in f32; the result keeps x's dtype."""
    x32 = x.to(torch.float32)
    scale = quant_scale(x32, axis=axis, bits=bits)
    xq = dequantize(quantize(x32, scale, bits=bits), scale).to(x.dtype)
    return x + (xq - x).detach()


def group_quantize(w: torch.Tensor, group_size: int, bits: int = 4
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group quantization along the first (reduction) axis of w [K, N]:
    (q [K, N] int8 of int4 values, scales [K//G, 1, N]); a group size of 0
    or >= K gives per-output-channel scales [1, N]."""
    K, N = w.shape
    if group_size <= 0 or group_size >= K:
        scale = quant_scale(w, axis=0, bits=bits)
        return quantize(w, scale, bits=bits), scale
    assert K % group_size == 0, (K, group_size)
    wg = w.reshape(K // group_size, group_size, N)
    scale = quant_scale(wg, axis=1, bits=bits)
    return quantize(wg, scale, bits=bits).reshape(K, N), scale


def group_dequantize(q: torch.Tensor, scale: torch.Tensor,
                     group_size: int) -> torch.Tensor:
    K, N = q.shape
    if scale.ndim == 2:                                    # per-channel
        return dequantize(q, scale)
    qg = q.reshape(K // group_size, group_size, N)
    return dequantize(qg, scale).reshape(K, N)


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
    """Inverse of pack_int4: uint8 nibbles -> int8 tensor of int4 values.
    Each nibble is sign-extended by an arithmetic right shift of the byte
    read as int8 (the low one first shifted to the top), three elementwise
    passes where masking and ``(n ^ 8) - 8`` take ten."""
    p = torch.movedim(p, axis, -1)
    lo = (p << 4).view(torch.int8) >> 4
    hi = p.view(torch.int8) >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                p.shape[-1] * 2)
    return torch.movedim(out, -1, axis)


def to_unsigned_mag(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split signed int4 values into (|q| in [0,8] as uint8, sign in {-1,+1}
    as int32).

    |q| <= 8 fits the unsigned 4-bit domain of the paper's multiplier, so the
    netlist computes |a|*|b| exactly and the sign is applied afterwards.
    """
    sign = torch.where(q < 0, -1, 1).to(torch.int32)
    return q.to(torch.int32).abs().to(torch.uint8), sign
