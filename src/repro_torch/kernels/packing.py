"""Nibble pack/unpack for the int4 GEMM kernel (PyTorch port of
``repro/kernels/packing.py``).

Two storage layouts for int4 tensors (two values per uint8 byte):

  * interleaved N-packed (``core.quant.pack_int4``): adjacent *columns*
    share a byte.  The serialization format (``plan_pack_tree`` weights).
  * planar K-major (``pack_kmajor``): contraction rows ``k`` and
    ``k + K/2`` share a byte, low nibble and high nibble.  The CUDA kernel
    (``csrc/int4_matmul.cu``) expands a tile of these bytes into two int8
    planes with a shift and a mask.

Both layouts are byte for byte those of the JAX package, so packed weights
are the same bytes in both.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pad_to(x: torch.Tensor, mult: int, axis: int, value=0) -> torch.Tensor:
    """Pad `axis` of x with `value` up to the next multiple of `mult`."""
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    filler = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, filler], dim=axis)


def sign_extend_nibble(n: torch.Tensor) -> torch.Tensor:
    """Low nibble (two's complement, in [0, 16)) -> int8 in [-8, 7]."""
    return ((n.to(torch.int8) ^ 8) - 8).to(torch.int8)


def unpack_nibbles(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 -> (lo, hi) sign-extended int8, each the same shape as `p`."""
    return sign_extend_nibble(p & 0xF), sign_extend_nibble((p >> 4) & 0xF)


def unpack_interleaved(p: torch.Tensor) -> torch.Tensor:
    """Interleaved N-packed [..., K, N//2] uint8 -> [..., K, N] int8."""
    lo, hi = unpack_nibbles(p)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def pack_kmajor(q: torch.Tensor, row_mult: int = 2) -> torch.Tensor:
    """[..., K, N] int8 (int4 values) -> [..., K'/2, N] uint8, planar
    (K' = K rounded up to a multiple of `row_mult`, at least even).

    Row r of the packed array holds original row r in its low nibble and
    row r + K'/2 in its high nibble; padding rows are zero int4 values."""
    q = pad_to(q, max(2, row_mult), -2)
    half = q.shape[-2] // 2
    lo = q[..., :half, :].to(torch.int32) & 0xF
    hi = q[..., half:, :].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_kmajor(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_kmajor: [..., K/2, N] uint8 -> [..., K, N] int8."""
    lo, hi = unpack_nibbles(p)
    return torch.cat([lo, hi], dim=-2)


def nmajor_to_kmajor(w_packed: torch.Tensor, row_mult: int = 2) -> torch.Tensor:
    """Serialized interleaved [..., K, N//2] -> kernel planar [..., K'/2, N]."""
    return pack_kmajor(unpack_interleaved(w_packed), row_mult)
