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
are the same bytes in both.  The 16x256 per-nibble product tables
(``nibble_product_tables``) index a planar byte directly: they are the
Pallas table-lookup kernel's layout, and the source of the 256-byte truth
table ``ref.make_product_lut``, which the table-lookup GEMM
(``csrc/lut4_matmul.cu``) reads.
"""

from __future__ import annotations

import functools
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


def nmajor_to_kmajor_grouped(w_packed: torch.Tensor, scale: torch.Tensor
                             ) -> torch.Tensor:
    """`nmajor_to_kmajor` with the row multiple a weight's scales need:
    grouped scales [..., K//G, 1, N] (one rank deeper than the packed
    weight) need planar halves that cover whole groups (2G); per-channel
    ones 2."""
    rm = 2
    if scale.ndim == w_packed.ndim + 1:
        rm = 2 * (w_packed.shape[-2] // scale.shape[-3])
    return nmajor_to_kmajor(w_packed, rm)


# ------------------------------------------- per-nibble product tables -----
@functools.lru_cache(maxsize=None)
def nibble_product_tables() -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact 4x4-bit product table tiled for GEMM lookup: ``(t_lo,
    t_hi)``, each [16, 256] int8 on the CPU, with

        t_lo[a, byte] = sext4(a) * sext4(byte & 0xF)
        t_hi[a, byte] = sext4(a) * sext4(byte >> 4)

    Row = the activation's unsigned nibble code, column = a packed planar
    weight byte, so a kernel holding packed weights reads each signed
    product without unpacking.  Products of int4 values fit int8."""
    s = (torch.arange(16, dtype=torch.int32) ^ 8) - 8       # sext4 of 0..15
    byte = torch.arange(256, dtype=torch.int32)
    t_lo = s[:, None] * s[byte & 0xF][None, :]
    t_hi = s[:, None] * s[byte >> 4][None, :]
    return t_lo.to(torch.int8), t_hi.to(torch.int8)


def flatten_to_tiles(x: torch.Tensor, rows_mult: int, cols: int
                     ) -> Tuple[torch.Tensor, int]:
    """Flatten any-shape x into a [rows, cols] grid, rows padded with zeros
    to a multiple of `rows_mult`.  Returns (tiles, n), n the element count;
    undo with ``tiles.reshape(-1)[:n].reshape(shape)``."""
    n = x.numel()
    rows = -(-n // cols)
    rows_padded = -(-rows // rows_mult) * rows_mult
    flat = torch.nn.functional.pad(x.reshape(-1), (0, rows_padded * cols - n))
    return flat.reshape(rows_padded, cols), n
