"""Reference tables of the port's kernels (PyTorch port of the table part
of ``repro/kernels/ref.py``)."""

from __future__ import annotations

import torch

from .packing import nibble_product_tables


def make_product_lut() -> torch.Tensor:
    """256-entry signed-int4 product table, int8 on the CPU:
    ``LUT[(a & 0xF) << 4 | (b & 0xF)] = a * b``.  A view of the GEMM tables:
    for a byte below 16 the high nibble is zero, so ``t_lo[:, :16]`` holds
    exactly sext4(a) * sext4(b)."""
    t_lo, _ = nibble_product_tables()
    return t_lo[:, :16].contiguous().reshape(256)
