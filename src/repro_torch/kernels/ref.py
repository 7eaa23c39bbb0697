"""Reference tables of the port's kernels (PyTorch port of the table part
of ``repro/kernels/ref.py``)."""

from __future__ import annotations

from typing import Dict

import torch

from .packing import nibble_product_tables


def make_product_lut() -> torch.Tensor:
    """256-entry signed-int4 product table, int8 on the CPU:
    ``LUT[(a & 0xF) << 4 | (b & 0xF)] = a * b``.  A view of the GEMM tables:
    for a byte below 16 the high nibble is zero, so ``t_lo[:, :16]`` holds
    exactly sext4(a) * sext4(b)."""
    t_lo, _ = nibble_product_tables()
    return t_lo[:, :16].contiguous().reshape(256)


_LUT: Dict[torch.device, torch.Tensor] = {}


def product_lut_on(device) -> torch.Tensor:
    """``make_product_lut()`` on `device`, copied there once and kept for
    the life of the process (256 bytes per device): the table the two
    table kernels (``lut_mul4``, ``lut4_matmul``) read."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lut = _LUT.get(dev)
    if lut is None:
        lut = _LUT[dev] = make_product_lut().to(dev)
    return lut
