"""Quantized-linear backend registry (PyTorch port of
``repro/core/backends.py``): each backend computes the 2-D GEMM
``fn(w, x2, cfg, tag) -> y2`` for a float master weight; `qdense` owns the
flattening, bias and output cast.

At 4-bit weights and activations the kernel-backed backends take the kernel
route (``kernels.ops``) on every device: the CUDA kernel for CUDA tensors,
its plain version for CPU tensors.  Every other width takes the JAX
package's XLA route, which it computes outside any Pallas kernel: an exact
integer GEMM (`int_gemm`) for ``int_sim``, ``pallas_int4`` and ``lut4``, a
dequantized float32 GEMM for ``w4a16``.  ``netlist`` is the gate-level
oracle: every 4-bit product through the simulated FPGA circuit."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.packing import pack_kmajor
from .quant import (fake_quant, group_dequantize, group_quantize, quant_scale,
                    quantize, to_unsigned_mag)

BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str):
    """Register ``fn(w, x2, cfg, tag) -> y2`` under ``name``."""
    def deco(fn):
        BACKENDS[name] = fn
        return fn
    return deco


def get_backend(name: str) -> Callable:
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown or not yet ported quant backend {name!r}; registered: "
            f"{sorted(BACKENDS)}") from None


@register_backend("float")
def _float_backend(w, x2, cfg, tag):
    """Plain GEMM in the activation dtype."""
    return torch.matmul(x2, w.to(x2.dtype))


def int_mm_padded(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 a_q [M, K] and w_q [K, N] (integer
    values of up to 8 bits), as the JAX package's ``jnp.dot(...,
    preferred_element_type=int32)``: ``torch._int_mm`` on every device at
    any shape.  On CUDA it wants more than 16 rows and K, N in multiples of
    8, so the operands are padded with zeros to that (exact) and the result
    is cut back to [M, N]."""
    (M, K), N = a_q.shape, w_q.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    a = F.pad(a_q, (0, Kp - K, 0, Mp - M)) if (Mp, Kp) != (M, K) else a_q
    w = F.pad(w_q, (0, Np - N, 0, Kp - K)) if (Kp, Np) != (K, N) else w_q
    return torch._int_mm(a.contiguous(), w.contiguous())[:M, :N]


def int_gemm(xf: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
             a_bits: int) -> torch.Tensor:
    """Per-row activation quantize at `a_bits`, the exact integer GEMM and
    the ``(acc * a_scale) * w_scale`` epilogue: the JAX package's XLA route
    for the widths no kernel serves."""
    a_scale = quant_scale(xf, axis=1, bits=a_bits)       # [M, 1]
    a_q = quantize(xf, a_scale, bits=a_bits)
    return int_mm_padded(a_q, w_q).to(torch.float32) * a_scale * w_scale


def _int4_backend(w, x2, cfg, tag):
    """Integer GEMM from a float master: per-output-channel weight quantize.
    W4A4 packs the weight K-major per call and runs the fused W4A4 GEMM (CUDA
    kernel on CUDA tensors, plain version on CPU tensors); other widths run
    `int_gemm`."""
    xf = x2.to(torch.float32)
    w_scale = quant_scale(w, axis=0, bits=cfg.w_bits)    # [1, N]
    w_q = quantize(w, w_scale, bits=cfg.w_bits)
    if cfg.a_bits == 4 and cfg.w_bits == 4:
        return ops.int4_matmul_fused_kmajor(xf, pack_kmajor(w_q), w_scale)
    return int_gemm(xf, w_q, w_scale, cfg.a_bits)


register_backend("int_sim")(_int4_backend)
register_backend("pallas_int4")(_int4_backend)


@register_backend("fake_quant")
def _fake_quant_backend(w, x2, cfg, tag):
    """QAT: straight-through fake-quant on the weight (per output channel)
    and the activations (per row); float GEMM in the activation dtype."""
    wq = fake_quant(w, axis=0, bits=cfg.w_bits)
    xq = fake_quant(x2, axis=-1, bits=cfg.a_bits)
    return torch.matmul(xq, wq.to(x2.dtype))


@register_backend("lut4")
def _lut4_backend(w, x2, cfg, tag):
    """W4A4 through the table-lookup GEMM: the weight is quantized per
    output channel and packed K-major per call, the activations per row,
    and every product is read from the 4x4-bit product table.  The lookup-sum
    is the integer dot, so this equals ``int_sim`` bit for bit.  Other
    widths have no table kernel and are ``int_sim``'s."""
    if not (cfg.a_bits == 4 and cfg.w_bits == 4):
        return _int4_backend(w, x2, cfg, tag)
    xf = x2.to(torch.float32)
    w_scale = quant_scale(w, axis=0, bits=4)             # [1, N]
    w_q = quantize(w, w_scale, bits=4)
    a_scale = quant_scale(xf, axis=1, bits=4)            # [M, 1]
    a_q = quantize(xf, a_scale, bits=4)
    return ops.lut4_matmul_kmajor(a_q, a_scale, pack_kmajor(w_q), w_scale)


@register_backend("w4a16")
def _w4a16_backend(w, x2, cfg, tag):
    """Weight-only: the weight quantized per group of ``cfg.group_size``
    contraction rows (per output channel when 0 or >= K); the activations
    stay in their dtype.  int4 weights are packed K-major per call for the
    W4A16 GEMM; other widths are dequantized and multiplied in float32."""
    g = cfg.group_size if cfg.group_size else w.shape[0]
    w_q, w_scale = group_quantize(w, g, bits=cfg.w_bits)
    if cfg.w_bits != 4:
        return torch.matmul(x2.to(torch.float32),
                            group_dequantize(w_q, w_scale, g))
    rm = 2 * g if w_scale.ndim == 3 else 2
    return ops.w4a16_matmul_kmajor(x2, pack_kmajor(w_q, rm), w_scale, g)


@register_backend("netlist")
def _netlist_backend(w, x2, cfg, tag):
    """End-to-end oracle: every 4-bit product |a|*|b| through the simulated
    FPGA circuit (the paper's netlist) over the full [M, K, N] broadcast,
    then the signs, an int32 sum over K and ``(acc * a_scale) * w_scale``.
    Materializes the product cube, as the JAX package does.  The circuit
    multiplies 4-bit magnitudes, so it takes 4-bit widths only."""
    from .mult4_proposed import build_proposed_mult4
    from .qlinear import check_int4

    check_int4(cfg, tag)
    nl = build_proposed_mult4()
    xf = x2.to(torch.float32)
    a_scale = quant_scale(xf, axis=1, bits=4)
    a_q = quantize(xf, a_scale, bits=4)                  # [M, K]
    w_scale = quant_scale(w, axis=0, bits=4)
    w_q = quantize(w, w_scale, bits=4)                   # [K, N]
    mag_a, sign_a = to_unsigned_mag(a_q)
    mag_w, sign_w = to_unsigned_mag(w_q)
    prod = nl(mag_a[:, :, None], mag_w[None, :, :]).to(torch.int32)
    prod = prod * sign_a[:, :, None] * sign_w[None, :, :]
    acc = prod.sum(dim=1, dtype=torch.int32).to(torch.float32)
    return acc * a_scale * w_scale
