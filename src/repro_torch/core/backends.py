"""Quantized-linear backend registry (PyTorch port of
``repro/core/backends.py``): each backend computes the 2-D GEMM
``fn(w, x2, cfg, tag) -> y2`` for a float master weight; `qdense` owns the
flattening, bias and output cast.

The kernel-backed backends take the kernel route (``kernels.ops``) on
every device: the CUDA kernel for CUDA tensors, its plain version for CPU
tensors.  ``netlist`` (the gate-level oracle) is not ported and raises."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..kernels import ops
from ..kernels.packing import pack_kmajor
from .quant import fake_quant, group_quantize, quant_scale, quantize

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


def _int4_backend(w, x2, cfg, tag):
    """W4A4 from a float master: per-output-channel weight quantize, packed
    K-major, then the fused W4A4 GEMM (CUDA kernel on CUDA tensors, plain
    version on CPU tensors)."""
    from .qlinear import check_int4

    check_int4(cfg, tag)
    w_scale = quant_scale(w, axis=0, bits=4)             # [1, N]
    w_q = quantize(w, w_scale, bits=4)
    return ops.int4_matmul_fused_kmajor(x2.to(torch.float32),
                                        pack_kmajor(w_q), w_scale)


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
    is the integer dot, so this equals ``int_sim`` bit for bit."""
    from .qlinear import check_int4

    check_int4(cfg, tag)
    xf = x2.to(torch.float32)
    w_scale = quant_scale(w, axis=0, bits=4)             # [1, N]
    w_q = quantize(w, w_scale, bits=4)
    a_scale = quant_scale(xf, axis=1, bits=4)            # [M, 1]
    a_q = quantize(xf, a_scale, bits=4)
    return ops.lut4_matmul_kmajor(a_q, a_scale, pack_kmajor(w_q), w_scale)


@register_backend("w4a16")
def _w4a16_backend(w, x2, cfg, tag):
    """Weight-only int4: the weight quantized per group of
    ``cfg.group_size`` contraction rows (per output channel when 0 or >= K)
    and packed K-major per call; the activations stay in their dtype."""
    if cfg.w_bits != 4:
        raise NotImplementedError(
            f"site {tag!r}: w{cfg.w_bits} weight-only is not ported; only "
            f"the int4 W4A16 GEMM is")
    g = cfg.group_size if cfg.group_size else w.shape[0]
    w_q, w_scale = group_quantize(w, g, bits=4)
    rm = 2 * g if w_scale.ndim == 3 else 2
    return ops.w4a16_matmul_kmajor(x2, pack_kmajor(w_q, rm), w_scale, g)


@register_backend("netlist")
def _netlist_backend(w, x2, cfg, tag):
    raise NotImplementedError(
        f"site {tag!r}: the netlist backend (every product through the "
        f"simulated FPGA circuit) is not ported yet (ROADMAP Queue 1 item "
        f"12)")
