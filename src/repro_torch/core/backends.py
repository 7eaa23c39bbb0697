"""Quantized-linear backend registry (PyTorch port of
``repro/core/backends.py``): each backend computes the 2-D GEMM
``fn(w, x2, cfg, tag) -> y2`` for a float master weight; `qdense` owns the
flattening, bias and output cast."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..kernels import ops
from ..kernels.packing import pack_kmajor
from .quant import quant_scale, quantize

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
