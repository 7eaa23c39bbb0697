"""W4A4 GEMM with the activation quantize fused in: the CUDA kernel
(``csrc/int4_matmul.cu``) and its plain PyTorch version.

Ports ``repro/kernels/int4_matmul.py::int4_matmul_fused``.  Weights are
planar K-major uint8 ``[ceil(K/2), N]`` (``kernels/packing.py``), scales
``[1, N]`` f32.  The per-row activation scale ``max(|x|, 1e-8) / 7`` is a
reduction computed before the kernel, as in the JAX package; the kernel
quantizes, unpacks, accumulates in int32 and applies
``(acc * a_scale) * w_scale``.

Both versions divide with IEEE round-to-nearest and round half to even, so
on the card they agree bit for bit.  ``kernels.ops`` picks one by the
tensor's device: the plain version for CPU tensors, the kernel for CUDA
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.quant import quant_scale, quantize
from . import _build
from .packing import unpack_kmajor

def int4_matmul_fused_plain(x: torch.Tensor, w_kmajor: torch.Tensor,
                            w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version (the XLA branch of ``ops.int4_matmul_fused_kmajor``):
    quantize rows, unpack the planar weight, integer dot, scale epilogue.

    The dot runs as an f32 matmul of int4 values: every product and partial
    sum is an integer below 2**24 in magnitude (K <= 2**18), so the result
    is the exact int32 dot in any summation order."""
    x32 = x.to(torch.float32)
    a_scale = quant_scale(x32, axis=1, bits=4)
    a_q = quantize(x32, a_scale, bits=4)
    w_q = unpack_kmajor(w_kmajor)[: x.shape[1]]
    acc = torch.matmul(a_q.to(torch.float32), w_q.to(torch.float32))
    return acc * a_scale * w_scale


def _bind(lib: ctypes.CDLL) -> None:
    lib.w4a4_fused_launch.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.w4a4_fused_launch.restype = ctypes.c_int


def int4_matmul_fused_cuda(x: torch.Tensor, w_kmajor: torch.Tensor,
                           w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the W4A4 kernel on CUDA tensors: x [M, K] f32, w_kmajor
    [ceil(K/2), N] uint8, w_scale [1, N] f32 -> [M, N] f32."""
    if not (x.is_cuda and w_kmajor.device == x.device
            and w_scale.device == x.device):
        raise ValueError("int4_matmul_fused_cuda: all operands must be on "
                         "one CUDA device")
    if x.dtype != torch.float32 or w_kmajor.dtype != torch.uint8 \
            or w_scale.dtype != torch.float32:
        raise TypeError(f"int4_matmul_fused_cuda: dtypes {x.dtype}, "
                        f"{w_kmajor.dtype}, {w_scale.dtype}; want f32, "
                        f"uint8, f32")
    if x.ndim != 2 or w_kmajor.ndim != 2:
        raise ValueError(f"int4_matmul_fused_cuda: shapes {tuple(x.shape)}, "
                         f"{tuple(w_kmajor.shape)}")
    M, K = x.shape
    Kh, N = w_kmajor.shape
    if 2 * Kh not in (K, K + 1) or w_scale.numel() != N:
        raise ValueError(f"int4_matmul_fused_cuda: x {tuple(x.shape)} does "
                         f"not match weight {tuple(w_kmajor.shape)} / scale "
                         f"{tuple(w_scale.shape)}")
    if not (x.is_contiguous() and w_kmajor.is_contiguous()
            and w_scale.is_contiguous()):
        raise ValueError("int4_matmul_fused_cuda: operands must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    a_scale = quant_scale(x, axis=1, bits=4)
    lib = _build.load("int4_matmul", _bind)
    code = lib.w4a4_fused_launch(
        _build.ptr(x), _build.ptr(a_scale), _build.ptr(w_kmajor),
        _build.ptr(w_scale), _build.ptr(out), M, K, N, Kh,
        _build.stream_of(x))
    _build.check(lib, code, "int4_matmul_fused")
    int4_matmul_fused_cuda.launches += 1
    return out


int4_matmul_fused_cuda.launches = 0
