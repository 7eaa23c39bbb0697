"""Table-lookup W4A4 GEMM: the CUDA kernel (``csrc/lut4_matmul.cu``) and
its plain PyTorch version.

Ports ``repro/kernels/lut4_matmul.py::lut4_matmul``, the paper's 4-bit LUT
multiplier tiled across a GEMM: every partial product is read from the
16x256 per-nibble tables (``packing.lut4_tables``), indexed by the
activation's nibble code and the packed planar weight byte, and the reads
are summed in int32.  Operands are those of the unfused W4A4 GEMM: int8
``a_q`` [M, K] of int4 values, f32 ``a_scale`` [M, 1], planar K-major
weights ``[ceil(K/2), N]`` uint8 and f32 ``w_scale`` [1, N].

The exact product table is rank-1 (T[a, w] = a * w), so the lookup-sum is
the integer dot: the plain version is that dot (as
``int4_matmul.int4_matmul_plain``), and the kernel equals it, and the
unfused W4A4 kernel, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .int4_matmul import check_w4a4_operands, int4_matmul_plain
from .packing import lut4_tables


def lut4_matmul_plain(a_q: torch.Tensor, a_scale: torch.Tensor,
                      w_kmajor: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """The exact integer dot and the scale epilogue -> f32 [M, N]."""
    return int4_matmul_plain(a_q, a_scale, w_kmajor, w_scale)


def _bind(lib: ctypes.CDLL) -> None:
    lib.lut4_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.lut4_launch.restype = ctypes.c_int


def lut4_matmul_cuda(a_q: torch.Tensor, a_scale: torch.Tensor,
                     w_kmajor: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the table-lookup kernel on CUDA tensors: a_q [M, K] int8,
    a_scale [M, 1] f32, w_kmajor [ceil(K/2), N] uint8, w_scale [1, N] f32
    -> [M, N] f32."""
    check_w4a4_operands("lut4_matmul_cuda", a_q, torch.int8, w_kmajor,
                        w_scale, a_scale)
    M, K = a_q.shape
    Kh, N = w_kmajor.shape
    out = torch.empty((M, N), dtype=torch.float32, device=a_q.device)
    if M == 0 or N == 0:
        return out
    t_lo, t_hi = lut4_tables(a_q.device)
    lib = _build.load("lut4_matmul", _bind)
    code = lib.lut4_launch(
        _build.ptr(a_q), _build.ptr(a_scale), _build.ptr(w_kmajor),
        _build.ptr(w_scale), _build.ptr(t_lo), _build.ptr(t_hi),
        _build.ptr(out), M, K, N, Kh, _build.stream_of(a_q))
    _build.check(lib, code, "lut4_matmul")
    lut4_matmul_cuda.launches += 1
    return out


lut4_matmul_cuda.launches = 0
