"""W4A16 GEMM (weight-only int4): the CUDA kernel (``csrc/w4a16_matmul.cu``)
and its plain PyTorch version.

Ports ``repro/kernels/w4a16_matmul.py::w4a16_matmul``.  Activations are
bf16 or f32 [M, K]; weights are planar K-major uint8 ``[Kh, N]``
(``kernels/packing.py``) with scales per output channel ``[1, N]`` or per
group of G contraction rows ``[K // G, 1, N]`` (f32).  Grouped weights are
packed with K padded to a multiple of 2G (``row_mult = 2 * G``), so each
planar half covers whole groups; the scale's rank picks the form, as
``repro/core/qlinear.py`` does.  The output is f32 [M, N].

The plain version is the JAX package's XLA twin (``ops.w4a16_matmul_kmajor``
off the TPU): the weight dequantized in f32 (``q * scale``), x widened to
f32, one f32 matmul.  The kernel sums ``x * q`` in f32 and scales each
group's partial sum (or, per channel, the whole sum) at the end, so the two
differ by f32 rounding in the order of the sums.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .packing import unpack_kmajor


def w4a16_matmul_plain(x: torch.Tensor, w_kmajor: torch.Tensor,
                       w_scale: torch.Tensor, group_size: int) -> torch.Tensor:
    """Dequantize the weight in f32, then an f32 matmul -> f32 [M, N]."""
    w_q = unpack_kmajor(w_kmajor)[: x.shape[1]]
    K, N = w_q.shape
    if w_scale.ndim == 2:
        w = w_q.to(torch.float32) * w_scale
    else:
        wg = w_q.reshape(K // group_size, group_size, N).to(torch.float32)
        w = (wg * w_scale).reshape(K, N)
    return torch.matmul(x.to(torch.float32), w)


def _bind(lib: ctypes.CDLL) -> None:
    lib.w4a16_launch.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.w4a16_launch.restype = ctypes.c_int


def w4a16_matmul_cuda(x: torch.Tensor, w_kmajor: torch.Tensor,
                      w_scale: torch.Tensor, group_size: int) -> torch.Tensor:
    """Launch the W4A16 kernel on CUDA tensors: x [M, K] bf16 or f32,
    w_kmajor [Kh, N] uint8, w_scale [1, N] or [K // G, 1, N] f32 ->
    [M, N] f32."""
    ops_ = (x, w_kmajor, w_scale)
    if not (x.is_cuda and all(t.device == x.device for t in ops_)):
        raise ValueError("w4a16_matmul_cuda: all operands must be on one "
                         "CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or w_kmajor.dtype != torch.uint8 or w_scale.dtype != torch.float32:
        raise TypeError(f"w4a16_matmul_cuda: dtypes {x.dtype}, "
                        f"{w_kmajor.dtype}, {w_scale.dtype}; want bf16 or "
                        f"f32, uint8, f32")
    if x.ndim != 2 or w_kmajor.ndim != 2 or w_scale.ndim not in (2, 3):
        raise ValueError(f"w4a16_matmul_cuda: shapes {tuple(x.shape)}, "
                         f"{tuple(w_kmajor.shape)}, {tuple(w_scale.shape)}")
    if not all(t.is_contiguous() for t in ops_):
        raise ValueError("w4a16_matmul_cuda: operands must be contiguous")
    M, K = x.shape
    Kh, N = w_kmajor.shape
    grouped = w_scale.ndim == 3
    if grouped:
        G, n_groups = group_size, w_scale.shape[0]
        ok = (G > 0 and n_groups * G == K and Kh % G == 0
              and K <= 2 * Kh <= K + 2 * G and w_scale.shape[1:] == (1, N))
    else:
        G, n_groups = 0, 1
        ok = 2 * Kh in (K, K + 1) and w_scale.shape == (1, N)
    if not ok:
        raise ValueError(
            f"w4a16_matmul_cuda: x {tuple(x.shape)} does not match weight "
            f"{tuple(w_kmajor.shape)} / scale {tuple(w_scale.shape)} with "
            f"group size {group_size} (grouped weights need K padded to a "
            f"multiple of 2G)")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _build.load("w4a16_matmul", _bind)
    code = lib.w4a16_launch(
        _build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(w_kmajor),
        _build.ptr(w_scale), _build.ptr(out), M, K, N, Kh, G, n_groups,
        _build.stream_of(x))
    _build.check(lib, code, "w4a16_matmul")
    w4a16_matmul_cuda.launches += 1
    return out


w4a16_matmul_cuda.launches = 0
