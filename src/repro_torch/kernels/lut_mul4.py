"""Elementwise int4 x int4 -> int8 product through the 256-entry product
table: the CUDA kernel (``csrc/lut_mul4.cu``) and its plain PyTorch version.

Ports ``repro/kernels/lut_mul4.py::lut_mul4``, the direct form of the
paper's mechanism: a precomputed truth table read per operand pair at
``(a & 0xF) << 4 | (b & 0xF)`` (``ref.make_product_lut``).  The JAX
package's two strategies, ``"onehot"`` and ``"take"``, give the same
integers; on the card both are one shared-memory read, so one kernel serves
both and the argument is checked and kept for the API's sake.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import product_lut_on

STRATEGIES = ("onehot", "take")

def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"lut_mul4: unknown strategy {strategy!r}; want one "
                         f"of {STRATEGIES}")


def lut_mul4_plain(a_q: torch.Tensor, b_q: torch.Tensor,
                   strategy: str = "onehot") -> torch.Tensor:
    """``(a * b).to(int8)`` on int8 tensors of int4 values."""
    _check_strategy(strategy)
    return (a_q.to(torch.int32) * b_q.to(torch.int32)).to(torch.int8)


def _bind(lib: ctypes.CDLL) -> None:
    lib.lut_mul4_launch.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.lut_mul4_launch.restype = ctypes.c_int


def lut_mul4_cuda(a_q: torch.Tensor, b_q: torch.Tensor,
                  strategy: str = "onehot") -> torch.Tensor:
    """Launch the table kernel on CUDA int8 tensors of one shape -> int8 of
    that shape."""
    _check_strategy(strategy)
    if not (a_q.is_cuda and b_q.device == a_q.device):
        raise ValueError("lut_mul4_cuda: both operands must be on one CUDA "
                         "device")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"lut_mul4_cuda: dtypes {a_q.dtype}, {b_q.dtype}; "
                        f"want int8")
    if a_q.shape != b_q.shape:
        raise ValueError(f"lut_mul4_cuda: shapes {tuple(a_q.shape)} and "
                         f"{tuple(b_q.shape)} differ")
    a, b = a_q.contiguous(), b_q.contiguous()
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    lut = product_lut_on(a.device)
    n_blocks = min(-(-n // 256), 132 * 16)
    lib = _build.load("lut_mul4", _bind)
    code = lib.lut_mul4_launch(_build.ptr(a), _build.ptr(b), _build.ptr(lut),
                               _build.ptr(out), n, n_blocks,
                               _build.stream_of(a))
    _build.check(lib, code, "lut_mul4")
    lut_mul4_cuda.launches += 1
    return out


lut_mul4_cuda.launches = 0
