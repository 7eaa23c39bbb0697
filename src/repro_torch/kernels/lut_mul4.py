"""Elementwise int4 x int4 -> int8 product through the 256-entry product
table: the CUDA kernel (``csrc/lut_mul4.cu``) and its plain PyTorch version.

Ports ``repro/kernels/lut_mul4.py::lut_mul4``, the direct form of the
paper's mechanism: a precomputed truth table read per operand pair at
``(a & 0xF) << 4 | (b & 0xF)`` (``ref.make_product_lut``).  The JAX
package's two strategies, ``"onehot"`` and ``"take"``, give the same
integers; on the card both are one shared-memory read, so one kernel serves
both and the argument is checked and kept for the API's sake.  The kernel
moves 16 elements a thread as 16-byte vectors where a, b and the output
share their address modulo 16, and the elements around them as bytes.
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
        + [ctypes.c_longlong, ctypes.c_void_p]
    lib.lut_mul4_launch.restype = ctypes.c_int
    lib.lut_mul4_floor_launch.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    lib.lut_mul4_floor_launch.restype = ctypes.c_int


def _output_like(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int8 tensor of a's shape whose address shares a's offset within
    16 bytes when b shares it too (a[1:] * b[1:]), so the kernel moves the
    elements past the first 16-byte boundary as 16-byte vectors; else a
    fresh tensor."""
    r = a.data_ptr() % 16
    if r == 0 or b.data_ptr() % 16 != r or a.numel() == 0:
        return torch.empty_like(a)
    buf = torch.empty(a.numel() + 16, dtype=torch.int8, device=a.device)
    off = (r - buf.data_ptr()) % 16
    return buf[off:off + a.numel()].view(a.shape)


def check_mul4_operands(what: str, *ts: torch.Tensor) -> None:
    """Raise unless the tensors are int8 of one shape on one CUDA device."""
    if not (ts[0].is_cuda and all(t.device == ts[0].device for t in ts)):
        raise ValueError(f"{what}: all operands must be on one CUDA device")
    if any(t.dtype != torch.int8 for t in ts):
        raise TypeError(f"{what}: dtypes {[t.dtype for t in ts]}; want int8")
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in ts]} "
                         f"differ")


def lut_mul4_cuda(a_q: torch.Tensor, b_q: torch.Tensor,
                  strategy: str = "onehot") -> torch.Tensor:
    """Launch the table kernel on CUDA int8 tensors of one shape -> int8 of
    that shape."""
    _check_strategy(strategy)
    check_mul4_operands("lut_mul4_cuda", a_q, b_q)
    a, b = a_q.contiguous(), b_q.contiguous()
    n = a.numel()
    out = _output_like(a, b)
    if n == 0:
        return out
    lut = product_lut_on(a.device)
    lib = _build.load("lut_mul4", _bind)
    code = lib.lut_mul4_launch(_build.ptr(a), _build.ptr(b), _build.ptr(lut),
                               _build.ptr(out), n, _build.stream_of(a))
    _build.check(lib, code, "lut_mul4")
    lut_mul4_cuda.launches += 1
    return out


lut_mul4_cuda.launches = 0


def lut_mul4_floor_cuda(a_q: torch.Tensor, b_q: torch.Tensor,
                        out: torch.Tensor) -> None:
    """Launch an empty kernel on the grid `lut_mul4_cuda` takes for these
    contiguous operands and output: the floor of a call, for measurement
    only (not counted as a launch)."""
    check_mul4_operands("lut_mul4_floor_cuda", a_q, b_q, out)
    if not all(t.is_contiguous() for t in (a_q, b_q, out)):
        raise ValueError("lut_mul4_floor_cuda: operands must be contiguous")
    lib = _build.load("lut_mul4", _bind)
    code = lib.lut_mul4_floor_launch(_build.ptr(a_q), _build.ptr(b_q),
                                     _build.ptr(out), a_q.numel(),
                                     _build.stream_of(a_q))
    _build.check(lib, code, "lut_mul4 floor")
