"""Table-lookup W4A4 GEMM: the CUDA kernel (``csrc/lut4_matmul.cu``) and
its plain PyTorch version.

Ports ``repro/kernels/lut4_matmul.py::lut4_matmul``, the paper's 4-bit LUT
multiplier tiled across a GEMM: every partial product is read from the
4x4-bit product table (``ref.make_product_lut``, the truth table whose
columns the Pallas kernel's 16x256 per-nibble tables repeat), indexed by
the activation's nibble code and a nibble of the packed planar weight
byte, and the reads are summed as integers.  Operands are those of the
unfused W4A4 GEMM: int8 ``a_q`` [M, K] of int4 values, f32 ``a_scale``
[M, 1], planar K-major weights ``[ceil(K/2), N]`` uint8 and f32
``w_scale`` [1, N].

The exact product table is rank-1 (T[a, w] = a * w), so the lookup-sum is
the integer dot: the plain version is that dot (as
``int4_matmul.int4_matmul_plain``), and the kernel equals it, and the
unfused W4A4 kernel, bit for bit.

The kernel splits the packed rows across CTAs by ``lut4_plan`` (CTA rows,
packed rows per split, number of splits, weight load width); with more
than one split a second kernel adds the splits' int32 partials and applies
the epilogue.  The CTA rows also fix how a product is picked from
registers: the activation codes are the selectors at 64 rows (M > 16),
the weight nibbles at M <= 16 (csrc/lut4_matmul.cu).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .int4_matmul import check_w4a4_operands, int4_matmul_plain
from .ref import product_lut_on


def lut4_matmul_plain(a_q: torch.Tensor, a_scale: torch.Tensor,
                      w_kmajor: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """The exact integer dot and the scale epilogue -> f32 [M, N]."""
    return int4_matmul_plain(a_q, a_scale, w_kmajor, w_scale)


#: the CTAs a launch aims at: one per SM of an H100 (132 SMs)
SPLITK_TARGET_CTAS = 132
#: output columns per CTA (csrc/lut4_matmul.cu BN)
BN = 128
#: the fewest packed rows a split takes: one for each k-lane of a decode
#: CTA (16 at M <= 2)
MIN_ROWS = 16
#: a split's fixed cost (staging, its partial's write and read), counted as
#: packed rows when the plan weighs more splits against fewer
SPLIT_COST_ROWS = 32


@dataclasses.dataclass(frozen=True)
class Lut4Plan:
    """How one call is cut: grid (N / BN) x splits x (M / bm)."""
    bm: int         # rows of a_q per CTA
    vec: int        # bytes per weight load: 16 or 1
    rows: int       # packed rows per split: split s holds [s*rows, ...)
    splits: int
    ctas: int


@functools.lru_cache(maxsize=None)
def lut4_plan(M: int, K: int, N: int, Kh: int,
              aligned: bool = True) -> Lut4Plan:
    """The plan for a_q [M, K] times a planar weight [Kh, N], from shape
    alone.  CTA rows: 64 at M > 16; at M <= 16 M rounded up to a power of
    two.  16-byte weight loads where N % 16 == 0 and the weight is
    `aligned`, else 1-byte.  One split where the tiles alone launch SPLITK_TARGET_CTAS;
    otherwise, among powers of two of at least MIN_ROWS rows per split
    that launch SPLITK_TARGET_CTAS, the one whose busiest SM has the least
    work (CTAs per SM, rounded up, times rows plus SPLIT_COST_ROWS; ties to
    more rows); where none does, MIN_ROWS."""
    if M < 1 or N < 1 or 2 * Kh not in (K, K + 1):
        raise ValueError(f"lut4_plan: M = {M}, K = {K}, N = {N}, Kh = {Kh}")
    bm = 64 if M > 16 else 1 << (M - 1).bit_length()
    vec = 16 if aligned and N % 16 == 0 else 1
    tiles = -(-N // BN) * -(-M // bm)
    rows = Kh
    if tiles < SPLITK_TARGET_CTAS:
        cands, r = [], MIN_ROWS
        while r < Kh:
            ctas = tiles * -(-Kh // r)
            if ctas >= SPLITK_TARGET_CTAS:
                cost = -(-ctas // SPLITK_TARGET_CTAS) * (r + SPLIT_COST_ROWS)
                cands.append((cost, -r))
            r *= 2
        rows = -min(cands)[1] if cands else min(MIN_ROWS, Kh)
    splits = -(-Kh // rows)
    if splits == 1:
        rows = Kh
    return Lut4Plan(bm, vec, rows, splits, tiles * splits)


def _bind(lib: ctypes.CDLL) -> None:
    lib.lut4_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.lut4_launch.restype = ctypes.c_int


def lut4_matmul_cuda(a_q: torch.Tensor, a_scale: torch.Tensor,
                     w_kmajor: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the table-lookup kernel on CUDA tensors: a_q [M, K] int8,
    a_scale [M, 1] f32, w_kmajor [ceil(K/2), N] uint8, w_scale [1, N] f32
    -> [M, N] f32.  With more than one split an int32 workspace
    [splits, M, N] and the reduce kernel; one launch count a call either
    way."""
    check_w4a4_operands("lut4_matmul_cuda", a_q, torch.int8, w_kmajor,
                        w_scale, a_scale)
    M, K = a_q.shape
    Kh, N = w_kmajor.shape
    out = torch.empty((M, N), dtype=torch.float32, device=a_q.device)
    if M == 0 or N == 0:
        return out
    p = lut4_plan(M, K, N, Kh, w_kmajor.data_ptr() % 16 == 0)
    ws = (torch.empty((p.splits, M, N), dtype=torch.int32, device=a_q.device)
          if p.splits > 1 else None)
    lib = _build.load("lut4_matmul", _bind)
    code = lib.lut4_launch(
        _build.ptr(a_q), _build.ptr(a_scale), _build.ptr(w_kmajor),
        _build.ptr(w_scale), _build.ptr(product_lut_on(a_q.device)),
        _build.ptr(out), _build.ptr(ws), M, K, N, Kh, p.bm, p.vec, p.rows,
        p.splits, _build.stream_of(a_q))
    _build.check(lib, code, "lut4_matmul")
    lut4_matmul_cuda.launches += 1
    return out


lut4_matmul_cuda.launches = 0
