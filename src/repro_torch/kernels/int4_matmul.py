"""W4A4 GEMM, with the activation quantize fused in or on activations
quantized beforehand: the CUDA kernel (``csrc/int4_matmul.cu``, one source
for both) and the plain PyTorch versions.

Ports ``repro/kernels/int4_matmul.py::int4_matmul_fused`` and
``::int4_matmul``.  Weights are
planar K-major uint8 ``[ceil(K/2), N]`` (``kernels/packing.py``), scales
``[1, N]`` f32.  The per-row activation scale ``max(|x|, 1e-8) / 7`` is a
reduction computed before the kernel, as in the JAX package; the kernel
quantizes, unpacks, accumulates in int32 and applies
``(acc * a_scale) * w_scale``.  The unfused pair takes int8 ``a_q``
[M, K] and f32 ``a_scale`` [M, 1] from the caller.

Both versions divide with IEEE round-to-nearest and round half to even, so
on the card they agree bit for bit.  ``kernels.ops`` picks one by the
tensor's device: the plain version for CPU tensors, the kernel for CUDA
tensors.

Both entries run one kernel on the int8 tensor cores, cut by `w4a4_plan`
(CTA tile, weight load width, packed rows per split, number of splits);
a call's splits of one output tile are one thread-block cluster that adds
its int32 partials in the kernel, so a call is one launch.  A plan tuned
for the call's shape (``autotune`` op ``"int4_matmul"``) takes the rule's
place where the cache holds one (`launch_plan`); the sums are exact
integers, so every plan gives the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..core.quant import quant_scale, quantize
from . import _build, autotune
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


def int4_matmul_plain(a_q: torch.Tensor, a_scale: torch.Tensor,
                      w_kmajor: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the unfused kernel (the XLA branch of
    ``ops.int4_matmul_kmajor``): exact integer dot as an f32 matmul (see
    `int4_matmul_fused_plain`), then ``(acc * a_scale) * w_scale``."""
    w_q = unpack_kmajor(w_kmajor)[: a_q.shape[1]]
    acc = torch.matmul(a_q.to(torch.float32), w_q.to(torch.float32))
    return acc * a_scale * w_scale


#: the CTAs a launch aims at: one per SM of an H100 (132 SMs)
TARGET_CTAS = 132
#: packed weight rows a k-step takes (one k32 MMA a plane); a split holds a
#: multiple of it
KSTEP = 32
#: the most splits of a call: the CTAs of one cluster (the portable limit)
MAX_SPLITS = 8
#: a split's fixed cost (its cluster barriers, its partial tile's trip
#: through distributed shared memory), counted as packed rows when the plan
#: weighs more splits against fewer
SPLIT_COST_ROWS = 64


@dataclasses.dataclass(frozen=True)
class W4A4Plan:
    """How one call is cut: grid (N / bn) x splits x (M / bm), the splits
    of an output tile one cluster."""
    bm: int         # rows per CTA: 16, 32 or 64
    bn: int         # columns per CTA: 64 or 128
    vec: int        # bytes per weight load: 16 or 1
    rows: int       # packed rows per split: split s holds [s*rows, ...)
    splits: int
    ctas: int


@functools.lru_cache(maxsize=None)
def w4a4_plan(M: int, K: int, N: int, Kh: int,
              aligned: bool = True) -> W4A4Plan:
    """The plan for a [M, K] activation times a planar weight [Kh, N], from
    shape alone; both entries (fused and unfused) take it.  CTA rows: 16 at
    M <= 16, 32 at M <= 32, else 64.  CTA columns: 128 where 64-row tiles
    of 128 columns, split MAX_SPLITS ways, would launch TARGET_CTAS (each
    x row is then quantized by half as many CTAs), else 64.  16-byte weight loads
    where N % 16 == 0 and the weight is `aligned`, else 1-byte.  One split
    where the tiles alone launch TARGET_CTAS; otherwise, among splits of a
    multiple of KSTEP packed rows and at most MAX_SPLITS splits, the one
    whose busiest SM has the least work (CTAs per SM, rounded up, times
    rows plus SPLIT_COST_ROWS; ties to more rows)."""
    if M < 1 or N < 1 or 2 * Kh not in (K, K + 1):
        raise ValueError(f"w4a4_plan: M = {M}, K = {K}, N = {N}, Kh = {Kh}")
    bm = 16 if M <= 16 else 32 if M <= 32 else 64
    bn = 128 if bm == 64 \
        and -(-M // 64) * -(-N // 128) * MAX_SPLITS >= TARGET_CTAS else 64
    vec = 16 if aligned and N % 16 == 0 else 1
    tiles = -(-N // bn) * -(-M // bm)
    rows = Kh
    if tiles < TARGET_CTAS:
        cands = []
        for r in range(KSTEP, Kh + KSTEP, KSTEP):
            splits = -(-Kh // r)
            if splits > MAX_SPLITS:
                continue
            cost = -(-tiles * splits // TARGET_CTAS) * (r + SPLIT_COST_ROWS)
            cands.append((cost, -r))
        rows = -min(cands)[1]
    splits = -(-Kh // rows)
    if splits == 1:
        rows = Kh
    return W4A4Plan(bm, bn, vec, rows, splits, tiles * splits)


#: the CTA tiles (bm, bn) the kernel instantiates (csrc/int4_matmul.cu)
TILES = ((16, 64), (32, 64), (64, 64), (64, 128))


def plan_entry(p: W4A4Plan) -> dict:
    """A plan's tunable fields: what an ``autotune`` cache entry holds."""
    return {"bm": p.bm, "bn": p.bn, "rows": p.rows, "splits": p.splits}


def w4a4_plan_from(entry: dict, M: int, K: int, N: int, Kh: int,
                   aligned: bool = True) -> W4A4Plan:
    """The plan of a tuned entry ({bm, bn, rows[, splits]}) at this shape;
    ValueError unless the kernel takes it: a tile of `TILES`, at most
    MAX_SPLITS splits, each a multiple of KSTEP packed rows when there
    are several.  The weight load width follows `aligned`, as the rule's."""
    if M < 1 or N < 1 or 2 * Kh not in (K, K + 1):
        raise ValueError(f"w4a4 plan: M = {M}, K = {K}, N = {N}, Kh = {Kh}")
    bm, bn, rows = (autotune.int_field(entry, k) for k in ("bm", "bn",
                                                           "rows"))
    if (bm, bn) not in TILES:
        raise ValueError(f"w4a4 plan: tile {bm} x {bn}; the kernel "
                         f"instantiates {TILES}")
    if rows < 1:
        raise ValueError(f"w4a4 plan: {rows} rows per split")
    splits = -(-Kh // rows)
    if splits == 1:
        rows = Kh
    if splits > MAX_SPLITS or (splits > 1 and rows % KSTEP):
        raise ValueError(f"w4a4 plan: {splits} splits of {rows} rows; at "
                         f"most {MAX_SPLITS}, of a multiple of {KSTEP}")
    if autotune.int_field(entry, "splits", splits) != splits:
        raise ValueError(f"w4a4 plan: {entry['splits']} splits; {rows} "
                         f"rows a split make {splits}")
    vec = 16 if aligned and N % 16 == 0 else 1
    return W4A4Plan(bm, bn, vec, rows, splits,
                    -(-N // bn) * -(-M // bm) * splits)


def w4a4_candidates(M: int, K: int, N: int, G: int = 0,
                    dtype: str = "") -> list:
    """The tuner's search space: the rule's plan first, then every tile
    of `TILES` whose rows do not exceed M rounded up to 16 (and the
    rule's), each at 1, 2, 4 and MAX_SPLITS splits."""
    Kh = -(-K // 2)
    out = [plan_entry(w4a4_plan(M, K, N, Kh))]
    cap = max(16, -(-M // 16) * 16)
    for bm, bn in TILES:
        if bm > cap and bm != out[0]["bm"]:
            continue
        for s in (1, 2, 4, MAX_SPLITS):
            rows = Kh if s == 1 else -(-(-(-Kh // s)) // KSTEP) * KSTEP
            splits = -(-Kh // rows)
            e = {"bm": bm, "bn": bn, "rows": Kh if splits == 1 else rows,
                 "splits": splits}
            if e not in out:
                out.append(e)
    return out


def _tuning_check(entry, M, K, N, G, dtype) -> W4A4Plan:
    if G or dtype not in ("float32", "int8"):
        raise ValueError(f"w4a4 plan: group size {G}, dtype {dtype}: the "
                         "kernel takes float32 x or int8 a_q, ungrouped")
    return w4a4_plan_from(entry, M, K, N, -(-K // 2))


TUNING = autotune.Tuning(
    check=_tuning_check, candidates=w4a4_candidates,
    rule=lambda M, K, N, G, dtype: plan_entry(w4a4_plan(M, K, N,
                                                        -(-K // 2))))


def launch_plan(M: int, K: int, N: int, Kh: int, aligned: bool, dtype: str,
                plan: dict = None) -> W4A4Plan:
    """The plan a launch takes: `plan` where the caller gives one (the
    tuner's candidates), else the tuned entry for this shape and
    activation dtype where the cache holds one, else `w4a4_plan`.  An
    entry the kernel cannot take raises ValueError, before any launch."""
    if plan is None:
        plan = autotune.lookup("int4_matmul", M, K, N, dtype)
    if plan is None:
        return w4a4_plan(M, K, N, Kh, aligned)
    return w4a4_plan_from(plan, M, K, N, Kh, aligned)


def _bind(lib: ctypes.CDLL) -> None:
    for fn in (lib.w4a4_fused_launch, lib.w4a4_launch):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def check_w4a4_operands(what: str, a: torch.Tensor, a_dtype: torch.dtype,
                        w_kmajor: torch.Tensor, w_scale: torch.Tensor,
                        a_scale: torch.Tensor = None) -> None:
    """Raise unless a [M, K] of `a_dtype`, planar w_kmajor [ceil(K/2), N]
    uint8, w_scale [1, N] f32 (and a_scale [M, 1] f32) are contiguous and
    on one CUDA device: what the W4A4 and table-lookup kernels take."""
    ops_ = [a, w_kmajor, w_scale] + ([a_scale] if a_scale is not None else [])
    if not (a.is_cuda and all(t.device == a.device for t in ops_)):
        raise ValueError(f"{what}: all operands must be on one CUDA device")
    want = [a_dtype, torch.uint8, torch.float32] \
        + ([torch.float32] if a_scale is not None else [])
    if [t.dtype for t in ops_] != want:
        raise TypeError(f"{what}: dtypes {[t.dtype for t in ops_]}; want "
                        f"{want}")
    if a.ndim != 2 or w_kmajor.ndim != 2:
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, "
                         f"{tuple(w_kmajor.shape)}")
    M, K = a.shape
    Kh, N = w_kmajor.shape
    if 2 * Kh not in (K, K + 1) or w_scale.numel() != N \
            or (a_scale is not None and a_scale.numel() != M):
        raise ValueError(f"{what}: activations {tuple(a.shape)} do not match "
                         f"weight {tuple(w_kmajor.shape)} / scale "
                         f"{tuple(w_scale.shape)}")
    if not all(t.is_contiguous() for t in ops_):
        raise ValueError(f"{what}: operands must be contiguous")


def int4_matmul_fused_cuda(x: torch.Tensor, w_kmajor: torch.Tensor,
                           w_scale: torch.Tensor, *,
                           plan: dict = None) -> torch.Tensor:
    """Launch the W4A4 kernel on CUDA tensors: x [M, K] f32, w_kmajor
    [ceil(K/2), N] uint8, w_scale [1, N] f32 -> [M, N] f32, cut by
    `launch_plan` (`plan`: a plan entry to take in place of the cache's
    and the rule's)."""
    check_w4a4_operands("int4_matmul_fused_cuda", x, torch.float32,
                        w_kmajor, w_scale)
    M, K = x.shape
    Kh, N = w_kmajor.shape
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    p = launch_plan(M, K, N, Kh, w_kmajor.data_ptr() % 16 == 0, "float32",
                    plan)
    a_scale = quant_scale(x, axis=1, bits=4)
    lib = _build.load("int4_matmul", _bind)
    code = lib.w4a4_fused_launch(
        _build.ptr(x), _build.ptr(a_scale), _build.ptr(w_kmajor),
        _build.ptr(w_scale), _build.ptr(out), M, K, N, Kh, p.bm, p.bn,
        p.vec, p.rows, p.splits, _build.stream_of(x))
    _build.check(lib, code, "int4_matmul_fused")
    int4_matmul_fused_cuda.launches += 1
    return out


int4_matmul_fused_cuda.launches = 0


def int4_matmul_cuda(a_q: torch.Tensor, a_scale: torch.Tensor,
                     w_kmajor: torch.Tensor, w_scale: torch.Tensor, *,
                     plan: dict = None) -> torch.Tensor:
    """Launch the unfused W4A4 kernel on CUDA tensors: a_q [M, K] int8,
    a_scale [M, 1] f32, w_kmajor [ceil(K/2), N] uint8, w_scale [1, N] f32
    -> [M, N] f32, cut by `launch_plan` (`plan` as for the fused
    entry)."""
    check_w4a4_operands("int4_matmul_cuda", a_q, torch.int8, w_kmajor,
                        w_scale, a_scale)
    M, K = a_q.shape
    Kh, N = w_kmajor.shape
    out = torch.empty((M, N), dtype=torch.float32, device=a_q.device)
    if M == 0 or N == 0:
        return out
    p = launch_plan(M, K, N, Kh, w_kmajor.data_ptr() % 16 == 0, "int8", plan)
    lib = _build.load("int4_matmul", _bind)
    code = lib.w4a4_launch(
        _build.ptr(a_q), _build.ptr(a_scale), _build.ptr(w_kmajor),
        _build.ptr(w_scale), _build.ptr(out), M, K, N, Kh, p.bm, p.bn,
        p.vec, p.rows, p.splits, _build.stream_of(a_q))
    _build.check(lib, code, "int4_matmul")
    int4_matmul_cuda.launches += 1
    return out


int4_matmul_cuda.launches = 0
