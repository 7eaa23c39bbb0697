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

At M <= 16 the kernel splits K across CTAs by the plan ``splitk_plan``
returns (column tile, rows of x per CTA, packed rows per split, number of
splits) and sums the splits' partials in a second kernel, in split order.
At M > 16 ``prefill_plan`` picks one tiled kernel: bf16 x on the tensor
cores (bf16 ``mma.sync``, f32 sums: x * q is exact in f32, so it computes
what the Pallas kernel and its XLA twin compute, up to f32 rounding), f32
x, or bf16 x grouped with G % 16 != 0, on the first port's FFMA kernel.
A plan tuned for the call's shape (``autotune`` op ``"w4a16_matmul"``:
the split-K plan's rows of x per CTA and rows per split, or the
tensor-core kernel's rows per CTA) takes the rule's place where the cache
holds one (`launch_plan`).  Another split reorders the f32 sums, within
the same rounding bound.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, autotune
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


#: the largest M that runs the split-K path
SPLITK_MAX_M = 16
#: the CTAs a split-K launch aims at: one per SM of an H100 (132 SMs)
SPLITK_TARGET_CTAS = 132
# the split-K kernel's geometry (csrc/w4a16_matmul.cu): 128 threads; a
# row of the column tile is read by 8 threads of 16 bytes or a warp of 1
# byte, so the CTA covers 16 or 4 packed rows at once; at most 128 packed
# rows a split (the x slice in shared memory; on the card, 256 was no
# faster and fewer, longer splits beat more CTAs)
_SPLITK_THREADS = 128
_SPLITK_BN = {16: 128, 1: 32}
_SPLITK_MAX_ROWS = 128


@dataclasses.dataclass(frozen=True)
class SplitKPlan:
    """How the M <= 16 path cuts one call: CTA (column tile, split, chunk
    of x rows), grid (N / bn) x splits x (M / mt)."""
    vec: int        # bytes per weight load: 16 (one uint4) or 1
    bn: int         # output columns per CTA
    mt: int         # rows of x per CTA
    rows: int       # packed weight rows per split (both planes)
    splits: int     # splits of [0, Kh): split s holds rows [s*rows, ...)
    ctas: int


@functools.lru_cache(maxsize=None)
def splitk_plan(M: int, N: int, Kh: int, group_size: int,
                aligned: bool = True) -> SplitKPlan:
    """The split-K plan for x [M, K] times a planar weight [Kh, N]
    (group_size 0 = per channel).  16-byte loads where every row starts
    16-byte aligned (N % 16 == 0 and an `aligned` weight), else 1-byte.
    Rows per split: grouped, a divisor of G, so a split lies inside one
    group of each plane (Kh is a multiple of G); per channel, the row
    lanes times a power of two.  The most rows per split that still
    launches SPLITK_TARGET_CTAS; where none does, the fewest rows that
    keep every row lane of the CTA busy."""
    if not 0 < M <= SPLITK_MAX_M:
        raise ValueError(f"splitk_plan: M = {M} outside 1..{SPLITK_MAX_M}")
    vec = 16 if aligned and N % 16 == 0 else 1
    bn = _SPLITK_BN[vec]
    lanes = _SPLITK_THREADS // 32 * (32 // (bn // vec))
    grouped = group_size > 0
    # rows of x per CTA: 16-byte loads keep 16 columns a thread, so at most
    # 2 (64 sums a thread grouped, 32 per channel: 4 was slower on the card
    # at every M = 8 shape, fewer CTAs fitting an SM); 1-byte loads 8
    mt = min(1 << (M - 1).bit_length(), 2 if vec == 16 else 8)
    tiles = -(-N // bn) * -(-M // mt)
    if grouped:
        cands = [d for d in range(min(group_size, _SPLITK_MAX_ROWS), 0, -1)
                 if group_size % d == 0]
    else:
        cands = [r for r in (128, 64, 32, 16, 8, 4) if r >= lanes]
    floor = min(lanes, cands[0])
    rows = next((r for r in cands if r >= floor
                 and tiles * -(-Kh // r) >= SPLITK_TARGET_CTAS),
                min(r for r in cands if r >= floor))
    splits = max(1, -(-Kh // rows))
    return SplitKPlan(vec, bn, mt, rows, splits, tiles * splits)


#: the tensor-core kernel's contraction depth (mma.sync.m16n8k16): a
#: grouped weight takes it only where a 16-row step stays inside a group
MMA_K = 16
#: the kernel of each path, as ``csrc/w4a16_matmul.cu`` numbers them
_PATHS = {"splitk": 0, "ffma": 1, "mma": 2}


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """Which kernel the M > 16 path runs and how it cuts and loads."""
    kernel: str     # "mma" (bf16 tensor cores) or "ffma" (f32 CUDA cores)
    bm: int         # rows of x per CTA (64 columns): 64 or 32; FFMA 64
    x_vec: int      # bytes per x load: 16 (cp.async) or 2; FFMA: x's size
    w_vec: int      # bytes per weight load: 16 (cp.async) or 1


@functools.lru_cache(maxsize=None)
def prefill_plan(M: int, K: int, N: int, Kh: int, group_size: int,
                 x_bf16: bool = True, x_aligned: bool = True,
                 w_aligned: bool = True) -> PrefillPlan:
    """The kernel for x [M, K] (M > 16) times a planar weight [Kh, N]
    (group_size 0 = per channel), by shape and type alone: the tensor
    cores for bf16 x per channel or with G % MMA_K == 0, else FFMA.  The
    tensor-core kernel takes 64 rows of x a CTA, or 32 where 64-row tiles
    would launch fewer than SPLITK_TARGET_CTAS CTAs (one per SM: each
    CTA's k-steps cost the same whatever its rows, so more, smaller CTAs
    finish sooner there); it loads x 16 bytes at a time where every row
    starts 16-byte aligned (an `x_aligned` pointer, K and Kh multiples of
    8), else 2; the weight 16 bytes where N % 16 == 0 and `w_aligned`,
    else 1."""
    if M <= SPLITK_MAX_M:
        raise ValueError(f"prefill_plan: M = {M} <= {SPLITK_MAX_M} takes "
                         "the split-K path")
    if not x_bf16 or group_size % MMA_K != 0:
        return PrefillPlan("ffma", 64, 2 if x_bf16 else 4, 1)
    bm = 64 if -(-M // 64) * -(-N // 64) >= SPLITK_TARGET_CTAS else 32
    x_vec = 16 if x_aligned and K % 8 == 0 and Kh % 8 == 0 else 2
    w_vec = 16 if w_aligned and N % 16 == 0 else 1
    return PrefillPlan("mma", bm, x_vec, w_vec)


#: rows of x per split-K CTA the kernel instantiates, by weight load width
_SPLITK_MT = {16: (1, 2), 1: (1, 2, 4, 8)}
#: rows of x per CTA the prefill kernels instantiate
_PREFILL_BM = {"mma": (64, 32), "ffma": (64,)}


def plan_entry(p) -> dict:
    """A plan's tunable fields: what an ``autotune`` cache entry holds
    (split-K: rows of x per CTA, packed rows per split; prefill: the
    kernel, which the rule picks by x's type and G, and its rows of x per
    CTA)."""
    if isinstance(p, SplitKPlan):
        return {"mt": p.mt, "rows": p.rows, "splits": p.splits}
    return {"kernel": p.kernel, "bm": p.bm}


def w4a16_plan_from(entry: dict, M: int, K: int, N: int, Kh: int,
                    group_size: int, x_bf16: bool = True,
                    x_aligned: bool = True, w_aligned: bool = True):
    """The plan of a tuned entry at this shape; ValueError unless the
    kernel takes it.  At M <= 16 a split-K plan ({mt, rows[, splits]}):
    rows of x per CTA of `_SPLITK_MT` for the load width, at most 128
    packed rows a split, a divisor of G when grouped.  Above, a prefill
    plan ({kernel, bm}): the rule's kernel, rows per CTA of
    `_PREFILL_BM`.  Load widths follow alignment, as the rule's."""
    G = group_size
    if M <= SPLITK_MAX_M:
        rule = splitk_plan(M, N, Kh, G, w_aligned)
        mt, rows = autotune.int_field(entry, "mt"), \
            autotune.int_field(entry, "rows")
        if mt not in _SPLITK_MT[rule.vec]:
            raise ValueError(f"w4a16 plan: {mt} rows of x a CTA with "
                             f"{rule.vec}-byte loads; the kernel takes "
                             f"{_SPLITK_MT[rule.vec]}")
        if not 1 <= rows <= _SPLITK_MAX_ROWS or (G and G % rows):
            raise ValueError(f"w4a16 plan: {rows} rows a split; at most "
                             f"{_SPLITK_MAX_ROWS}, dividing G = {G}")
        splits = max(1, -(-Kh // rows))
        if autotune.int_field(entry, "splits", splits) != splits:
            raise ValueError(f"w4a16 plan: {entry['splits']} splits; "
                             f"{rows} rows a split make {splits}")
        tiles = -(-N // rule.bn) * -(-M // mt)
        return SplitKPlan(rule.vec, rule.bn, mt, rows, splits,
                          tiles * splits)
    rule = prefill_plan(M, K, N, Kh, G, x_bf16, x_aligned, w_aligned)
    bm = autotune.int_field(entry, "bm")
    if entry.get("kernel", rule.kernel) != rule.kernel \
            or bm not in _PREFILL_BM[rule.kernel]:
        raise ValueError(f"w4a16 plan: {entry.get('kernel')} kernel, {bm} "
                         f"rows a CTA; x's type and G pick {rule.kernel}, "
                         f"which takes {_PREFILL_BM[rule.kernel]} rows")
    return dataclasses.replace(rule, bm=bm)


def _kh(K: int, G: int) -> int:
    """Packed rows of a weight of K rows: K padded to 2G when grouped."""
    return -(-K // (2 * G)) * G if G else -(-K // 2)


def _rule(M: int, K: int, N: int, G: int, dtype: str):
    Kh = _kh(K, G)
    if M <= SPLITK_MAX_M:
        return splitk_plan(M, N, Kh, G)
    return prefill_plan(M, K, N, Kh, G, dtype == "bfloat16")


def w4a16_candidates(M: int, K: int, N: int, G: int = 0,
                     dtype: str = "bfloat16") -> list:
    """The tuner's search space: the rule's plan first; at M <= 16 every
    rows of x per CTA the load width takes up to M rounded up to a power
    of two, times rows per split (grouped: the divisors of G from 4 to
    128; per channel: 4 to 128 by powers of two); above, each rows per CTA
    of the rule's kernel."""
    rule = _rule(M, K, N, G, dtype)
    out = [plan_entry(rule)]
    if M > SPLITK_MAX_M:
        cands = [{"kernel": rule.kernel, "bm": b}
                 for b in _PREFILL_BM[rule.kernel]]
    else:
        Kh = _kh(K, G)
        cap = 1 << (M - 1).bit_length()
        mts = [m for m in _SPLITK_MT[rule.vec] if m <= cap]
        rows_set = [d for d in range(min(G, _SPLITK_MAX_ROWS), 3, -1)
                    if G % d == 0] if G else [128, 64, 32, 16, 8, 4]
        cands = [{"mt": m, "rows": r, "splits": max(1, -(-Kh // r))}
                 for m in mts for r in rows_set]
    out += [e for e in cands if e != out[0]]
    return out


def _tuning_check(entry, M, K, N, G, dtype):
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"w4a16 plan: dtype {dtype}; the kernel takes "
                         "bfloat16 or float32 x")
    return w4a16_plan_from(entry, M, K, N, _kh(K, G), G,
                           dtype == "bfloat16")


TUNING = autotune.Tuning(
    check=_tuning_check, candidates=w4a16_candidates,
    rule=lambda M, K, N, G, dtype: plan_entry(_rule(M, K, N, G, dtype)))


def launch_plan(M: int, K: int, N: int, Kh: int, G: int, x_bf16: bool,
                x_aligned: bool, w_aligned: bool, plan: dict = None):
    """The plan a launch takes (a `SplitKPlan` at M <= 16, else a
    `PrefillPlan`): `plan` where the caller gives one, else the tuned
    entry for this shape, x's dtype and G where the cache holds one, else
    the rule's.  An entry the kernel cannot take raises ValueError,
    before any launch."""
    if plan is None:
        plan = autotune.lookup("w4a16_matmul", M, K, N,
                               "bfloat16" if x_bf16 else "float32", G)
    if plan is not None:
        return w4a16_plan_from(plan, M, K, N, Kh, G, x_bf16, x_aligned,
                               w_aligned)
    if M <= SPLITK_MAX_M:
        return splitk_plan(M, N, Kh, G, w_aligned)
    return prefill_plan(M, K, N, Kh, G, x_bf16, x_aligned, w_aligned)


def _bind(lib: ctypes.CDLL) -> None:
    lib.w4a16_launch.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.w4a16_launch.restype = ctypes.c_int


def w4a16_matmul_cuda(x: torch.Tensor, w_kmajor: torch.Tensor,
                      w_scale: torch.Tensor, group_size: int, *,
                      plan: dict = None) -> torch.Tensor:
    """Launch the W4A16 kernel on CUDA tensors: x [M, K] bf16 or f32,
    w_kmajor [Kh, N] uint8, w_scale [1, N] or [K // G, 1, N] f32 ->
    [M, N] f32, cut by `launch_plan` (`plan`: an
    entry to take in place of the cache's and the rule's).  At M <= 16 the
    split-K kernel and its reduce, with an f32 workspace [splits, M, N];
    at M > 16 the prefill plan's kernel; one launch count a call either
    way."""
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
    x_bf16 = x.dtype == torch.bfloat16
    p = launch_plan(M, K, N, Kh, G, x_bf16, x.data_ptr() % 16 == 0,
                    w_kmajor.data_ptr() % 16 == 0, plan)
    ws = None
    if isinstance(p, SplitKPlan):
        ws = torch.empty((p.splits, M, N), dtype=torch.float32,
                         device=x.device)
        args = (_PATHS["splitk"], p.vec, 0, p.mt, p.rows, p.splits)
    else:
        args = (_PATHS[p.kernel], p.w_vec, p.x_vec, p.bm, 0, 0)
    lib = _build.load("w4a16_matmul", _bind)
    code = lib.w4a16_launch(
        _build.ptr(x), int(x_bf16), _build.ptr(w_kmajor),
        _build.ptr(w_scale), _build.ptr(out), _build.ptr(ws), M, K, N, Kh, G,
        n_groups, *args, _build.stream_of(x))
    _build.check(lib, code, "w4a16_matmul")
    w4a16_matmul_cuda.launches += 1
    return out


w4a16_matmul_cuda.launches = 0
