"""The W4A4 GEMM's tensor-core design (``csrc/int4_matmul.cu``,
``w4a4_mma_kernel``, both entries), checked without a GPU against the JAX
package's ``int4_matmul`` and ``int4_matmul_fused``:

(a) its plan (``w4a4_plan``): the CTA tile by M and N, the splits cover the
    packed rows once in multiples of the k-step and fit one cluster, a call
    launches one CTA per SM where K allows it and one split where the tiles
    alone fill the card, odd K, N % 16 != 0 and an unaligned weight;
(b) the shared-memory addressing: every ldmatrix of the A tile (80-byte
    rows) and every ldmatrix.trans of the swizzled weight tile reads its 8
    rows from 8 distinct 4-bank groups, and the swizzle keeps each row's
    chunks a permutation;
(c) a numpy emulation, lane by lane, of the kernel's arithmetic: ldmatrix
    of the int8 A tile, ldmatrix.trans of the packed bytes at the kernel's
    row addresses, the PRMT that makes four consecutive k of a column, the
    x16 widening of both nibble planes, mma.sync.m16n8k32 on the PTX
    fragment layouts, the split-by-split int32 partials and their sum in
    split order, the shift by 4 and the epilogue; one warp's k-step against
    the plain integer dot, and whole GEMMs (the fused entry's quantize
    included) against the JAX package's Pallas kernels in interpret mode,
    as ``tests/test_kernels.py`` runs them.

Every comparison is exact (the products are integers, and so is every sum
until the epilogue, which both sides compute in float32 in one order) but
one: against the JAX package's fused Pallas kernel, a row where x / s lies
within 1e-5 of a .5 boundary is held to that kernel's own tie bound, since
the kernel divides inexactly there (ROADMAP Queue 3 item 3); every other
row is exact, and the same rows are exact against the JAX package's eager
quantize and unfused GEMM.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.core.quant import pack_int4  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.int4_matmul import int4_matmul as jax_int4  # noqa: E402
from repro.kernels.int4_matmul import \
    int4_matmul_fused as jax_int4_fused  # noqa: E402
from repro.kernels.packing import nmajor_to_kmajor  # noqa: E402
from repro_torch.kernels.int4_matmul import (  # noqa: E402
    KSTEP, MAX_SPLITS, TARGET_CTAS, int4_matmul_fused_plain,
    int4_matmul_plain, w4a4_plan)
from repro_torch.kernels.packing import pack_kmajor  # noqa: E402

#: qwen2-0.5b's projections (K, N)
MAIN_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
#: odd shapes: odd K, N % 16 != 0, more than one split, M past 16 and 64
ODD = [(1, 2, 2), (3, 5, 2), (7, 13, 10), (33, 57, 34), (129, 511, 130),
       (17, 301, 40), (70, 1001, 72)]
#: csrc/int4_matmul.cu: an int8 A row (both planes + 16 bytes)
A_LD = 80
LANES = np.arange(32)
GID, TIG = LANES // 4, LANES % 4


def _case(M, K, N, seed, fused):
    """Seeded operands as numpy: (activation, a_scale or None, w_kmajor,
    w_scale); fused: bf16-valued f32 x (the serving path's residual stream)
    with the row's amax and a value 3.5 steps up planted; unfused: int4
    a_q and a_scale.  The weight is packed by the port's `pack_kmajor`
    (held to the JAX package's packing by tests/test_torch_kernels.py and
    by `test_port_packing_is_the_jax_packing` below)."""
    rng = np.random.default_rng(seed)
    w_q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    w_s = rng.uniform(0.01, 1.0, (1, N)).astype(np.float32)
    w_km = pack_kmajor(torch.from_numpy(w_q)).numpy()
    if fused:
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).to(torch.bfloat16).to(torch.float32).numpy()
        x[:, 0] = np.abs(x).max(axis=1)
        if K > 1:
            x[:, 1] = x[:, 0] * np.float32(0.5)
        return x, None, w_km, w_s
    a_q = rng.integers(-8, 8, (M, K)).astype(np.int8)
    a_s = rng.uniform(0.01, 1.0, (M, 1)).astype(np.float32)
    return a_q, a_s, w_km, w_s


@pytest.mark.parametrize("K,N", [(7, 10), (896, 128)])
def test_port_packing_is_the_jax_packing(K, N):
    w_q = np.random.default_rng(K).integers(-8, 8, (K, N)).astype(np.int8)
    want = np.asarray(nmajor_to_kmajor(pack_int4(jnp.asarray(w_q), axis=-1)))
    assert np.array_equal(pack_kmajor(torch.from_numpy(w_q)).numpy(), want)


def _ranges(plan, Kh):
    return [range(s * plan.rows, min((s + 1) * plan.rows, Kh))
            for s in range(plan.splits)]


# ------------------------------------------------------------- (a) plan ----
PLAN_M = (1, 8, 16, 17, 32, 64, 128, 256)
PLAN_CASES = [(M, K, N) for M in PLAN_M for K, N in MAIN_KN] + ODD


@pytest.mark.parametrize("M,K,N", PLAN_CASES)
def test_plan_covers_rows_once_and_fills_the_card(M, K, N):
    Kh = -(-K // 2)
    plan = w4a4_plan(M, K, N, Kh)
    assert plan.bm == (16 if M <= 16 else 32 if M <= 32 else 64)
    assert plan.bn in (64, 128) and (plan.bn == 128) == (
        plan.bm == 64
        and -(-M // 64) * -(-N // 128) * MAX_SPLITS >= TARGET_CTAS)
    assert plan.vec == (16 if N % 16 == 0 else 1)
    rngs = _ranges(plan, Kh)
    assert all(len(r) > 0 for r in rngs)
    assert [r for rng in rngs for r in rng] == list(range(Kh))
    assert 1 <= plan.splits <= MAX_SPLITS
    assert plan.splits == 1 or plan.rows % KSTEP == 0
    tiles = -(-N // plan.bn) * -(-M // plan.bm)
    assert plan.ctas == tiles * plan.splits
    if tiles >= TARGET_CTAS:
        assert plan.splits == 1
    elif plan.ctas < TARGET_CTAS:
        # short of the target only where one split more would not fit one
        # CTA per SM, a cluster, or the packed rows in whole k-steps
        r = -(-(-(-Kh // (plan.splits + 1))) // KSTEP) * KSTEP
        assert tiles * (plan.splits + 1) > TARGET_CTAS \
            or plan.splits == MAX_SPLITS or -(-Kh // r) <= plan.splits
    assert w4a4_plan(M, K, N, Kh, aligned=False).vec == 1
    with pytest.raises(ValueError):
        w4a4_plan(M, K, N, Kh + 1)


@pytest.mark.parametrize("M,K,N,splits", [(256, 896, 4864, 1),
                                          (8, 896, 896, 7),
                                          (8, 4864, 896, 8),
                                          (64, 896, 128, 7)])
def test_plan_splits_at_the_serving_shapes(M, K, N, splits):
    """The widest prefill projection fills the card with its tiles; the
    decode projections and the ragged budget's narrowest split K, the down
    projection into a whole cluster."""
    assert w4a4_plan(M, K, N, K // 2).splits == splits


# ---------------------------------------------- (b) shared-memory banks ----
def _wswz(bn, r):
    """csrc `wswz`: the 16-byte chunk swizzle of weight row r."""
    r = np.asarray(r)
    return (2 * ((r >> 2) & 3)) | (r & 1) if bn == 128 else (r >> 2) & 3


def _brow():
    """The weight row each lane names for ldmatrix.trans (csrc `brow`)."""
    return (16 * (LANES // 16) + 2 * ((LANES // 8) % 2)
            + 4 * ((LANES % 8) // 2) + LANES % 2)


def _groups(byte_offsets):
    """4-bank group (of 8) of each 16-byte row an ldmatrix matrix reads."""
    return (np.asarray(byte_offsets) // 16) % 8


@pytest.mark.parametrize("bn", [64, 128])
def test_ldmatrix_reads_hit_distinct_banks(bn):
    brow = _brow()
    assert sorted(brow[:8]) == [0, 1, 4, 5, 8, 9, 12, 13]
    assert sorted(brow) == list(range(32))
    for chunk in range(bn // 16):
        offs = brow * bn + 16 * (chunk ^ _wswz(bn, brow))
        for mi in range(4):
            assert len(set(_groups(offs[8 * mi:8 * mi + 8]))) == 8
    for r in range(32):          # each row's chunks: a permutation
        assert sorted(c ^ int(_wswz(bn, r)) for c in range(bn // 16)) \
            == list(range(bn // 16))
    arow = LANES % 16
    for p in (0, 1):
        offs = arow * A_LD + 32 * p + 16 * (LANES // 16)
        for mi in range(4):
            assert len(set(_groups(offs[8 * mi:8 * mi + 8]))) == 8


# -------------------------------------------- (c) the arithmetic, lanes ----
def _words(b):
    """[..., 4] bytes -> [...] little-endian uint32 words (as int64)."""
    b = np.asarray(b, np.int64) & 0xFF
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _bytes(w):
    """[...] words -> [..., 4] signed bytes (int64)."""
    w = np.asarray(w, np.int64)
    b = (w[..., None] >> (8 * np.arange(4))) & 0xFF
    return np.where(b >= 128, b - 256, b)


def byte_perm(x, y, sel):
    """CUDA __byte_perm (PTX prmt, default mode, selectors 0..7)."""
    src = np.concatenate([_bytes(x), _bytes(y)], axis=-1) & 0xFF
    idx = [(sel >> (4 * i)) & 7 for i in range(4)]
    return _words(src[..., idx])


def ldmatrix_x4(tile, rows, cols, trans):
    """ldmatrix.x4 (b16) on a [T, R, C] byte tile: lane l names 16 bytes at
    (rows[l], cols[l]), row l % 8 of matrix l // 8.  Returns [T, 32, 4]
    words.  Without .trans lane i holds b16 column i % 4 of matrix row
    i // 4; with .trans, b16 column i // 4 of matrix rows 2 (i % 4) (low
    half) and 2 (i % 4) + 1 (high half)."""
    out = []
    for mi in range(4):
        if not trans:
            src = 8 * mi + LANES // 4
            r = np.repeat(rows[src][:, None], 4, 1)
            c = cols[src][:, None] + 4 * (LANES % 4)[:, None] + np.arange(4)
        else:
            lo, hi = 8 * mi + 2 * (LANES % 4), 8 * mi + 2 * (LANES % 4) + 1
            r = np.stack([rows[lo], rows[lo], rows[hi], rows[hi]], 1)
            base = 2 * (LANES // 4)
            c = np.stack([cols[lo] + base, cols[lo] + base + 1,
                          cols[hi] + base, cols[hi] + base + 1], 1)
        out.append(_words(tile[:, r, c]))
    return np.stack(out, -1)


# the PTX fragment layouts of m16n8k32 s8 as index maps, [lane, reg, byte]
# (A, B) or [lane, element] (D)
_BYTE = np.arange(4)
_A_ROW = (GID[:, None, None] + np.array([0, 8, 0, 8])[None, :, None]
          + 0 * _BYTE)
_A_COL = (4 * TIG[:, None, None] + np.array([0, 0, 16, 16])[None, :, None]
          + _BYTE)
_B_ROW = (4 * TIG[:, None, None] + np.array([0, 16])[None, :, None] + _BYTE)
_B_COL = GID[:, None, None] + 0 * _B_ROW
_D_ROW = GID[:, None] + np.array([0, 0, 8, 8])[None, :]
_D_COL = 2 * TIG[:, None] + np.array([0, 1, 0, 1])[None, :]


def mma_m16n8k32(d, a, b):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on PTX fragments: a [T, 32,
    4] words (a0: row g, k 4t..; a1: row g + 8; a2, a3: k + 16), b [T, 32,
    2] words (b0: k 4t.. of column g; b1: k + 16), d [T, 32, 4] (d0, d1:
    row g, columns 2t, 2t + 1; d2, d3: row g + 8).  Returns d + a b."""
    T = a.shape[0]
    A = np.zeros((T, 16, 32), np.int64)
    B = np.zeros((T, 32, 8), np.int64)
    A[:, _A_ROW, _A_COL] = _bytes(a)
    B[:, _B_ROW, _B_COL] = _bytes(b)
    return d + (A @ B)[:, _D_ROW, _D_COL]


def _layout(bm, bn):
    wm = 1 if bm == 16 else 2
    wn = 4 // wm
    return wm, wn, bm // (16 * wm), bn // (16 * wn)


def cta_step(acc, a_tile, w_tile, bm, bn):
    """One k-step of every warp of a CTA, as ``compute`` in the kernel:
    a_tile [T, bm, A_LD] int8 bytes (low plane at 0, high at 32), w_tile
    [T, 32, bn] packed bytes stored swizzled; acc {(warp, i, j, h): [T, 32,
    4]} int32 sums."""
    wm_n, wn_n, MI, NJ = _layout(bm, bn)
    brow = _brow()
    bswz = _wswz(bn, brow)
    for warp in range(4):
        wm, wn = warp // wn_n, warp % wn_n
        arow = wm * 16 * MI + LANES % 16
        af = {(p, i): ldmatrix_x4(a_tile, arow + 16 * i,
                                  32 * p + 16 * (LANES // 16), False)
              for p in (0, 1) for i in range(MI)}
        for j in range(NJ):
            raw = ldmatrix_x4(w_tile, brow,
                              16 * ((wn * NJ + j) ^ bswz), True)
            b = [[byte_perm(raw[..., 2 * q], raw[..., 2 * q + 1], sel)
                  for sel in (0x6420, 0x7531)] for q in (0, 1)]
            for p in (0, 1):
                for h in (0, 1):
                    bw = [((b[q][h] << 4) if p == 0 else b[q][h])
                          & 0xF0F0F0F0 for q in (0, 1)]
                    for i in range(MI):
                        key = (warp, i, j, h)
                        acc[key] = mma_m16n8k32(acc[key], af[(p, i)],
                                                np.stack(bw, -1))
    return acc


def cta_tile(acc, bm, bn):
    """The kernel's fragment-to-output map: fragment (i, j, h), element f
    -> row wm 16 MI + 16 i + g + 8 (f // 2), column wn 16 NJ + 16 j + 4 t +
    2 (f % 2) + h.  Returns [T, bm, bn] int64 sums (still x16)."""
    wm_n, wn_n, MI, NJ = _layout(bm, bn)
    T = next(iter(acc.values())).shape[0]
    out = np.zeros((T, bm, bn), np.int64)
    for (warp, i, j, h), d in acc.items():
        wm, wn = warp // wn_n, warp % wn_n
        for f in range(4):
            row = wm * 16 * MI + 16 * i + GID + 8 * (f // 2)
            col = wn * 16 * NJ + 16 * j + 4 * TIG + 2 * (f % 2) + h
            out[:, row, col] = d[:, :, f]
    return out


def _swizzle(w_rows, bn):
    """[T, 32, bn] logical weight rows -> the ring slot's physical bytes."""
    out = np.empty_like(w_rows)
    for r in range(32):
        for c in range(bn // 16):
            p = c ^ int(_wswz(bn, r))
            out[:, r, 16 * p:16 * p + 16] = w_rows[:, r, 16 * c:16 * c + 16]
    return out


def emulate(a_int, a_s, w_km, w_s, plan):
    """A whole call as the kernel computes it: [M, K] int4 activations
    (the fused entry's already quantized), the plan's tiles and splits,
    each split's k-steps of 32 packed rows staged zero-filled (past M, N,
    K, Kh and the split's rows), every warp's MMAs, the splits' partial
    tiles summed in split order, >> 4, then (acc * a_s) * w_s in float32."""
    M, K = a_int.shape
    Kh, N = w_km.shape
    bm, bn = plan.bm, plan.bn
    mt, nt = -(-M // bm), -(-N // bn)
    A = np.zeros((mt * bm, 2 * Kh + 2 * KSTEP), np.int64)
    A[:M, :K] = a_int
    W = np.zeros((Kh + KSTEP, nt * bn), np.int64)
    W[:Kh, :N] = w_km
    T = mt * nt                      # CTA tiles, m-tile major
    total = np.zeros((T, bm, bn), np.int64)
    for rng in _ranges(plan, Kh):
        wm_n, wn_n, MI, NJ = _layout(bm, bn)
        acc = {(warp, i, j, h): np.zeros((T, 32, 4), np.int64)
               for warp in range(4) for i in range(MI) for j in range(NJ)
               for h in (0, 1)}
        for r0 in range(rng.start, rng.stop, KSTEP):
            rows = min(KSTEP, rng.stop - r0)
            a_blk = np.zeros((mt * bm, A_LD), np.int64)
            a_blk[:, :rows] = A[:, r0:r0 + rows]
            a_blk[:, 32:32 + rows] = A[:, Kh + r0:Kh + r0 + rows]
            a_tile = np.repeat(a_blk.reshape(mt, 1, bm, A_LD), nt,
                               1).reshape(T, bm, A_LD)
            w_blk = np.zeros((KSTEP, nt * bn), np.int64)
            w_blk[:rows] = W[r0:r0 + rows]
            w_rows = np.broadcast_to(
                w_blk.reshape(KSTEP, nt, bn).transpose(1, 0, 2)[None],
                (mt, nt, KSTEP, bn)).reshape(T, KSTEP, bn)
            acc = cta_step(acc, a_tile, _swizzle(w_rows, bn), bm, bn)
        total += cta_tile(acc, bm, bn)               # in split order
    assert (total % 16 == 0).all() and np.abs(total).max() < 2 ** 31
    full = total.reshape(mt, nt, bm, bn).transpose(0, 2, 1, 3).reshape(
        mt * bm, nt * bn)[:M, :N] >> 4
    return (full.astype(np.float32) * a_s) * w_s


def _quantize(x):
    """The fused entry's scale and quantize in float32 (IEEE division,
    round half to even), as the kernel's `quant4` and the wrapper's
    `quant_scale`."""
    s = np.maximum(np.abs(x).max(axis=1, keepdims=True),
                   np.float32(1e-8)) / np.float32(7.0)
    q = np.clip(np.rint(x / s), -8, 7)
    return q.astype(np.int64), s.astype(np.float32)


def test_one_warp_step_is_the_integer_dot():
    """One CTA k-step at every tile layout, random and extreme bytes, equals
    the plain dot of the two planes x 16."""
    rng = np.random.default_rng(0)
    for bm, bn in ((16, 64), (32, 64), (64, 64), (64, 128)):
        for extreme in (False, True):
            T = 2
            if extreme:
                a = np.full((T, bm, 64), -8, np.int64)
                w = np.full((T, KSTEP, bn), 0x88, np.int64)
            else:
                a = rng.integers(-8, 8, (T, bm, 64))
                w = rng.integers(0, 256, (T, KSTEP, bn))
            a_tile = np.zeros((T, bm, A_LD), np.int64)
            a_tile[:, :, :64] = a
            acc = {(warp, i, j, h): np.zeros((T, 32, 4), np.int64)
                   for warp in range(4)
                   for i in range(_layout(bm, bn)[2])
                   for j in range(_layout(bm, bn)[3]) for h in (0, 1)}
            got = cta_tile(cta_step(acc, a_tile, _swizzle(w, bn), bm, bn),
                           bm, bn)
            lo = ((w & 0xF) ^ 8) - 8
            hi = ((w >> 4) ^ 8) - 8
            want = 16 * (a[:, :, :32] @ lo + a[:, :, 32:] @ hi)
            assert np.array_equal(got, want), (bm, bn, extreme)


def test_byte_perm_gives_four_consecutive_k():
    """At the kernel's row addresses, ldmatrix.trans then PRMT 0x6420 /
    0x7531 give lane (g, t) rows 4t .. 4t + 3 (and + 16) of columns 2g and
    2g + 1 of a 16-column block, in order."""
    tile = (np.arange(32)[:, None] * 16 + np.arange(16)[None, :])[None]
    raw = ldmatrix_x4(tile, _brow(), np.zeros(32, np.int64), True)
    for q in (0, 1):
        for par, sel in ((0, 0x6420), (1, 0x7531)):
            got = _bytes(byte_perm(raw[..., 2 * q], raw[..., 2 * q + 1],
                                   sel))[0] & 0xFF
            k = 16 * q + 4 * TIG[:, None] + np.arange(4)
            assert np.array_equal(got, (k * 16 + 2 * GID[:, None] + par)
                                  & 0xFF)


#: both entries at decode rows, the path boundary and the ragged budget
#: over the serving shapes, and the odd shapes
EMU_CASES = ([(f, M, K, N) for f in (True, False) for M in (1, 8, 17, 64)
              for K, N in MAIN_KN]
             + [(f, M, K, N) for f in (True, False) for M, K, N in ODD])


def _xla_twin(*args):
    """The JAX package's XLA twin of the unfused GEMM (its `ops` dispatch
    with no interpreter asked for, off the TPU)."""
    import os

    old = os.environ.pop("REPRO_PALLAS_INTERPRET", None)
    try:
        return np.asarray(jops.int4_matmul_kmajor(*args))
    finally:
        if old is not None:
            os.environ["REPRO_PALLAS_INTERPRET"] = old


@pytest.fixture(scope="module")
def pallas():
    """The JAX package on every EMU_CASES input, keyed by (entry, M, K, N):
    its Pallas kernel of the entry in interpret mode; for the fused entry
    also the activations quantized by its eager `quant_scale` / `quantize`
    and its XLA twin of the unfused GEMM on them.  Built once."""
    out = {}
    blocks = dict(bm=64, bn=1024, bk=1024, interpret=True)
    for i, (fused, M, K, N) in enumerate(EMU_CASES):
        act, a_s, w_km, w_s = _case(M, K, N, seed=40 + i, fused=fused)
        w = (jnp.asarray(w_km), jnp.asarray(w_s))
        if fused:
            a_sj = jquant.quant_scale(jnp.asarray(act), axis=1, bits=4)
            a_qj = jquant.quantize(jnp.asarray(act), a_sj, bits=4)
            want = {"fused": np.asarray(jax_int4_fused(jnp.asarray(act), *w,
                                                       **blocks)),
                    "on_q": _xla_twin(a_qj, a_sj, *w),
                    "q": (np.asarray(a_qj), np.asarray(a_sj))}
        else:
            want = {"on_q": np.asarray(jax_int4(jnp.asarray(act),
                                                jnp.asarray(a_s), *w,
                                                **blocks))}
        out[(fused, M, K, N)] = ((act, a_s, w_km, w_s), want)
    return out


def _near_ties(x, s):
    """Per row, the elements whose quotient x / s lies within 1e-5 of a .5
    boundary: there the JAX package's Pallas kernel divides inexactly (the
    CPU interpreter, like XLA's fast-math fusion, may take a reciprocal) and
    may round to the other neighbour (ROADMAP Queue 3 item 3)."""
    r = x / s
    return (np.abs(np.abs(r - np.rint(r)) - 0.5) <= 1e-5).sum(axis=1)


@pytest.mark.parametrize("fused,M,K,N", EMU_CASES)
def test_emulated_kernel_equals_the_pallas_kernel(pallas, fused, M, K, N):
    """Unfused: the emulation equals the Pallas kernel and the plain
    version, bit for bit.  Fused: the kernel's quantize equals the JAX
    package's eager quantize bit for bit, and the emulation equals the
    unfused Pallas kernel on those activations and the plain version, bit
    for bit; against the fused Pallas kernel it is bit-equal on every row
    without a near-tie, and elsewhere within the JAX package's bound for
    that kernel at ties (8 weight steps a near-tie)."""
    (act, a_s, w_km, w_s), want = pallas[(fused, M, K, N)]
    plan = w4a4_plan(M, K, N, w_km.shape[0])
    if fused:
        a_int, a_s = _quantize(act)
        assert np.array_equal(a_int, want["q"][0])
        assert np.array_equal(a_s, want["q"][1])
        plain = int4_matmul_fused_plain(*(torch.from_numpy(t)
                                          for t in (act, w_km, w_s)))
    else:
        a_int = act.astype(np.int64)
        plain = int4_matmul_plain(*(torch.from_numpy(t)
                                    for t in (act, a_s, w_km, w_s)))
    got = emulate(a_int, a_s, w_km, w_s, plan)
    assert np.array_equal(got, want["on_q"])
    assert np.array_equal(plain.numpy(), got)
    if fused:
        ties = _near_ties(act, a_s)
        exact = ties == 0
        assert np.array_equal(got[exact], want["fused"][exact])
        # the JAX package's own bound for its fused kernel at ties
        # (tests/test_kernels.py): a flipped quotient moves an output by at
        # most 8 weight steps, each side's float32 epilogue rounds once more
        bound = np.abs(want["fused"]) * 1e-5 + 1e-5 \
            + (ties * 8.0 * a_s[:, 0] * float(w_s.max()))[:, None]
        assert (np.abs(got - want["fused"]) <= bound).all()
