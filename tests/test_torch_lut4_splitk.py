"""The table-lookup GEMM's split-K design (``csrc/lut4_matmul.cu``), checked
without a GPU against the JAX package's ``lut4_matmul``:

(a) its plan (``lut4_plan``): the splits cover the packed rows once, a call
    launches at least one CTA per SM where K allows it, and one split where
    the tiles alone fill the card;
(b) its arithmetic, the int32 products read from the product table and
    summed split by split in plain PyTorch as the kernel splits them, then
    the epilogue: equal, bit for bit, to the JAX package's XLA twin at the
    serving shapes and to the Pallas kernel in interpret mode (small
    blocks) at odd shapes;
(c) a numpy emulation, bit for bit, of the kernel's register lookup: PRMT
    with its sign-replicate selector bit, the 3-bit selectors and the
    half mask, the biased table, the 16-bit lanes and their flush: every
    (a, w) pair reads its product in either orientation, and a whole GEMM
    through it, in each path's orientation (activation codes as selectors
    at 64 rows a CTA, weight nibbles below), equals the JAX package's
    result exactly.

Every comparison is exact: the products are integers, and so is every sum
until the epilogue.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.quant import pack_int4  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.lut4_matmul import lut4_matmul as jax_lut4  # noqa: E402
from repro.kernels.packing import nmajor_to_kmajor  # noqa: E402
from repro_torch.kernels.lut4_matmul import (  # noqa: E402
    BN, MIN_ROWS, SPLITK_TARGET_CTAS, lut4_plan)
from repro_torch.kernels.ref import make_product_lut  # noqa: E402

#: qwen2-0.5b's projections (K, N)
MAIN_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
#: test_torch_cuda.py's odd shapes (M, K, N)
ODD = [(1, 2, 2), (3, 5, 2), (7, 13, 10), (33, 57, 34), (129, 511, 130)]
PLAN_M = (1, 8, 16, 17, 64, 256)
#: the kernel's chunk of packed rows and the lanes' table bias
CH, BIAS = 64, 56
P = make_product_lut().numpy().astype(np.int64).reshape(16, 16)


def _case(M, K, N, seed):
    """Seeded int4 operands and scales: (a_q, a_scale, w_kmajor, w_scale)
    as numpy, the weight packed by the JAX package."""
    rng = np.random.default_rng(seed)
    a_q = rng.integers(-8, 8, (M, K)).astype(np.int8)
    w_q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    a_s = rng.uniform(0.01, 1.0, (M, 1)).astype(np.float32)
    w_s = rng.uniform(0.01, 1.0, (1, N)).astype(np.float32)
    wp = pack_int4(jnp.asarray(w_q), axis=-1)
    return a_q, a_s, np.asarray(nmajor_to_kmajor(wp)), w_s


def _ranges(plan, Kh):
    return [range(s * plan.rows, min((s + 1) * plan.rows, Kh))
            for s in range(plan.splits)]


def _codes(a_q, Kh):
    """[M, 2 Kh] unsigned nibble codes; odd K's pad column reads code 0."""
    M, K = a_q.shape
    c = np.zeros((M, 2 * Kh), np.int64)
    c[:, :K] = a_q.astype(np.int64) & 0xF
    return c


def _epilogue(acc, a_s, w_s):
    return (torch.from_numpy(acc).to(torch.int32).to(torch.float32)
            * torch.from_numpy(a_s)) * torch.from_numpy(w_s)


# ------------------------------------------------------------- (a) plan ----
PLAN_CASES = [(M, K, N) for M in PLAN_M for K, N in MAIN_KN] + ODD


@pytest.mark.parametrize("M,K,N", PLAN_CASES)
def test_plan_covers_rows_once_and_fills_the_card(M, K, N):
    Kh = -(-K // 2)
    plan = lut4_plan(M, K, N, Kh)
    assert plan.bm == (64 if M > 16 else 1 << (M - 1).bit_length())
    assert plan.vec == (16 if N % 16 == 0 else 1)
    rngs = _ranges(plan, Kh)
    assert all(len(r) > 0 for r in rngs)
    assert [r for rng in rngs for r in rng] == list(range(Kh))
    tiles = -(-N // BN) * -(-M // plan.bm)
    assert plan.ctas == tiles * plan.splits
    if tiles >= SPLITK_TARGET_CTAS:
        assert plan.splits == 1
    else:                     # as many CTAs as K allows, up to the target
        assert plan.ctas >= SPLITK_TARGET_CTAS \
            or plan.rows == min(MIN_ROWS, Kh)
    assert lut4_plan(M, K, N, Kh, aligned=False).vec == 1
    with pytest.raises(ValueError):
        lut4_plan(M, K, N, Kh + 1)


@pytest.mark.parametrize("M,K,N,one_split", [(256, 896, 4864, True),
                                              (8, 896, 896, False),
                                              (64, 4864, 128, False)])
def test_plan_splits_both_ways_at_the_serving_shapes(M, K, N, one_split):
    """The widest prefill projection fills the card with its tiles; a
    decode projection and the ragged budget's narrowest split K."""
    assert (lut4_plan(M, K, N, K // 2).splits == 1) == one_split


# ----------------------------------------------- (b) split-by-split sums ----
def _splitk_table_sum(a_q, w_km, plan):
    """The kernel's arithmetic: per split, every product read from the
    product table P[code][nibble] and summed in int32 over the split's
    rows of both planes; the splits' partials added (any order: integers).
    Chunks of rows keep the gathered products small."""
    Kh, N = w_km.shape
    codes = torch.from_numpy(_codes(a_q, Kh))
    w = torch.from_numpy(w_km.astype(np.int64))
    nib = (w & 0xF, w >> 4)
    table = torch.from_numpy(P).to(torch.int16)
    parts = []
    for rng in _ranges(plan, Kh):
        part = torch.zeros((a_q.shape[0], N), dtype=torch.int32)
        for r0 in range(rng.start, rng.stop, 8):
            r1 = min(r0 + 8, rng.stop)
            for p in (0, 1):
                c = codes[:, p * Kh + r0:p * Kh + r1]        # [M, rows]
                part += table[c[:, :, None], nib[p][None, r0:r1, :]] \
                    .to(torch.int32).sum(1, dtype=torch.int32)
        parts.append(part)
    return torch.stack(parts).sum(0, dtype=torch.int32).numpy()


#: the serving shapes at decode rows, the path boundary and the ragged
#: budget (the prefill rows' plans cut K the same way, at more CPU time)
SUM_CASES = [(M, K, N) for M in (1, 8, 17, 64) for K, N in MAIN_KN]


@pytest.fixture(scope="module")
def xla_twin():
    """The JAX package's XLA twin on every SUM_CASES input, built once."""
    import os

    old = os.environ.pop("REPRO_PALLAS_INTERPRET", None)
    try:
        out = {}
        for i, (M, K, N) in enumerate(SUM_CASES):
            case = _case(M, K, N, seed=100 + i)
            out[(M, K, N)] = (case, np.asarray(jops.lut4_matmul_kmajor(
                *(jnp.asarray(t) for t in case))))
        return out
    finally:
        if old is not None:
            os.environ["REPRO_PALLAS_INTERPRET"] = old


@pytest.mark.parametrize("M,K,N", SUM_CASES)
def test_splitk_sums_equal_the_xla_twin(xla_twin, M, K, N):
    (a_q, a_s, w_km, w_s), want = xla_twin[(M, K, N)]
    plan = lut4_plan(M, K, N, w_km.shape[0])
    got = _epilogue(_splitk_table_sum(a_q, w_km, plan), a_s, w_s).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("M,K,N", ODD)
def test_splitk_sums_equal_the_pallas_kernel_odd_shapes(M, K, N):
    a_q, a_s, w_km, w_s = _case(M, K, N, seed=M + K + N)
    want = np.asarray(jax_lut4(*(jnp.asarray(t) for t in (a_q, a_s, w_km,
                                                          w_s)),
                               bm=32, bn=32, bk=16, interpret=True))
    plan = lut4_plan(M, K, N, w_km.shape[0])
    got = _epilogue(_splitk_table_sum(a_q, w_km, plan), a_s, w_s)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------- (c) the register lookup, in bits --
U32 = np.uint64      # 32-bit words held in 64 bits, masked after each op


def prmt(x, y, sel):
    """PTX prmt (``__byte_perm``), default mode: byte i of the result is
    byte (nibble i of sel) & 7 of {y, x}, or that byte's sign bit repeated
    eight times where the nibble's bit 3 is set."""
    x, y, sel = (np.asarray(v, U32) for v in (x, y, sel))
    src = (y << U32(32)) | x
    out = np.zeros(np.broadcast(x, y, sel).shape, U32)
    for i in range(4):
        nib = (sel >> U32(4 * i)) & U32(0xF)
        b = (src >> (U32(8) * (nib & U32(7)))) & U32(0xFF)
        b = np.where(nib & U32(8), np.where(b & U32(0x80), U32(0xFF), U32(0)),
                     b)
        out |= b << U32(8 * i)
    return out


def selector(v):
    """csrc `selector`: the low 3 bits of each byte of v as prmt nibbles."""
    t = np.asarray(v, U32) & U32(0x07070707)
    return prmt(t | (t >> U32(4)), 0, 0x0020)


def half_mask(v):
    """csrc `half_mask`: 0xFF in byte i where bit 3 of byte i is set."""
    return prmt((np.asarray(v, U32) << U32(4)) & U32(0xFFFFFFFF), 0, 0xBA98)


def pick(c, sel, mask):
    """csrc `pick`: c is a 16-byte table vector as four words."""
    lo = prmt(c[..., 0], c[..., 1], sel)
    hi = prmt(c[..., 2], c[..., 3], sel)
    return ((lo & ~mask) | (hi & mask)) & U32(0xFFFFFFFF)


def _table_words(bias):
    """The shared table as [16, 4] words: T[x] holds P[x][0..15] + bias,
    little-endian bytes (uint4 t4[x] in the kernel)."""
    b = (P + bias).astype(np.uint8).reshape(16, 16)
    return b.view("<u4").astype(U32)


def _word(bytes4):
    """Four bytes (last axis) -> one little-endian 32-bit word."""
    b = np.asarray(bytes4, U32)
    return b[..., 0] | (b[..., 1] << U32(8)) | (b[..., 2] << U32(16)) \
        | (b[..., 3] << U32(24))


def test_prmt_semantics_and_the_unmasked_selector():
    """prmt's selector bit 3 replicates the sign: a code of 8..15 used as a
    selector without masking reads 0x00 or 0xFF, not the product; masked
    to 3 bits and combined by the half mask it reads the product."""
    x, y = 0x83020100, 0x07060504
    assert int(prmt(x, y, 0x3210)) == x and int(prmt(x, y, 0x7654)) == y
    assert int(prmt(x, y, 0xBA98)) == 0xFF000000
    t4 = _table_words(BIAS)
    for w in range(16):
        codes = np.array([9, 12, 15, 8])
        unmasked = prmt(t4[w, 0], t4[w, 1],
                        sum(int(c) << (4 * i) for i, c in enumerate(codes)))
        got = pick(t4[w], selector(_word(codes)), half_mask(_word(codes)))
        want = P[w, codes] + BIAS
        assert [(int(got) >> (8 * i)) & 0xFF for i in range(4)] \
            == want.tolist()
        assert [(int(unmasked) >> (8 * i)) & 0xFF for i in range(4)] \
            != want.tolist()


@pytest.mark.parametrize("bias", [0, BIAS])
def test_register_lookup_reads_every_product(bias):
    """All 256 (a, w) pairs, four at a time, in both orientations: A_SEL
    (table column of the weight nibble, activation codes as selectors) and
    W_SEL (table row of the activation code, weight nibbles as
    selectors), each code in each of the four byte positions."""
    t4 = _table_words(bias)
    for x in range(16):
        for start in range(16):
            idx = np.array([(start + i) % 16 for i in range(4)])
            sel_word = _word(idx)                 # codes or nibbles as bytes
            got = pick(t4[x], selector(sel_word), half_mask(sel_word))
            got_b = [(int(got) >> (8 * i)) & 0xFF for i in range(4)]
            assert got_b == ((P[x, idx] + bias) & 0xFF).tolist()
            # the high nibble of a weight byte: shifted down by 4
            w_word = _word(idx << 4)
            got_hi = pick(t4[x], selector(w_word >> U32(4)),
                          half_mask(w_word >> U32(4)))
            assert int(got_hi) == int(got)


def _lanes_gemm(a_q, w_km, plan):
    """A whole GEMM as the kernel's register path computes it, in the
    orientation of the plan's CTA tile (A_SEL at 64 rows, else W_SEL): per
    split,
    chunks of CH packed rows; per packed row the two planes' picks added
    bytewise (one 32-bit add; no carry), the even and odd bytes widened by
    prmt into 16-bit lanes, the lanes flushed into int32 after each chunk,
    2 * BIAS per packed row off each sum at the end, the splits added."""
    M, _ = a_q.shape
    Kh, N = w_km.shape
    lookup = "a_sel" if plan.bm == 64 else "w_sel"
    Mp, Np = -(-M // 4) * 4, -(-N // 4) * 4
    codes = np.zeros((Mp, 2 * Kh), np.int64)
    codes[:M] = _codes(a_q, Kh)
    w = np.zeros((Kh, Np), np.int64)
    w[:, :N] = w_km
    t4 = _table_words(BIAS)
    total = np.zeros((Mp, Np), np.int64)
    for rng in _ranges(plan, Kh):
        acc = np.zeros((Mp, Np), np.int64)
        for c0 in range(rng.start, rng.stop, CH):
            ev = np.zeros((Mp // 4, Np) if lookup == "a_sel"
                          else (Mp, Np // 4), U32)
            od = np.zeros_like(ev)
            for r in range(c0, min(c0 + CH, rng.stop)):
                if lookup == "a_sel":
                    # selectors: 4 rows' codes; table column: weight nibble
                    s = np.zeros_like(ev)
                    for p, nib in ((0, w[r] & 0xF), (1, w[r] >> 4)):
                        cw = _word(codes[:, p * Kh + r].reshape(-1, 4))
                        s = s + pick(t4[nib][None, :, :],
                                     selector(cw)[:, None],
                                     half_mask(cw)[:, None])
                else:
                    # selectors: 4 columns' nibbles; table row: the code
                    wd = _word(w[r].reshape(-1, 4))
                    s = np.zeros_like(ev)
                    for p, word in ((0, wd), (1, wd >> U32(4))):
                        s = s + pick(t4[codes[:, p * Kh + r]][:, None, :],
                                     selector(word)[None, :],
                                     half_mask(word)[None, :])
                assert (s >> U32(32)).max() == 0
                ev = ev + prmt(s, 0, 0x4240)
                od = od + prmt(s, 0, 0x4341)
            assert max(ev.max(), od.max()) < 1 << 32
            assert ((ev & U32(0xFFFF)) < 1 << 16).all()
            e0, e2 = (ev & U32(0xFFFF)).astype(np.int64), (ev >> U32(16))
            o1, o3 = (od & U32(0xFFFF)).astype(np.int64), (od >> U32(16))
            lanes = (e0, o1, e2.astype(np.int64), o3.astype(np.int64))
            for i, lane in enumerate(lanes):
                if lookup == "a_sel":
                    acc[i::4, :] += lane
                else:
                    acc[:, i::4] += lane
        acc -= 2 * BIAS * len(rng)
        total += acc
    return total[:M, :N]


@pytest.mark.parametrize("M,K,N", [(1, 57, 34), (5, 37, 12), (9, 301, 20),
                                   (16, 130, 128), (17, 130, 128),
                                   (33, 57, 34), (64, 301, 20),
                                   (65, 37, 12)])
def test_register_lookup_gemm_equals_the_jax_package(monkeypatch, M, K, N):
    """Both paths (W_SEL at M <= 16, A_SEL above), odd K, N not a multiple
    of 16, more than one chunk (K = 301: 151 packed rows) and M = 16 / 17
    at the path boundary, through the XLA twin."""
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    a_q, a_s, w_km, w_s = _case(M, K, N, seed=7 * M + K)
    want = np.asarray(jops.lut4_matmul_kmajor(
        *(jnp.asarray(t) for t in (a_q, a_s, w_km, w_s))))
    acc = _lanes_gemm(a_q, w_km, lut4_plan(M, K, N, w_km.shape[0]))
    assert np.array_equal(_epilogue(acc, a_s, w_s).numpy(), want)


def test_register_lookup_lanes_hold_the_largest_products():
    """Every product at its largest (-8 x -8 = 64, 120 biased): a chunk of
    CH rows fills a lane to 2 * 120 * CH < 2^16, and the sums stay exact."""
    K, N = 2 * 200, 16
    w_km = np.full((K // 2, N), 0x88, np.uint8)
    for M in (8, 64):                     # W_SEL, A_SEL
        a_q = np.full((M, K), -8, np.int8)
        plan = dataclasses.replace(lut4_plan(M, K, N, K // 2),
                                   rows=K // 2, splits=1)
        acc = _lanes_gemm(a_q, w_km, plan)
        assert (acc == 64 * K).all(), M
