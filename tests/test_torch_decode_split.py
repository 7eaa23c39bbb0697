"""The split-context decode kernels (``csrc/paged_decode.cu``,
``csrc/ragged_decode.cu``, body in ``csrc/decode_common.cuh``), checked
without a GPU: their split rule and their arithmetic emulated in PyTorch on
the CPU against the JAX package on the same seeded numpy inputs.

(a) ``decode_plan``: for page sizes 1, 4, 12 and 16 and every table width
from 3 to 4096 tokens, a split is a whole number of pages, at least
min(64, width) tokens, at most 8 splits cover the width, and the rule
takes the fewest tokens that satisfy both; the serving shape's plan; the
mirror of the rule and of its constants in the CUDA source; the paged and
the ragged wrappers get one plan for one table width.

(b) ``emulate`` repeats the kernels' arithmetic: each (row, KV head)'s
splits, each split's live range (its tokens cut to [lp - window + 1, lp])
walked 64 tokens a round, the QK dot as one f32 FMA chain over the dims
rounded to bf16 and then scaled, the round's online softmax (the max, the
exponentials, their sum by the warp's butterfly with tokens j and j + 32 in
lane j, l = l * alpha + sum), PV as one FMA chain in token order, an empty
partial (m = -1e30, l = 0, acc = 0) for a split with no live token, and
the merge of the splits in rank order (each scaled by exp(m_r - M), summed
by FMA, divided by L), rows with lp < 0 exactly zero.  FMA is emulated in
float64 (exact products, one rounding but for rare double roundings).  It
is held to the JAX package's XLA twin and its Pallas kernel in interpret
mode, as ``tests/test_paged_attention.py`` runs them, and to the port's
plain version, at every shape the kernels are built for (H, KV, HD):
(14, 2, 64) qwen2-0.5b, (32, 8, 128) qwen3-4b, (12, 2, 128) qwen2-vl-2b,
(36, 4, 128) starcoder2-7b's G = 9 and (32, 32, 64) musicgen-large's
G = 1.  At HD 128 a lane holds four dims of PV and, at G = 9, a thread
three heads of QK and a warp two heads: each dim's FMA chain is the same.
The built shapes mirror the kernel source, and the wrappers refuse any
other before launching.

Tolerance: ATOL = 2e-2 on bf16 outputs, the bound the card check
(``chip_smoke.ATTN_ATOL``) and the JAX package's own tests hold the online
softmax to (it sums in another order than the two-pass twin, and a QK dot
can round to a neighbouring bf16 score).
"""

import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.models.attention import quantize_kv as jquantize_kv  # noqa: E402
from repro_torch.kernels import ragged_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    DECODE_CHUNK, DECODE_MAX_GROUP, DECODE_MAX_SPLITS,
    DECODE_MIN_SPLIT_TOK, NEG_INF,
    _dequant_slab, decode_plan, decode_plan_for,
    paged_decode_attention_plain)
from repro_torch.kernels.ragged_attention import \
    ragged_decode_attention_plain  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CUH = ROOT / "src" / "repro_torch" / "csrc" / "decode_common.cuh"
ATOL = 2e-2
#: qwen2-0.5b's attention: 14 query heads over 2 KV heads, head dim 64
H, KV, HD = 14, 2, 64
#: the decode kernels' shapes (H, KV, HD): qwen2-0.5b's (G = 7), qwen3-4b's
#: (G = 4), qwen2-vl-2b's (G = 6), starcoder2-7b's (G = 9, the most a KV
#: head at hd 128) and musicgen-large's (G = 1 at hd 64)
SHAPES = [(H, KV, HD), (32, 8, 128), (12, 2, 128), (36, 4, 128),
          (32, 32, 64)]
SHAPE_IDS = [f"{h}x{kv}x{hd}" for h, kv, hd in SHAPES]


# ----------------------------------------------------------- (a) plan ----
@pytest.mark.parametrize("ps", [1, 4, 12, 16])
def test_plan_properties_every_width(ps):
    for width in range(max(3, ps), 4097):
        if width % ps:
            continue
        plan = decode_plan(width, ps)
        least = min(DECODE_MIN_SPLIT_TOK, width)
        assert plan.split_tok % ps == 0 and plan.split_tok >= least
        assert 1 <= plan.nsplit <= DECODE_MAX_SPLITS
        assert (plan.nsplit - 1) * plan.split_tok < width \
            <= plan.nsplit * plan.split_tok
        assert plan.pages == plan.split_tok // ps
        # the fewest tokens: one page fewer breaks a rule
        fewer = plan.split_tok - ps
        assert fewer < least or -(-width // fewer) > DECODE_MAX_SPLITS


def test_plan_at_the_serving_shapes():
    # max_ctx 512, ps 16: 8 splits of 64 tokens, (8, 2, 8) = 128 CTAs
    # at batch 8 with qwen2-0.5b's 2 KV heads, within 132 SMs
    plan = decode_plan(512, 16)
    assert (plan.split_tok, plan.nsplit, plan.pages) == (64, 8, 4)
    assert 8 * KV * plan.nsplit == 128 <= 132
    # a 2,048-token table: splits of more than 64 tokens
    assert decode_plan(2048, 16).split_tok == 256
    assert decode_plan(2048, 16).nsplit == 8
    # tables narrower than 64 tokens: one split of the whole width
    assert decode_plan(48, 16).nsplit == 1
    assert decode_plan(3, 1).split_tok == 3


def _c_split_plan(width, ps):
    """csrc/decode_common.cuh::split_plan, statement by statement."""
    lo = (width + DECODE_MAX_SPLITS - 1) // DECODE_MAX_SPLITS
    least = width if width < DECODE_MIN_SPLIT_TOK else DECODE_MIN_SPLIT_TOK
    lo = max(lo, least)
    split_tok = (lo + ps - 1) // ps * ps
    return split_tok, (width + split_tok - 1) // split_tok


def test_plan_mirrors_the_kernel_source():
    src = CUH.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("MIN_SPLIT_TOK") == DECODE_MIN_SPLIT_TOK
    assert const("MAX_SPLITS") == DECODE_MAX_SPLITS
    assert const("CHUNK") == DECODE_CHUNK
    body = src[src.index("inline void split_plan("):]
    body = body[:body.index("\n}\n")]
    for stmt in ("int lo = (width + MAX_SPLITS - 1) / MAX_SPLITS;",
                 "const int least = width < MIN_SPLIT_TOK ? width : "
                 "MIN_SPLIT_TOK;",
                 "if (lo < least) lo = least;",
                 "*split_tok = (lo + ps - 1) / ps * ps;",
                 "*nsplit = (width + *split_tok - 1) / *split_tok;"):
        assert stmt in body, stmt
    for ps in (1, 4, 12, 16):
        for width in range(ps, 4097, ps):
            plan = decode_plan(width, ps)
            assert _c_split_plan(width, ps) == (plan.split_tok, plan.nsplit)


@pytest.mark.parametrize("ps,pps", [(1, 3), (4, 40), (16, 32), (16, 128)])
def test_paged_and_ragged_get_one_plan(ps, pps):
    """Both wrappers call decode_plan_for, whose plan depends on the
    table's width alone: a decode-only ragged pack (its table holds
    max_batch rows) and the paged batch (B rows) split alike."""
    assert ragged_attention.decode_plan_for is decode_plan_for
    pool = torch.zeros((5, ps, KV, HD), dtype=torch.bfloat16)
    plans = {decode_plan_for(torch.zeros((rows, pps), dtype=torch.int32),
                             pool) for rows in (1, 6, 8, 64)}
    assert plans == {decode_plan(pps * ps, ps)}


def test_built_shapes_mirror_the_kernel_source():
    """The wrappers' built (head dim, G) set is the one the kernel source
    instantiates and its entry points accept (`shape_ok`)."""
    src = CUH.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert DECODE_MAX_GROUP == {const("HD_SMALL"): const("MAXG_SMALL"),
                                const("HD_LARGE"): const("MAXG_LARGE")}
    for f in ("paged_decode.cu", "ragged_decode.cu"):
        assert "!shape_ok(hd, H, KV)" in (CUH.parent / f).read_text(), f


@pytest.mark.parametrize("shape", [(12, 2, 96), (34, 2, 128), (18, 2, 64),
                                   (40, 4, 128), (8, 8, 256)],
                         ids=["hd96", "g17", "hd64-g9", "g10", "hd256"])
@pytest.mark.parametrize("which", ["paged", "ragged"])
def test_wrappers_refuse_an_unbuilt_shape(shape, which):
    """A shape the kernels are not built for raises, naming the shape,
    before anything is launched (here: before the operands' device is
    looked at): no quiet switch to the plain version."""
    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.ragged_attention import \
        ragged_decode_attention_cuda

    nh, nkv, hd = shape
    q = torch.zeros((2, nh, hd), dtype=torch.bfloat16)
    pool = torch.zeros((4, 16, nkv, hd), dtype=torch.bfloat16)
    tbl = torch.zeros((2, 2), dtype=torch.int32)
    lp = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"head dim {hd} with {nh // nkv} "
                                         "query heads per KV head is not "
                                         "built"):
        if which == "paged":
            paged_decode_attention_cuda(q, pool, pool, tbl, lp)
        else:
            ragged_decode_attention_cuda(q, pool, pool, tbl, lp, lp)


# ------------------------------------------------------ (b) arithmetic ----
def _fma_chain(acc, a, b):
    """fma(a, b, acc) in f32, through float64 (exact products)."""
    return (acc.double() + a.double() * b.double()).float()


def emulate(q, k, v, tbl, last_pos, k_scale=None, v_scale=None,
            window: int = 0):
    """The decode kernels' arithmetic on CPU tensors: q [B, H, HD] bf16,
    pools as the kernels take them, tbl [B, pps] int32, last_pos [B]."""
    B, Hq, hd = q.shape
    P, ps, nkv = k.shape[:3]
    pps = tbl.shape[1]
    G = Hq // nkv
    W = pps * ps
    plan = decode_plan(W, ps)
    ns, st, CH = plan.nsplit, plan.split_tok, DECODE_CHUNK
    nch = -(-st // CH)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    kf = _dequant_slab(k, k_scale, hd).float()              # [P, ps, KV, hd]
    vf = _dequant_slab(v, v_scale, hd).float()

    lp = last_pos.long()
    s0 = torch.arange(ns) * st                                      # [ns]
    t_start = (lp - window + 1).clamp(min=0) if window else 0 * lp
    t_lo = torch.maximum(s0[None], t_start[:, None])               # [B, ns]
    t_hi = torch.minimum((s0 + st).clamp(max=W)[None], lp[:, None] + 1)
    pos = (t_lo[:, :, None, None] + CH * torch.arange(nch)[:, None]
           + torch.arange(CH))                          # [B, ns, nch, CH]
    valid = pos < t_hi[:, :, None, None]
    posc = pos.clamp(0, W - 1)
    page = tbl.long()[torch.arange(B)[:, None, None, None], posc // ps] \
        .clamp(max=P - 1)
    live = valid[..., None, None]
    K = torch.where(live, kf[page, posc % ps], 0.0)  # [B, ns, nch, CH, KV, hd]
    V = torch.where(live, vf[page, posc % ps], 0.0)
    K = K.permute(0, 1, 2, 4, 3, 5)                  # [B, ns, nch, KV, CH, hd]
    V = V.permute(0, 1, 2, 4, 3, 5)
    Q = q.float().reshape(B, nkv, G, hd)[:, None, None, :, :, None, :]

    # QK: thread (token, heads), one FMA chain over the dims
    s = torch.zeros((B, ns, nch, nkv, G, CH))
    for d in range(hd):
        s = _fma_chain(s, Q[..., d], K[:, :, :, :, None, :, d])
    s = s.bfloat16().float() * scale

    # each split: the rounds' online softmax and PV (warp g = head g)
    m = torch.full((B, ns, nkv, G), NEG_INF)
    l = torch.zeros((B, ns, nkv, G))
    acc = torch.zeros((B, ns, nkv, G, hd))
    lanes = torch.arange(32)
    for c in range(nch):
        ok = valid[:, :, c][:, :, None, None, :]       # [B, ns, 1, 1, CH]
        sc = torch.where(ok, s[:, :, c], NEG_INF)      # [B, ns, KV, G, CH]
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        w = p[..., :32] + p[..., 32:]                  # lane j: j, j + 32
        for off in (16, 8, 4, 2, 1):
            w = w + w[..., lanes ^ off]
        l = l * alpha + w[..., 0]
        acc = acc * alpha[..., None]
        for j in range(CH):
            acc = _fma_chain(acc, p[..., j, None],
                             V[:, :, c, :, None, j, :])
        m = m_new

    # merge in rank order
    M = m.amax(dim=1)
    L = torch.zeros((B, nkv, G))
    A = torch.zeros((B, nkv, G, hd))
    for r in range(ns):
        f = torch.exp(m[:, r] - M)
        L = _fma_chain(L, l[:, r], f)
        A = _fma_chain(A, acc[:, r], f[..., None])
    out = torch.where(L[..., None] > 0, A / torch.where(L > 0, L, 1.0)[
        ..., None], 0.0)
    out = torch.where((lp >= 0)[:, None, None, None], out, 0.0)
    return out.reshape(B, Hq, hd).bfloat16()


def _inputs(seed, B, ps, pps, last, pool, shape=(H, KV, HD)):
    """Seeded numpy inputs, as JAX arrays and as CPU tensors: q, pools
    (bf16, or quantized per (token, head) by the JAX package's quantize_kv),
    and a table on distinct shuffled pages with sentinel (== P) entries
    past each row's last position; `shape` is (H, KV, HD)."""
    nh, nkv, hd = shape
    rng = np.random.default_rng(seed)
    P = B * pps + 3
    q32 = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k32 = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    v32 = rng.standard_normal((P, ps, nkv, hd)).astype(np.float32)
    tbl = np.full((B, pps), P, np.int32)
    pages = rng.permutation(P).astype(np.int32)
    used = 0
    for b, lp in enumerate(last):
        n = lp // ps + 1 if lp >= 0 else 0
        tbl[b, :n] = pages[used:used + n]
        used += n
    jx = {"q": jnp.asarray(q32, jnp.bfloat16), "tbl": jnp.asarray(tbl),
          "last": jnp.asarray(np.asarray(last, np.int32))}
    if pool == "bfloat16":
        jx.update(k=jnp.asarray(k32, jnp.bfloat16),
                  v=jnp.asarray(v32, jnp.bfloat16), ks=None, vs=None)
    else:
        (kq, ks), (vq, vs) = (jquantize_kv(jnp.asarray(x), pool == "int4")
                              for x in (k32, v32))
        jx.update(k=kq, v=vq, ks=ks, vs=vs)

    def to_torch(x):
        if x is None:
            return None
        a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                       else x)
        t = torch.from_numpy(np.array(a))
        return t.bfloat16() if x.dtype == jnp.bfloat16 else t

    th = {key: to_torch(val) for key, val in jx.items()}
    return jx, th


def _f32(x):
    """A JAX output as a float32 CPU tensor."""
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


#: a serving-width table (max_ctx 512, ps 16: 8 splits of 64 tokens); the
#: rows: the whole width, the last token of split 0, the first of split 1,
#: an idle row, a page boundary mid-split
LAST = [511, 63, 64, -1, 300]
CASES = [(pool, window) for pool in ("bfloat16", "int8", "int4")
         for window in (0, 21)]


_RESULTS = {}


def _results(shape):
    """{(pool, window): {name: [B, H, HD] outputs}} at `shape`: the
    emulation, the port's plain version, the JAX package's XLA twin and its
    Pallas kernel (interpret mode), computed once per shape and case."""
    if shape not in _RESULTS:
        out = {}
        for pool, window in CASES:
            jx, th = _inputs(17, len(LAST), 16, 32, LAST, pool, shape)
            args = (jx["q"], jx["k"], jx["v"], jx["tbl"], jx["last"],
                    jx["ks"], jx["vs"])
            out[(pool, window)] = {
                "emulation": emulate(th["q"], th["k"], th["v"], th["tbl"],
                                     th["last"], th["ks"], th["vs"], window),
                "plain": paged_decode_attention_plain(
                    th["q"], th["k"], th["v"], th["tbl"], th["last"],
                    th["ks"], th["vs"], window=window),
                "xla": _f32(jpa.paged_decode_attention_xla(
                    *args, window=window, pp=4)),
            }
            if (shape, pool, window, "pallas") in REF_CASES:
                out[(pool, window)]["pallas"] = _f32(
                    jpa.paged_decode_attention(*args, window=window, pp=4,
                                               interpret=True))
        _RESULTS[shape] = out
    return _RESULTS[shape]


#: (shape, pool, window, reference) of each emulation check: every case
#: at every shape against the XLA twin and the plain version; against the
#: Pallas kernel in interpret mode every case at qwen2-0.5b's shape and the
#: unwindowed ones at the others (an interpret-mode compile a case, ~1 s)
REF_CASES = [(shape, pool, window, ref) for shape in SHAPES
             for pool, window in CASES for ref in ("xla", "pallas", "plain")
             if ref != "pallas" or shape == SHAPES[0] or not window]


@pytest.mark.parametrize(
    "shape,pool,window,ref", REF_CASES,
    ids=[f"{r}-{p}-{w}-{h}x{kv}x{d}" for (h, kv, d), p, w, r in REF_CASES])
def test_emulation_matches_the_reference(shape, pool, window, ref):
    r = _results(shape)[(pool, window)]
    got = r["emulation"].float()
    assert got.shape == (len(LAST), shape[0], shape[2])
    err = (got - r[ref].float()).abs().max().item()
    assert err <= ATOL, (shape, pool, window, ref, err)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("pool,window", CASES)
def test_emulation_idle_row_is_exactly_zero(shape, pool, window):
    got = _results(shape)[(pool, window)]["emulation"]
    idle = [b for b, lp in enumerate(LAST) if lp < 0]
    assert torch.equal(got[idle], torch.zeros_like(got[idle]))
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("ps,pps,last,window", [
    # a 2,048-token table: splits of 256 tokens, four rounds each
    (16, 128, [2047, 700, 255, 256], 0),
    (16, 128, [2047, 700, 255, 256], 300),
    # pages of 12: splits of 72 tokens, a round of 64 and one of 8
    (12, 8, [95, 71, 72, 5], 0),
    # one page a token: 3 splits of 64
    (1, 130, [129, 64, 0, -1], 0),
])
def test_emulation_other_plans(ps, pps, last, window):
    """Plans with several rounds a split, rounds cut by a page size that
    does not divide 64, and splits whose live range a window cuts: the
    emulation against the XLA twin and the plain version."""
    jx, th = _inputs(23, len(last), ps, pps, last, "int8")
    got = emulate(th["q"], th["k"], th["v"], th["tbl"], th["last"], th["ks"],
                  th["vs"], window).float()
    want = _f32(jpa.paged_decode_attention_xla(
        jx["q"], jx["k"], jx["v"], jx["tbl"], jx["last"], jx["ks"], jx["vs"],
        window=window, pp=4))
    plain = paged_decode_attention_plain(
        th["q"], th["k"], th["v"], th["tbl"], th["last"], th["ks"], th["vs"],
        window=window).float()
    assert (got - want).abs().max().item() <= ATOL
    assert (got - plain).abs().max().item() <= ATOL
    idle = [b for b, lp in enumerate(last) if lp < 0]
    assert not got[idle].any()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_decode_only_ragged_pack_is_the_paged_batch(shape):
    """The plain versions: a decode-only pack (one row per slot at its last
    position) gives the paged batch's output, the property the card check
    holds the two kernels to bit for bit."""
    _, th = _inputs(29, len(LAST), 16, 32, LAST, "int4", shape)
    slots = torch.arange(len(LAST), dtype=torch.int32)
    paged = paged_decode_attention_plain(th["q"], th["k"], th["v"],
                                         th["tbl"], th["last"], th["ks"],
                                         th["vs"])
    ragged = ragged_decode_attention_plain(th["q"], th["k"], th["v"],
                                           th["tbl"], slots, th["last"],
                                           th["ks"], th["vs"])
    assert torch.equal(paged, ragged)
