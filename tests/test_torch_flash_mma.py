"""Flash prefill's tensor-core kernel (``csrc/flash_prefill.cu``), checked
without a GPU: its plan (``flash_plan``), and its arithmetic emulated in
PyTorch on the CPU against the JAX package on the same seeded numpy inputs.

(a) The plan: every (query, head) row of every (b, KV head) lies in
exactly one CTA, the shared memory fits, the rule picks the row tile, and
the CTA counts at qwen2-0.5b's serving shapes are the ones PERF.md cites.

(b) ``emulate`` repeats the kernel's arithmetic step by step: the plan's
CTAs and 16-row tiles, rows query-major (r = i * G + g), the CTA's K/V
tile range by positions, K/V tiles of ``FLASH_BK`` keys zero-filled past
Skv with position -1, each warp's slice of every tile (``key_split``
warps a row tile) and its skip, the QK dot in f32 rounded to bf16 and then
scaled, the online softmax with masked p = 0, PV as two bf16 x bf16
products (p = hi + lo) summed in f32, and the merge of the slices (the
largest row max, each slice's state scaled by exp(m_w - M), summed in
slice order, times 1 / L).  It is held to
the JAX package's Pallas kernel (interpret mode, as the JAX package's own
tests run it on the CPU) and its XLA twin.  The same test records how far
one bf16 p would move the output.

(c) The port's plain version against the Pallas kernel at hd 64 and 128
with G = 7 (``test_torch_kernels`` holds it at hd 16 against the twin).

Tolerances: the outputs are bf16.  The emulation, the plain version and
the JAX kernels sum the same f32 products in other orders, so the QK dot
can round to a neighbouring bf16 score and an output can round to the
neighbouring bf16 value; OUT_ATOL is one bf16 step at |out| in [1, 2)
(2^-7).  Measured: the emulation 4.9e-4 to 3.9e-3 from the Pallas kernel
and its twin (which agree exactly), the plain version at most 9.8e-4.
"""

import functools
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    FLASH_BK, FLASH_HEAD_DIMS, FLASH_KEY_SPLITS, FLASH_MAX_WARPS, FLASH_ROWS,
    FLASH_STAGES, FLASH_TARGET_CTAS, MAX_SMEM_BYTES, NEG_INF,
    flash_plan, flash_prefill_plain, flash_smem)

ROOT = Path(__file__).resolve().parent.parent
CU = ROOT / "src" / "repro_torch" / "csrc" / "flash_prefill.cu"
#: one bf16 step at |out| in [1, 2)
OUT_ATOL = 2.0 ** -7
#: hi + lo against an f32 p, relative to the output's largest magnitude:
#: hi + lo keeps p to 2^-17 of itself, and two f32 sums instead of one add
#: a few f32 steps (measured 1.3e-6 to 2.6e-6 over the cases)
HILO_RTOL = 2.0 ** -16
#: one bf16 p moves the output by ~2^-9 of its size (measured 7.2e-4 to
#: 1.6e-3); at least this much
SINGLE_MIN_RTOL = 2.0 ** -12

#: (B, Sq, Skv, H, KV, hd, left paddings, prefix hit, window): G = 1, 2, 7,
#: hd 64 and 128, left padding, windows, Skv not a multiple of FLASH_BK,
#: Sq = 1, and rows of one batch padded differently
CASES = {
    "g1": (2, 40, 40, 2, 2, 64, (0, 5), 0, 0),
    "g2_window": (2, 40, 40, 4, 2, 64, (0, 5), 0, 12),
    "g7_hd128": (1, 33, 33, 7, 1, 128, (4,), 0, 0),
    "g7_tail": (2, 20, 100, 14, 2, 64, (0, 3), 30, 0),
    "g7_sq1": (2, 1, 70, 7, 1, 64, (0, 0), 50, 0),
    "g7_hd128_tail_window": (1, 24, 90, 14, 2, 128, (2,), 40, 16),
}


# ----------------------------------------------------------- (a) plan ----
def _cta_rows(plan, G, Sq):
    """{(i, g): CTA} of one (b, KV head): CTA c holds rows c * rows ..
    (c + 1) * rows - 1 that are < G * Sq, row r = i * G + g."""
    seen = {}
    for c in range(plan.grid[0]):
        for r in range(c * plan.rows, min((c + 1) * plan.rows, G * Sq)):
            assert (r // G, r % G) not in seen
            seen[(r // G, r % G)] = c
    return seen


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", [
    (1, 32, 32, 14, 2, 64), (1, 256, 256, 14, 2, 64), (3, 70, 100, 14, 2, 64),
    (1, 1, 70, 7, 1, 128), (8, 256, 256, 14, 2, 64), (1, 2048, 2048, 32, 8, 128),
    (2, 17, 17, 16, 2, 128), (1, 5, 5, 1, 1, 64)])
def test_plan_covers_every_row_once_and_fits(B, Sq, Skv, H, KV, hd):
    plan = flash_plan(B, Sq, Skv, H, KV, hd)
    G = H // KV
    assert plan.rows in FLASH_ROWS and plan.key_split in FLASH_KEY_SPLITS
    assert plan.warps == plan.rows // 16 * plan.key_split <= FLASH_MAX_WARPS
    assert plan.grid == (-(-G * Sq // plan.rows), KV, B)
    assert plan.ctas == plan.grid[0] * KV * B
    assert plan.kv_tiles * plan.keys >= Skv > (plan.kv_tiles - 1) * plan.keys
    seen = _cta_rows(plan, G, Sq)
    assert set(seen) == {(i, g) for i in range(Sq) for g in range(G)}
    assert plan.smem <= MAX_SMEM_BYTES
    # the rule: the largest row tile that still fills the card, else 16;
    # hd / 4 keys a warp, as few warps a tile as MAX_WARPS needs
    fills = [r for r in FLASH_ROWS
             if -(-G * Sq // r) * KV * B >= FLASH_TARGET_CTAS]
    assert plan.rows == (fills[0] if fills else FLASH_ROWS[-1])
    split = FLASH_BK // (hd // 4)
    assert plan.key_split == min(
        split, FLASH_MAX_WARPS // (plan.rows // 16))


def test_plan_mirrors_the_kernel_source():
    src = CU.read_text()
    assert int(re.search(r"constexpr int BK = (\d+);", src).group(1)) \
        == FLASH_BK
    assert int(re.search(r"constexpr int STAGES = (\d+);", src).group(1)) \
        == FLASH_STAGES
    assert int(re.search(r"constexpr int MAX_WARPS = (\d+);", src).group(1)) \
        == FLASH_MAX_WARPS == FLASH_ROWS[0] // 16
    for hd in FLASH_HEAD_DIMS:
        assert f"case {hd}: return launch_hd<{hd}>" in src
    for ks in FLASH_KEY_SPLITS:
        kt = "BK" if ks == 1 else f"BK / {ks}"
        assert f"case {ks}: return launch<HD, {kt}>" in src
    # Smem<HD>::bytes: K and V rings of HD + 8 bf16 rows, positions and the
    # CTA's Q tile, or the merge's partials if larger
    for hd in FLASH_HEAD_DIMS:
        for rows, warps in ((16, 4), (32, 8), (128, 8), (16, 1)):
            ld = hd + 8
            assert flash_smem(hd, rows, warps) == max(
                FLASH_STAGES * 2 * FLASH_BK * ld * 2
                + FLASH_STAGES * FLASH_BK * 4 + rows * ld * 2,
                warps * 16 * (ld * 4 + 8))


@pytest.mark.parametrize("case,Sq,Skv,H,KV,hd,ctas,rows,key_split", [
    ("fresh32", 32, 32, 14, 2, 64, 28, 16, 4),
    ("fresh128", 128, 128, 14, 2, 64, 112, 16, 4),
    ("fresh256", 256, 256, 14, 2, 64, 224, 16, 4),
    ("tail", 64, 512, 14, 2, 64, 56, 16, 4),
    ("hd128", 256, 256, 32, 8, 128, 256, 32, 2)])
def test_plan_ctas_at_the_serving_shapes(case, Sq, Skv, H, KV, hd, ctas,
                                         rows, key_split):
    """chip_smoke.FLASH_CASES' shapes (B = 1); the first port ran 58
    two-warp CTAs at fresh 256."""
    plan = flash_plan(1, Sq, Skv, H, KV, hd)
    assert (plan.ctas, plan.rows, plan.key_split) == (ctas, rows, key_split)


# ------------------------------------------------------ (b) emulation ----
def _positions(B, Sq, Skv, pads, hit):
    base = np.arange(Sq, dtype=np.int32)[None] \
        - np.asarray(pads, np.int32)[:, None]
    qpos = np.where(base >= 0, base + hit, -1).astype(np.int32)
    if Skv == Sq and not hit:
        return qpos, qpos
    j = np.arange(Skv, dtype=np.int32)[None]
    last = hit + Sq - np.asarray(pads, np.int32)[:, None] - 1
    return qpos, np.where(j <= last, j, -1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Seeded bf16-valued inputs (f32 numpy) and the JAX package's Pallas
    (interpret) and XLA-twin outputs as f32."""
    B, Sq, Skv, H, KV, hd, pads, hit, window = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))

    def bf16_valued(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    q = bf16_valued((B, Sq, H, hd))
    k = bf16_valued((B, Skv, KV, hd))
    v = bf16_valued((B, Skv, KV, hd))
    qpos, kpos = _positions(B, Sq, Skv, pads, hit)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] \
        + [jnp.asarray(qpos), jnp.asarray(kpos)]
    pallas = jpa.flash_prefill(*jargs, window=window, interpret=True)
    twin = jpa.flash_prefill_xla(*jargs, window=window)
    return (q, k, v, qpos, kpos, window,
            np.asarray(pallas.astype(jnp.float32)),
            np.asarray(twin.astype(jnp.float32)))


def _pv(p, vb, how):
    """P [rows, BK] f32 times V [BK, hd] (bf16 values) with f32 sums: as two
    bf16 products (hi + lo, the kernel), one bf16 product, or f32 p."""
    if how == "f32":
        return p @ vb
    hi = p.to(torch.bfloat16).float()
    if how == "single":
        return hi @ vb
    lo = (p - hi).to(torch.bfloat16).float()
    return hi @ vb + lo @ vb


def emulate(q, k, v, qpos, kpos, window, pv="hilo"):
    """The kernel's arithmetic on f32 tensors of bf16 values -> f32
    [B, Sq, H, hd] before the output's bf16 rounding."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    plan = flash_plan(B, Sq, Skv, H, KV, hd)
    BK, WK = plan.keys, plan.key_split
    KS = BK // WK
    scale = 1.0 / math.sqrt(hd)
    pad = plan.kv_tiles * BK - Skv
    # the edge tile: zero K/V rows at position -1
    kz = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vz = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kpz = torch.nn.functional.pad(kpos, (0, pad), value=-1)
    R = G * Sq

    def sees(qp, kp):
        ok = (kp >= 0) & (qp >= kp)
        return ok & (qp - kp < window) if window else ok

    def slice_state(wq, wp, b, hk, lo, hi, wk):
        """One warp: its 16 rows over keys wk * KS .. of tiles lo..hi."""
        wmax, wmin = wp.max(), wp[wp >= 0].min()
        m = torch.full((16,), NEG_INF)
        l = torch.zeros(16)
        acc = torch.zeros((16, hd))
        for kt in range(lo, hi + 1):
            sl = slice(kt * BK + wk * KS, kt * BK + (wk + 1) * KS)
            kb, vb, kp = kz[b, sl, hk], vz[b, sl, hk], kpz[b, sl]
            skip = (kp >= 0) & (kp <= wmax)
            if window:
                skip &= wmin - kp < window
            if not skip.any():
                continue                          # the warp's skip
            vis = sees(wp[:, None], kp[None, :])
            s = (wq @ kb.T).to(torch.bfloat16).float() * scale
            s = torch.where(vis, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=1))
            alpha = torch.exp(m - m_new)
            p = torch.where(vis, torch.exp(s - m_new[:, None]), 0.0)
            l = l * alpha + p.sum(dim=1)
            acc = acc * alpha[:, None] + _pv(p, vb, pv)
            m = m_new
        return m, l, acc

    out = torch.zeros((B, Sq, H, hd))
    for b in range(B):
        for hk in range(KV):
            rq = q[b, :, hk * G:(hk + 1) * G].reshape(R, hd)  # r = i * G + g
            rpos = qpos[b].repeat_interleave(G)
            for c in range(plan.grid[0]):
                rows = torch.arange(c * plan.rows, (c + 1) * plan.rows)
                live = rows < R
                pos = torch.where(live, rpos[rows.clamp(max=R - 1)], -1)
                if pos.max() < 0:
                    continue
                qmax, qmin = pos.max(), pos[pos >= 0].min()
                kp_all = kpos[b]
                see = (kp_all >= 0) & (kp_all <= qmax)
                if window:
                    see &= qmin - kp_all < window
                tiles = torch.nonzero(see).flatten() // BK
                if not len(tiles):
                    continue                      # every row stays zero
                lo, hi = int(tiles.min()), int(tiles.max())
                for t in range(plan.rows // 16):
                    wr, wl = rows[16 * t:16 * t + 16], live[16 * t:16 * t + 16]
                    wp = pos[16 * t:16 * t + 16]
                    if wp.max() < 0:
                        continue
                    wq = torch.where(wl[:, None], rq[wr.clamp(max=R - 1)], 0.0)
                    parts = [slice_state(wq, wp, b, hk, lo, hi, wk)
                             for wk in range(WK)]
                    # the merge, slice by slice in order
                    M = parts[0][0]
                    for m_w, _, _ in parts[1:]:
                        M = torch.maximum(M, m_w)
                    L = torch.zeros(16)
                    O = torch.zeros((16, hd))
                    for m_w, l_w, acc_w in parts:
                        f = torch.exp(m_w - M)
                        L = L + f * l_w
                        O = O + f[:, None] * acc_w
                    res = O * (1.0 / torch.where(L > 0, L, 1.0))[:, None]
                    for j in torch.nonzero(wl).flatten().tolist():
                        r = int(wr[j])
                        out[b, r // G, hk * G + r % G] = res[j]
    return out


def _emulated(name, pv="hilo"):
    q, k, v, qpos, kpos, window, _, _ = _case(name)
    t = [torch.tensor(a) for a in (q, k, v, qpos, kpos)]
    return emulate(*t, window, pv=pv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_matches_pallas_and_twin(name):
    *_, window, pallas, twin = _case(name)
    got = _emulated(name).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, pallas, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got, twin, atol=OUT_ATOL, rtol=0)
    qpos = _case(name)[3]
    assert not got[qpos < 0].any()                # padding rows: zeros


@pytest.mark.parametrize("name", ["g7_hd128", "g7_tail"])
def test_hi_lo_split_keeps_p_and_one_bf16_p_would_not(name):
    """PV with p = hi + lo stays within HILO_RTOL of an f32 p; one bf16 p
    is at least SINGLE_MIN_RTOL away (the choice the kernel does not make)."""
    exact = _emulated(name, "f32")
    top = exact.abs().max().item()
    hilo = (_emulated(name, "hilo") - exact).abs().max().item() / top
    single = (_emulated(name, "single") - exact).abs().max().item() / top
    assert hilo <= HILO_RTOL
    assert single >= SINGLE_MIN_RTOL
    assert single > 16 * hilo


# ------------------------------------------ (c) plain vs Pallas kernel ----
@pytest.mark.parametrize("name", ["g7_hd128", "g7_tail", "g7_sq1",
                                  "g7_hd128_tail_window"])
def test_plain_matches_pallas_at_g7(name):
    q, k, v, qpos, kpos, window, pallas, _ = _case(name)
    t = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    got = flash_prefill_plain(*t, torch.tensor(qpos), torch.tensor(kpos),
                              window=window)
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=OUT_ATOL,
                               rtol=0)
