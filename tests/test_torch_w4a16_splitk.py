"""The W4A16 kernel's split-K decode path (M <= 16), checked without a GPU:
its plan (``splitk_plan``: the splits cover the packed rows once, a grouped
split stays inside one group of each plane, and a decode launch fills the
card), and its arithmetic, summed here in plain PyTorch split by split as
the kernel sums it, against the JAX package's ``w4a16_matmul`` through its
XLA twin on the same seeded numpy inputs.

Tolerance: chip_smoke.W4A16_RTOL (1e-4) of the output's largest
magnitude, the bound the card holds the kernel to against its plain
version: both sum exact products in f32 and differ by the order of the
sums.
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels.packing import (  # noqa: E402
    nmajor_to_kmajor_grouped, unpack_kmajor)
from repro_torch.kernels.w4a16_matmul import (  # noqa: E402
    SPLITK_MAX_M, SPLITK_TARGET_CTAS, splitk_plan)

RNG = np.random.default_rng(20261018)
#: qwen2-0.5b's projections (K, N) and the card's SMs
MAIN_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
SMS = 132
#: test_torch_cuda.py's odd shapes (M, K, N, G); G = K is per channel
ODD = [(9, 130, 50, 130), (1, 77, 24, 77), (16, 192, 32, 64),
       (100, 512, 130, 128), (33, 96, 40, 32)]


def _w4a16_rtol():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.W4A16_RTOL


def _kh(K, G):
    """Packed rows: per channel K rounded up to even, grouped to 2G."""
    if G >= K:
        return -(-K // 2)
    return -(-K // (2 * G)) * G


def _ranges(plan, Kh):
    return [range(s * plan.rows, min((s + 1) * plan.rows, Kh))
            for s in range(plan.splits)]


PLAN_CASES = ([(M, K, N, G) for M in (1, 8, 16) for K, N in MAIN_KN
               for G in (K, 128)] + ODD)


@pytest.mark.parametrize("M,K,N,G", PLAN_CASES)
def test_splitk_plan_covers_rows_once_inside_groups(M, K, N, G):
    if M > SPLITK_MAX_M:                  # the tiled kernel's rows
        with pytest.raises(ValueError):
            splitk_plan(M, N, _kh(K, G), G)
        return
    grouped = G < K
    Kh = _kh(K, G)
    plan = splitk_plan(M, N, Kh, G if grouped else 0)
    assert plan.vec == (16 if N % 16 == 0 else 1)
    assert 1 <= plan.rows <= 128 and plan.mt in (1, 2, 4, 8)
    assert plan.mt == min(1 << (M - 1).bit_length(),
                          2 if plan.vec == 16 else 8)
    assert plan.ctas == -(-N // plan.bn) * plan.splits * -(-M // plan.mt)
    rngs = _ranges(plan, Kh)
    assert all(len(r) > 0 for r in rngs)
    assert [r for rng in rngs for r in rng] == list(range(Kh))
    if grouped:
        for rng in rngs:
            assert len({r // G for r in rng}) == 1
            assert len({(Kh + r) // G for r in rng}) == 1
    assert splitk_plan(M, N, Kh, G if grouped else 0,
                       aligned=False).vec == 1


@pytest.mark.parametrize("K,N", MAIN_KN)
@pytest.mark.parametrize("grouped", [False, True])
def test_splitk_plan_fills_the_card_at_decode(K, N, grouped):
    """At M = 8 (the serving decode step's rows) every main-path shape
    launches at least one CTA per SM, the two large ones two; the
    (896, 128) projection gets as many as one split of 16 rows (one per
    row lane of the CTA) allows."""
    G = 128 if grouped else 0
    plan = splitk_plan(8, N, _kh(K, G or K), G)
    if N == 128:
        assert plan.rows == 16 and plan.splits == -(-_kh(K, G or K) // 16)
    else:
        assert plan.ctas >= SMS
    if (K, N) in ((896, 4864), (4864, 896)):
        assert plan.ctas >= 2 * SPLITK_TARGET_CTAS


def _splitk_sum(x, w_km, w_scale, G, plan):
    """The kernel's arithmetic, split by split: per split the f32 sum of
    x * q over its rows of each plane; grouped, each plane's sum times its
    group's scale (0 for a padding group); then the splits added in split
    order and, per channel, the total times s[n]."""
    M, K = x.shape
    Kh, N = w_km.shape
    q = unpack_kmajor(w_km).to(torch.float32)          # [2 Kh, N]
    xf = torch.zeros((M, 2 * Kh), dtype=torch.float32)
    xf[:, :K] = x.to(torch.float32)
    out = torch.zeros((M, N), dtype=torch.float32)
    for rng in _ranges(plan, Kh):
        lo = slice(rng.start, rng.stop)
        hi = slice(Kh + rng.start, Kh + rng.stop)
        s_lo = xf[:, lo] @ q[lo]
        s_hi = xf[:, hi] @ q[hi]
        if w_scale.ndim == 3:
            n_groups = w_scale.shape[0]
            g_lo, g_hi = rng.start // G, (Kh + rng.start) // G
            part = s_lo * w_scale[g_lo, 0]
            if g_hi < n_groups:
                part = part + s_hi * w_scale[g_hi, 0]
        else:
            part = s_lo + s_hi
        out = out + part
    return out if w_scale.ndim == 3 else out * w_scale[0]


SUM_CASES = ([(M, K, N, G) for M in (1, 8, 16) for K, N in MAIN_KN
              for G in (K, 128)] + [c for c in ODD if c[0] <= SPLITK_MAX_M])


@pytest.mark.parametrize("M,K,N,G", SUM_CASES)
def test_splitk_sum_matches_the_jax_package(monkeypatch, M, K, N, G):
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    rtol = _w4a16_rtol()
    w = RNG.standard_normal((K, N + N % 2)).astype(np.float32) * 0.02
    qg, sg = jq.group_quantize(jnp.asarray(w), G)
    wp = np.asarray(jq.pack_int4(qg, axis=-1))
    sg = np.asarray(sg)
    w_scale = torch.from_numpy(sg.copy())
    w_km = nmajor_to_kmajor_grouped(torch.from_numpy(wp.copy()), w_scale)
    Kh = w_km.shape[0]
    assert Kh == _kh(K, G)
    grouped = w_scale.ndim == 3
    plan = splitk_plan(M, w_km.shape[1], Kh, G if grouped else 0)
    x = RNG.standard_normal((M, K)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jops.w4a16_matmul(jnp.asarray(x).astype(jdt),
                                            jnp.asarray(wp), jnp.asarray(sg),
                                            G))
        got = _splitk_sum(torch.from_numpy(x).to(tdt), w_km, w_scale, G,
                          plan).numpy()
        err = np.abs(got - want).max()
        assert err <= rtol * np.abs(want).max(), (tdt, err)
