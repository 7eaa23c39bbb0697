"""The W4A16 kernel's tensor-core prefill path (M > 16, bf16 x), checked
without a GPU: which rounding it follows, the rule that picks its kernel
and load widths (``prefill_plan``), its nibble-to-bf16 widening, and its
arithmetic (k-step by k-step, as ``w4a16_mma_kernel`` sums), against the
JAX package on the same seeded numpy inputs.

The rounding (a) closes ROADMAP Queue 3 item 12: the JAX package computes
W4A16 three ways.  Its Pallas kernel (run here in interpret mode, as its
own tests run it on the CPU) contracts bf16 x on the matrix unit with f32
sums and scales after the contraction; its XLA twin (``ref``) dequantizes
the weight in f32 and runs one f32 matmul; its CPU packed branch
(``qlinear._packed_backend``) rounds the dequantized weight to bf16 and
returns bf16.  A bf16 value times an int4 value is exact in f32, so the
first two, the port's plain version and a bf16 ``mma.sync`` with f32 sums
compute the same exact products and differ only by f32 rounding in the
order of the sums (limit 1e-5 of the output's largest magnitude, measured
~1e-6); the third is a bf16 rounding away (at least 1e-4).  The port
follows the first two.

The arithmetic test (d) is held to chip_smoke.W4A16_RTOL (1e-4), the bound
the card holds the kernel to against its plain version.
"""

import functools
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import qlinear as jql  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels.packing import (  # noqa: E402
    nmajor_to_kmajor_grouped, unpack_kmajor)
from repro_torch.kernels.w4a16_matmul import (  # noqa: E402
    MMA_K, PrefillPlan, prefill_plan, w4a16_matmul_plain)

ROOT = Path(__file__).resolve().parent.parent
CU = ROOT / "src" / "repro_torch" / "csrc" / "w4a16_matmul.cu"
#: agreement of the Pallas kernel, its twin and the port's plain version
SAME_RTOL = 1e-5
#: the least distance of the dequantize-then-bf16 branch from them
BF16_BRANCH_MIN = 1e-4
#: the tensor-core kernel's k-step: BKH = 32 packed rows, 16 where a
#: grouped G % 32 != 0 (csrc/w4a16_matmul.cu)
KSTEP = 32


def _w4a16_rtol():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.W4A16_RTOL


def _group(K, grouped):
    """The group size of a case: 128 where it divides K, else 64; K per
    channel."""
    if not grouped:
        return K
    return 128 if K % 128 == 0 else 64


@functools.lru_cache(maxsize=None)
def _case(M, K, N, G, pallas):
    """Seeded inputs and the JAX package's three results, built once per
    case: (x f32 bf16-valued [M, K], interleaved weight, scale, {name:
    result})."""
    rng = np.random.default_rng(M * 100003 + K * 101 + N * 7 + G)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.02
    qg, sg = jq.group_quantize(jnp.asarray(w), G)
    wp = jq.pack_int4(qg, axis=-1)
    xb = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    out = {"twin": np.asarray(jref.w4a16_matmul_ref(xb, wp, sg, G))}
    if pallas:
        out["pallas"] = np.asarray(jops.w4a16_matmul(xb, wp, sg, G,
                                                     interpret=True))
        cfg = jql.QuantConfig(backend="w4a16_packed",
                              group_size=G if sg.ndim == 3 else 0)
        out["bf16_branch"] = np.asarray(jql._packed_backend(
            {"packed": wp, "scale": sg}, xb, cfg, "").astype(jnp.float32))
    return (np.asarray(xb.astype(jnp.float32)), np.asarray(wp),
            np.asarray(sg), out)


def _port(x, wp, sg):
    w_scale = torch.from_numpy(sg.copy())
    w_km = nmajor_to_kmajor_grouped(torch.from_numpy(wp.copy()), w_scale)
    return torch.from_numpy(x.copy()).to(torch.bfloat16), w_km, w_scale


ROUNDING_CASES = [(M, K, N, grouped) for grouped in (True, False)
                  for M in (32, 64) for K in (896, 192) for N in (256, 40)]


# -------------------------------------------------------- (a) rounding --
@pytest.mark.parametrize("M,K,N,grouped", ROUNDING_CASES)
def test_rounding_pallas_twin_and_plain_agree(monkeypatch, M, K, N, grouped):
    """Closes ROADMAP Queue 3 item 12: the tensor-core path follows the
    Pallas kernel, which its twin and the port's plain version match to
    f32 rounding; only the dequantize-then-bf16 branch differs."""
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    G = _group(K, grouped)
    x, wp, sg, jax_out = _case(M, K, N, G, True)
    assert (sg.ndim == 3) == grouped
    xt, w_km, w_scale = _port(x, wp, sg)
    plain = w4a16_matmul_plain(xt, w_km, w_scale, G).numpy()
    ref = jax_out["pallas"]
    top = np.abs(ref).max()
    for name, got in (("twin", jax_out["twin"]), ("port plain", plain)):
        err = np.abs(got - ref).max() / top
        assert err <= SAME_RTOL, (name, err)
    err = np.abs(jax_out["bf16_branch"] - ref).max() / top
    assert err >= BF16_BRANCH_MIN, err


# ------------------------------------------------------- (b) path rule --
MAIN_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


def _kh(K, G):
    """Packed rows: per channel K rounded up to even, grouped to 2G."""
    if G >= K:
        return -(-K // 2)
    return -(-K // (2 * G)) * G


#: the main shapes take 16-byte loads; 64-row CTA tiles only where they
#: still launch 132 CTAs: N = 4864 from M = 128 (2 x 76 tiles) on
MAIN_PATHS = [(M, K, N, G, PrefillPlan(
    "mma", 64 if N == 4864 and M >= 128 else 32, 16, 16))
    for M in (17, 32, 64, 128, 256) for K, N in MAIN_KN for G in (0, 128)]
#: test_torch_cuda.py's odd shapes at M > 16 (G = 0: per channel), with
#: the load widths their alignment allows, and the FFMA groups
ODD_PATHS = [
    (33, 130, 50, 0, PrefillPlan("mma", 32, 2, 1)),   # Kh 65, N % 16 != 0
    (17, 77, 24, 0, PrefillPlan("mma", 32, 2, 1)),    # odd K
    (64, 192, 32, 64, PrefillPlan("mma", 32, 16, 16)),
    (100, 512, 130, 128, PrefillPlan("mma", 32, 16, 1)),
    (33, 96, 40, 32, PrefillPlan("mma", 32, 16, 1)),
    (300, 896, 6, 0, PrefillPlan("mma", 32, 16, 1)),
    (64, 904, 896, 0, PrefillPlan("mma", 32, 2, 16)),  # Kh 452 % 8 != 0
    (64, 192, 896, 48, PrefillPlan("mma", 32, 16, 16)),  # 16-row steps
    (64, 192, 896, 24, PrefillPlan("ffma", 64, 2, 1)),  # G % 16 != 0
    (255, 120, 50, 40, PrefillPlan("ffma", 64, 2, 1)),
]


@pytest.mark.parametrize("M,K,N,G,want", MAIN_PATHS + ODD_PATHS)
def test_prefill_plan_picks_kernel_and_loads(M, K, N, G, want):
    Kh = _kh(K, G or K)
    assert prefill_plan(M, K, N, Kh, G) == want
    # f32 x always stays on FFMA (a bf16 contraction would round it)
    assert prefill_plan(M, K, N, Kh, G, x_bf16=False) == PrefillPlan(
        "ffma", 64, 4, 1)
    if want.kernel == "mma":
        # an unaligned pointer narrows only its own operand's loads
        assert prefill_plan(M, K, N, Kh, G, x_aligned=False) == PrefillPlan(
            "mma", want.bm, 2, want.w_vec)
        assert prefill_plan(M, K, N, Kh, G, w_aligned=False) == PrefillPlan(
            "mma", want.bm, want.x_vec, 1)
    assert (want.kernel == "mma") == (G % MMA_K == 0)


@pytest.mark.parametrize("M,N,bm", [(128, 4864, 64), (64, 4864, 32),
                                    (576, 896, 32), (640, 896, 64),
                                    (4224, 128, 64), (4160, 128, 32)])
def test_prefill_plan_row_tile_fills_the_card(M, N, bm):
    """64-row tiles where they launch at least one CTA per SM (132), else
    32: ceil(M / 64) * ceil(N / 64) against 132 at both sides of it."""
    assert prefill_plan(M, 896, N, 448, 0).bm == bm


@pytest.mark.parametrize("M", [1, 8, 16])
def test_prefill_plan_refuses_decode_rows(M):
    with pytest.raises(ValueError):
        prefill_plan(M, 896, 896, 448, 0)


# ------------------------------------------------------- (c) widening --
def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes of (y << 32) | x."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _cu_constants():
    src = CU.read_text()
    bits = re.search(r"WIDEN_BITS = (0x[0-9A-Fa-f]+)u;", src)
    bias = re.search(r"WIDEN_BIAS = ([0-9.]+)f;", src)
    sels = re.findall(r"widen_pair\(u\[p\], (0x[0-9A-Fa-f]+)u\)", src)
    assert bits and bias and sels, "the widening's constants moved"
    return int(bits.group(1), 16), float(bias.group(1)), sorted(
        {int(s, 16) for s in sels})


def test_widening_constants_give_the_signed_nibble_for_every_byte():
    """0x4300 | (nib ^ 8) as bf16 bits is 128 + (nib ^ 8); minus 136 it is
    the signed nibble, for both planes of all 256 bytes, and the planar
    unpack agrees."""
    bits, bias, _ = _cu_constants()
    assert (bits, bias) == (0x4300, 136.0)
    b = torch.arange(256, dtype=torch.int32)
    f = b ^ 0x88
    want = {"lo": ((b & 0xF) ^ 8) - 8, "hi": ((b >> 4) ^ 8) - 8}
    for plane, u in (("lo", f & 0xF), ("hi", f >> 4)):
        h = (bits | u).to(torch.int16).view(torch.bfloat16)
        assert torch.equal(h.float(), 128.0 + u.float())
        got = h - torch.tensor(bias, dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.float(), want[plane].float()), plane
    q = unpack_kmajor(b.to(torch.uint8).reshape(1, 256))
    assert torch.equal(q[0].int(), want["lo"]) and torch.equal(
        q[1].int(), want["hi"])


def test_widening_pairs_from_ldmatrix_trans():
    """ldmatrix.trans of the packed byte tile as b16 gives a lane the bytes
    w[k0][2c], w[k0][2c + 1], w[k1][2c], w[k1][2c + 1] in one word; the
    kernel's two selectors pair (k0, k1) of column 2c and of column 2c + 1,
    each byte under WIDEN_BITS >> 8, so after the subtract the word gives
    the B fragments (low half k0) of both columns, both planes, equal to
    the planar unpack of the tile."""
    bits, bias, sels = _cu_constants()
    assert sels == [0x4240, 0x4341]
    rng = np.random.default_rng(3)
    tile = torch.from_numpy(rng.integers(0, 256, (2, 64)).astype(np.uint8))
    tile[:, :4] = torch.tensor([[0x00, 0xFF, 0x80, 0x08],
                                [0x77, 0x88, 0x7F, 0xF7]], dtype=torch.uint8)
    q = unpack_kmajor(tile).int()          # [4, 64]: rows k0, k1, then high
    for c in range(32):
        b = [int(v) for v in (tile[0, 2 * c], tile[0, 2 * c + 1],
                              tile[1, 2 * c], tile[1, 2 * c + 1])]
        word = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24
        f = word ^ 0x88888888
        for plane, shift in ((0, 0), (1, 4)):
            u = (f >> shift) & 0x0F0F0F0F
            for parity, sel in enumerate(sels):
                v = _byte_perm(u, bits >> 8, sel)
                h = torch.tensor([v & 0xFFFF, v >> 16], dtype=torch.int32).to(
                    torch.int16).view(torch.bfloat16) - bias
                n = 2 * c + parity
                want = [q[2 * plane, n].item(), q[2 * plane + 1, n].item()]
                assert h.float().tolist() == want, (c, plane, parity)


# ----------------------------------------------------- (d) arithmetic --
def _mma_sum(x, w_km, w_scale, G):
    """The tensor-core kernel's arithmetic, k-step by k-step: f32 sums of
    the exact products x * q over each step's rows of each plane; grouped,
    each plane's partial for the current group scaled at the group's last
    step (0 for a padding group) and added to the total; per channel both
    planes into one sum, times s[n] at the end."""
    M, K = x.shape
    Kh, N = w_km.shape
    grouped = w_scale.ndim == 3
    kstep = 16 if grouped and G % KSTEP else KSTEP
    q = unpack_kmajor(w_km).to(torch.float32)          # [2 Kh, N]
    xf = torch.zeros((M, 2 * Kh), dtype=torch.float32)
    xf[:, :K] = x.to(torch.float32)
    part = [torch.zeros((M, N)), torch.zeros((M, N))]
    total = torch.zeros((M, N))
    for r0 in range(0, Kh, kstep):
        lo = slice(r0, min(r0 + kstep, Kh))
        hi = slice(Kh + lo.start, Kh + lo.stop)
        part[0] = part[0] + xf[:, lo] @ q[lo]
        part[1 if grouped else 0] = part[1 if grouped else 0] \
            + xf[:, hi] @ q[hi]
        if grouped and (r0 + kstep) % G == 0:
            g_lo, g_hi = r0 // G, (Kh + r0) // G
            s_hi = (w_scale[g_hi, 0] if g_hi < w_scale.shape[0]
                    else torch.zeros(N))
            total = total + (part[0] * w_scale[g_lo, 0] + part[1] * s_hi)
            part = [torch.zeros((M, N)), torch.zeros((M, N))]
    return total if grouped else part[0] * w_scale[0]


SUM_CASES = ([(M, K, N, _group(K, grouped)) for M, K, N, grouped
              in ROUNDING_CASES]
             + [(33, 192, 40, 48), (64, 96, 40, 32), (17, 77, 24, 77),
                (100, 512, 130, 128)])


@pytest.mark.parametrize("M,K,N,G", SUM_CASES)
def test_mma_sum_matches_the_jax_package(monkeypatch, M, K, N, G):
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    # the rounding cases reuse their Pallas runs; the others the twin's
    pallas = (M, K, N, G) in SUM_CASES[:len(ROUNDING_CASES)]
    x, wp, sg, jax_out = _case(M, K, N, G, pallas)
    xt, w_km, w_scale = _port(x, wp, sg)
    got = _mma_sum(xt, w_km, w_scale, G).numpy()
    for name, want in jax_out.items():
        if name == "bf16_branch":
            continue
        err = np.abs(got - want).max()
        assert err <= _w4a16_rtol() * np.abs(want).max(), (name, err)
