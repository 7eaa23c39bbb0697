"""Port parity for the netlist oracle backend and for bit widths other than
4, against the JAX package on the same seeded numpy inputs.

  * ``qdense`` under ``netlist`` (every product through the simulated
    circuit) equals the JAX package's netlist backend and the port's
    ``int_sim`` bit for bit: the same integers, the same f32 epilogue.
  * The widths no kernel serves take the JAX package's XLA route: the
    integer ones (``int_sim``, ``pallas_int4``, ``lut4`` at ``/a8`` or
    ``/w8/a8``, and pre-packed int4 weights at ``/a8``) are exact integer
    GEMMs and equal the JAX package bit for bit; ``w4a16/w8`` is a float32
    GEMM of the dequantized weight, held to 1e-5 relative (summation order).
  * A 2-layer narrow forward under ``*=int_sim/a8`` in float32 is within
    1e-4 of the JAX forward (float32 summation order outside the GEMMs).
  * ROADMAP Queue 3: the JAX netlist backend at a8 feeds magnitudes above
    15 into the 4-bit circuit and returns wrong products; the port raises.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import Runtime as JRuntime  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import qlinear as jql  # noqa: E402
from repro.core import quant_plan as jqp  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import Runtime, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import backends as tb  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core import quant_plan as tqp  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

RNG = np.random.default_rng(20261018)

#: the width specs chip_smoke.py holds to a float64 integer GEMM on the card
WIDTH_SPECS = ["int_sim/a8", "int_sim/w8/a8", "lut4/a8", "pallas_int4/w8/a8",
               "w4a4_packed/a8", "w4a16/w8"]
ROWS = [1, 8, 16, 17, 64]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs(spec):
    return (jqp.get_plan(f"*={spec}").resolve("x"),
            tqp.get_plan(f"*={spec}").resolve("x"))


def _both(w, x, spec, bias=None):
    """(JAX qdense, port qdense) as numpy; `w4a4_packed` specs pack the
    weight first (the port also through its planar twin)."""
    jc, tc = _cfgs(spec)
    jb = None if bias is None else jnp.asarray(bias)
    tbias = None if bias is None else _t(bias)
    if tc.backend == "w4a4_packed":
        jw = jql.pack_weight_nd(jnp.asarray(w), jc)
        tw = tql.prepack_tree({"w": tql.pack_weight_nd(_t(w), tc)})["w"]
    else:
        jw, tw = jnp.asarray(w), _t(w)
    want = np.asarray(jql.qdense(jw, jnp.asarray(x), jc, jb))
    got = tql.qdense(tw, _t(x), tc, tbias)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return want, got.numpy()


# ---------------------------------------------------------------- netlist --
@pytest.mark.parametrize("shape_x,K,N", [((5, 96), 96, 40),
                                         ((2, 3, 72), 72, 34),
                                         ((1, 33), 33, 8)])
def test_netlist_qdense_equals_jax_and_int_sim(shape_x, K, N):
    w = RNG.standard_normal((K, N)).astype(np.float32) * 0.1
    x = RNG.standard_normal(shape_x).astype(np.float32)
    bias = RNG.standard_normal((N,)).astype(np.float32)
    want, got = _both(w, x, "netlist", bias)
    np.testing.assert_array_equal(got, want)
    int_sim = tql.qdense(_t(w), _t(x), tql.QuantConfig(backend="int_sim"),
                         _t(bias)).numpy()
    np.testing.assert_array_equal(got, int_sim)


def test_netlist_qdense_follows_the_activation_dtype():
    w = RNG.standard_normal((64, 16)).astype(np.float32)
    x = _t(RNG.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
    cfg = tql.QuantConfig(backend="netlist")
    got = tql.qdense(_t(w), x, cfg)
    want = tql.qdense(_t(w), x, tql.QuantConfig(backend="int_sim"))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ----------------------------------------------------------------- widths --
@pytest.mark.parametrize("spec", WIDTH_SPECS)
@pytest.mark.parametrize("M", ROWS)
def test_width_specs_equal_the_jax_package(spec, M):
    K, N = 96, 40
    w = RNG.standard_normal((K, N)).astype(np.float32) * 0.1
    x = RNG.standard_normal((M, K)).astype(np.float32)
    want, got = _both(w, x, spec)
    if spec.startswith("w4a16"):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ["int_sim/w8/a8", "lut4/a8"])
def test_integer_widths_are_exact_integer_gemms(spec):
    """The integer routes equal a float64 GEMM of the quantized integers
    (exact below 2^53) with the same epilogue."""
    from repro_torch.core.quant import quant_scale, quantize

    _, tc = _cfgs(spec)
    w = _t(RNG.standard_normal((200, 24)).astype(np.float32))
    x = _t(RNG.standard_normal((9, 200)).astype(np.float32))
    w_s = quant_scale(w, axis=0, bits=tc.w_bits)
    a_s = quant_scale(x, axis=1, bits=tc.a_bits)
    acc = torch.matmul(quantize(x, a_s, tc.a_bits).double(),
                       quantize(w, w_s, tc.w_bits).double())
    want = acc.to(torch.float32) * a_s * w_s
    assert torch.equal(tql.qdense(w, x, tc), want)


@pytest.mark.parametrize("M,K,N", [(1, 5, 7), (16, 24, 16), (17, 896, 128),
                                   (3, 33, 130)])
def test_int_mm_padding_is_exact(M, K, N):
    """`int_mm_padded` pads rows to 17 and K, N to multiples of 8 with zeros
    for ``torch._int_mm`` (the CUDA route's shape rule), then cuts back."""
    a = _t(RNG.integers(-128, 128, (M, K)).astype(np.int8))
    w = _t(RNG.integers(-128, 128, (K, N)).astype(np.int8))
    got = tb.int_mm_padded(a, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert torch.equal(got, a.to(torch.int32) @ w.to(torch.int32))


def test_narrow_forward_at_a8_matches_the_jax_forward():
    """Reduced qwen2-0.5b (2 layers, d_model 64), float32, every projection
    `*=int_sim/a8`, on the JAX package's weights."""
    jcfg = j_get_config("qwen2-0.5b").reduced(n_layers=2)
    cfg = get_config("qwen2-0.5b").reduced(n_layers=2)
    kw = dict(quant_plan="*=int_sim/a8", compute_dtype="float32",
              attn_impl="chunked")
    jrt = JRuntime(**kw, remat="none", loss_chunk=0)
    rt = Runtime(**kw)
    jp = jt.init_model(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = RNG.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    want = np.asarray(jt.forward(jp, jnp.asarray(tokens), jcfg, jrt)[0])
    with torch.no_grad():
        got = tt.forward(tp, _t(tokens), cfg, rt)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_netlist_at_a8_is_wrong_in_jax_and_raises_in_the_port():
    """ROADMAP Queue 3: the JAX package's netlist backend at a8 splits 8-bit
    activations into magnitudes up to 128 and feeds them to the 4-input
    circuit, which reads only their low 4 bits: its result differs from its
    own int_sim at a8.  The port's netlist keeps the 4-bit check."""
    w = RNG.standard_normal((48, 16)).astype(np.float32)
    x = RNG.standard_normal((4, 48)).astype(np.float32)
    jnet = np.asarray(jql.qdense(jnp.asarray(w), jnp.asarray(x),
                                 jql.QuantConfig(backend="netlist",
                                                 a_bits=8)))
    jint = np.asarray(jql.qdense(jnp.asarray(w), jnp.asarray(x),
                                 jql.QuantConfig(backend="int_sim",
                                                 a_bits=8)))
    assert not np.allclose(jnet, jint, rtol=1e-3, atol=1e-3)
    for bits in (dict(a_bits=8), dict(w_bits=8)):
        with pytest.raises(NotImplementedError, match="4-bit circuit"):
            tql.qdense(_t(w), _t(x), tql.QuantConfig(backend="netlist",
                                                     **bits))
