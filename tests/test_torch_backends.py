"""Port parity for the third slice's kernels and backends: the product
tables, the plain versions of the W4A16, table-lookup, unfused W4A4 and
elementwise table kernels, and `qdense` under every new backend, against
the JAX package on the same seeded numpy inputs.  The JAX kernels run as
the JAX package's own tests run them on the CPU: through the Pallas
interpreter (W4A16, lut_mul4) or through ``repro.kernels.ref`` (the
table-formulation oracle for lut4, the integer oracle for int4).

Tolerances: integer paths (tables, lut4, unfused int4, mul4) are exact and
asserted equal.  W4A16 holds f32 at 1e-4 and bf16 activations at 2e-2, the
bounds tests/test_kernels.py holds the Pallas kernel to: the plain version
dequantizes the weight in f32 where the kernel scales each group's partial
sum, so they differ by f32 rounding in the order of the sums.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import qlinear as jql  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import packing as jp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import qlinear as tql  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packing as tp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.int4_matmul import int4_matmul_cuda  # noqa: E402
from repro_torch.kernels.lut4_matmul import lut4_matmul_cuda  # noqa: E402
from repro_torch.kernels.lut_mul4 import lut_mul4_cuda  # noqa: E402
from repro_torch.kernels.w4a16_matmul import w4a16_matmul_cuda  # noqa: E402

RNG = np.random.default_rng(20261017)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------- tables ----
def test_product_tables_equal():
    j_lo, j_hi = jp.nibble_product_tables()
    t_lo, t_hi = tp.nibble_product_tables()
    assert t_lo.dtype == torch.int8 and tuple(t_lo.shape) == (16, 256)
    np.testing.assert_array_equal(t_lo.numpy(), j_lo)
    np.testing.assert_array_equal(t_hi.numpy(), j_hi)
    lut = tref.make_product_lut()
    assert lut.dtype == torch.int8 and tuple(lut.shape) == (256,)
    np.testing.assert_array_equal(lut.numpy(), jref.make_product_lut())
    on = tref.product_lut_on("cpu")
    assert on is tref.product_lut_on(torch.device("cpu"))     # cached
    np.testing.assert_array_equal(on.numpy(), jref.make_product_lut())


@pytest.mark.parametrize("shape,rows_mult,cols",
                         [((16,), 8, 128), ((5, 33), 4, 16),
                          ((2, 3, 130), 256, 128)])
def test_flatten_to_tiles_equal(shape, rows_mult, cols):
    x = RNG.integers(-8, 8, size=shape).astype(np.int8)
    j_tiles, j_n = jp.flatten_to_tiles(jnp.asarray(x), rows_mult, cols)
    t_tiles, t_n = tp.flatten_to_tiles(_t(x), rows_mult, cols)
    assert t_n == j_n
    np.testing.assert_array_equal(t_tiles.numpy(), np.asarray(j_tiles))
    np.testing.assert_array_equal(
        t_tiles.reshape(-1)[:t_n].reshape(shape).numpy(), x)


# --------------------------------------------------------- quantization ----
@pytest.mark.parametrize("G", [0, 32, 64])
def test_group_quantize_and_dequantize_equal(G):
    w = RNG.standard_normal((128, 24)).astype(np.float32)
    g = G if G else w.shape[0]
    jqv, js = jq.group_quantize(jnp.asarray(w), g)
    tqv, ts = tq.group_quantize(_t(w), g)
    assert tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.group_dequantize(tqv, ts, g).numpy(),
        np.asarray(jq.group_dequantize(jqv, js, g)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [None, -1, 0])
def test_fake_quant_forward_and_gradient(dtype, axis):
    x = RNG.standard_normal((6, 20)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jq.fake_quant(jnp.asarray(x).astype(jdt), axis=axis)
    xt = _t(x, tdt).requires_grad_(True)
    got = tq.fake_quant(xt, axis=axis)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np32(got.detach()), _np32(want))
    got.sum().backward()                  # straight through: d/dx = 1
    np.testing.assert_array_equal(_np32(xt.grad), np.ones_like(x))


# -------------------------------------------------------- W4A16 (row 6) ----
def _w4a16_case(M, K, N, G, dtype):
    w = RNG.standard_normal((K, N + N % 2)).astype(np.float32)
    qg, sg = jq.group_quantize(jnp.asarray(w), G)
    wp = np.asarray(jq.pack_int4(qg, axis=-1))
    x = RNG.standard_normal((M, K)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = _t(x, torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jx, tx, wp, np.asarray(sg)


W4A16_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("M,K,N,G", [(32, 256, 64, 64), (100, 512, 130, 128),
                                     (1, 1024, 256, 128), (8, 896, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4a16_grouped_equal(M, K, N, G, dtype):
    """Grouped scales, including K = 896 at G = 128 (7 groups: K pads to
    1024 and the high plane carries a group of zeros)."""
    jx, tx, wp, sg = _w4a16_case(M, K, N, G, dtype)
    want = jops.w4a16_matmul(jx, jnp.asarray(wp), jnp.asarray(sg), G,
                             interpret=True, bm=128, bn=128, bk=256)
    got = ops.w4a16_matmul(tx, _t(wp), _t(sg), G)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = W4A16_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("M,K,N", [(9, 130, 50), (1, 77, 24)])
def test_w4a16_per_channel_odd_shapes(M, K, N):
    jx, tx, wp, sg = _w4a16_case(M, K, N, K, "float32")
    assert sg.ndim == 2
    want = jops.w4a16_matmul(jx, jnp.asarray(wp), jnp.asarray(sg), K,
                             interpret=True)
    got = ops.w4a16_matmul(tx, _t(wp), _t(sg), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_w4a16_odd_group_count():
    """K = 3 groups: the repack pads K to a multiple of 2G."""
    jx, tx, wp, sg = _w4a16_case(16, 192, 32, 64, "float32")
    assert sg.shape[0] == 3
    want = jops.w4a16_matmul(jx, jnp.asarray(wp), jnp.asarray(sg), 64,
                             interpret=True)
    got = ops.w4a16_matmul(tx, _t(wp), _t(sg), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------ lut4 and int4 (rows 7, 2) --
ODD_SHAPES = [(1, 2, 2), (3, 5, 2), (7, 13, 10), (33, 57, 34),
              (8, 512, 512), (129, 511, 130)]


def _w4a4_case(M, K, N):
    a_q = RNG.integers(-8, 8, size=(M, K)).astype(np.int8)
    a_s = (RNG.random((M, 1)) + 0.05).astype(np.float32)
    wq = RNG.integers(-8, 8, size=(K, N)).astype(np.int8)
    wp = np.asarray(jq.pack_int4(jnp.asarray(wq), axis=-1))
    w_s = (RNG.random((1, N)) + 0.05).astype(np.float32)
    return a_q, a_s, wp, w_s


@pytest.mark.parametrize("M,K,N", ODD_SHAPES)
def test_lut4_and_unfused_int4_exact(M, K, N):
    """Both plain versions equal the JAX table oracle bit for bit, and each
    other (the rank-1 identity)."""
    a_q, a_s, wp, w_s = _w4a4_case(M, K, N)
    jargs = [jnp.asarray(v) for v in (a_q, a_s, wp, w_s)]
    want_lut = np.asarray(jref.lut4_matmul_ref(*jargs))
    want_int = np.asarray(jref.int4_matmul_ref(*jargs))
    targs = [_t(v) for v in (a_q, a_s, wp, w_s)]
    got_lut = ops.lut4_matmul(*targs).numpy()
    got_int = ops.int4_matmul(*targs).numpy()
    np.testing.assert_array_equal(got_lut, want_lut)
    np.testing.assert_array_equal(got_int, want_int)
    np.testing.assert_array_equal(got_lut, got_int)
    w_km = tp.nmajor_to_kmajor(_t(wp))
    np.testing.assert_array_equal(
        ops.lut4_matmul_kmajor(targs[0], targs[1], w_km, targs[3]).numpy(),
        want_lut)


def test_unfused_int4_matches_the_pallas_kernel():
    """One shape through the JAX package's Pallas kernel in interpret mode."""
    a_q, a_s, wp, w_s = _w4a4_case(7, 13, 10)
    want = jops.int4_matmul(*(jnp.asarray(v) for v in (a_q, a_s, wp, w_s)),
                            interpret=True, bm=8, bn=128, bk=16)
    got = ops.int4_matmul(*(_t(v) for v in (a_q, a_s, wp, w_s)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------- lut_mul4 (row 8) ----
@pytest.mark.parametrize("strategy", ["onehot", "take"])
def test_mul4_all_pairs_exact(strategy):
    vals = np.arange(-8, 8, dtype=np.int8)
    a, b = np.repeat(vals, 16), np.tile(vals, 16)
    want = np.asarray(jops.mul4(jnp.asarray(a), jnp.asarray(b),
                                strategy=strategy, interpret=True))
    got = ops.mul4(_t(a), _t(b), strategy=strategy)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), (a.astype(np.int32) * b.astype(np.int32)).astype(np.int8))


@pytest.mark.parametrize("shape", [(5, 33), (2, 3, 130)])
def test_mul4_any_shape_exact(shape):
    a = RNG.integers(-8, 8, size=shape).astype(np.int8)
    b = RNG.integers(-8, 8, size=shape).astype(np.int8)
    want = np.asarray(jops.mul4(jnp.asarray(a), jnp.asarray(b),
                                strategy="take", interpret=True))
    got = ops.mul4(_t(a), _t(b), strategy="take")
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- dispatch ----
def test_new_cuda_wrappers_raise_on_cpu_tensors_and_bad_arguments():
    a_q = torch.zeros((2, 8), dtype=torch.int8)
    w_km = torch.zeros((4, 6), dtype=torch.uint8)
    ones = torch.ones((2, 1)), torch.ones((1, 6))
    with pytest.raises(ValueError):
        int4_matmul_cuda(a_q, ones[0], w_km, ones[1])
    with pytest.raises(ValueError):
        lut4_matmul_cuda(a_q, ones[0], w_km, ones[1])
    with pytest.raises(ValueError):
        w4a16_matmul_cuda(a_q.float(), w_km, ones[1], 8)
    with pytest.raises(ValueError):
        lut_mul4_cuda(a_q, a_q)
    with pytest.raises(ValueError, match="strategy"):
        ops.mul4(a_q, a_q, strategy="gather")
    assert all(name in ops.launch_counts() for name in
               ("int4_matmul", "w4a16_matmul", "lut4_matmul", "lut_mul4"))


# ---------------------------------------------------------------- qdense ----
QDENSE_BACKENDS = [("fake_quant", 0), ("pallas_int4", 0), ("lut4", 0),
                   ("w4a16", 0), ("w4a16", 32)]


@pytest.mark.parametrize("backend,G", QDENSE_BACKENDS)
def test_qdense_new_backends_equal_the_jax_package(backend, G):
    """float32 activations and master weights; the W4A4 backends are exact
    up to the f32 epilogue, the others f32 summation-order noise."""
    w = RNG.standard_normal((96, 40)).astype(np.float32) * 0.1
    x = RNG.standard_normal((3, 5, 96)).astype(np.float32)
    bias = RNG.standard_normal((40,)).astype(np.float32)
    kw = dict(backend=backend, group_size=G,
              a_bits=16 if backend == "w4a16" else 4)
    want = jql.qdense(jnp.asarray(w), jnp.asarray(x), jql.QuantConfig(**kw),
                      jnp.asarray(bias))
    got = tql.qdense(_t(w), _t(x), tql.QuantConfig(**kw), _t(bias))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend,G", [("w4a16_packed", 0),
                                       ("w4a16_packed", 32), ("lut4", 0)])
def test_qdense_packed_weights_equal_the_jax_package(backend, G):
    """Pre-packed weights (grouped scales need the 2G-aligned repack) give
    the JAX package's packed-path results; the packed bytes are its too."""
    w = RNG.standard_normal((96, 40)).astype(np.float32) * 0.1
    x = RNG.standard_normal((4, 96)).astype(np.float32)
    qc_j = jql.QuantConfig(backend=backend, group_size=G)
    qc_t = tql.QuantConfig(backend=backend, group_size=G)
    pw_j = jql.pack_weight_nd(jnp.asarray(w), qc_j)
    pw_t = tql.pack_weight_nd(_t(w), qc_t)
    for key in ("packed", "scale"):
        np.testing.assert_array_equal(pw_t[key].numpy(), np.asarray(pw_j[key]))
    want = np.asarray(jql.qdense(pw_j, jnp.asarray(x), qc_j))
    for tree in (pw_t, tql.prepack_tree({"w": pw_t})["w"]):
        got = tql.qdense(tree, _t(x), qc_t).numpy()
        if backend == "lut4":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lut4_bit_equal_to_int_sim_on_the_port():
    w = RNG.standard_normal((72, 34)).astype(np.float32)
    x = RNG.standard_normal((6, 72)).astype(np.float32)
    outs = {b: tql.qdense(_t(w), _t(x), tql.QuantConfig(backend=b))
            for b in ("lut4", "int_sim")}
    assert torch.equal(outs["lut4"], outs["int_sim"])
    packed = tql.prepack_tree(
        {"w": tql.pack_weight_nd(_t(w), tql.QuantConfig(backend="lut4"))})["w"]
    for b in ("lut4", "w4a4_packed"):
        got = tql.qdense(packed, _t(x), tql.QuantConfig(backend=b))
        assert torch.equal(got, outs["int_sim"])

