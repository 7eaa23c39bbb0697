"""Port parity: int4 quantization, nibble packing and plan packing in
repro_torch against the JAX package, on the same seeded numpy inputs.
Integer results must be equal, element for element."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import Runtime as JRuntime  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core.quant_plan import active_plan as j_active_plan  # noqa: E402
from repro.core.quant_plan import plan_pack_tree as j_plan_pack_tree  # noqa: E402
from repro.kernels import packing as jp  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro_torch.configs import Runtime, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.quant_plan import (  # noqa: E402
    active_plan, pack_for_serving, plan_pack_tree)
from repro_torch.kernels import packing as tp  # noqa: E402

RNG = np.random.default_rng(20261016)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.numpy()


def _with_ties(shape):
    """f32 values whose per-row scale puts many of them exactly on .5
    rounding ties (k + 0.5 quantization steps), plus random values."""
    x = RNG.standard_normal(shape).astype(np.float32)
    steps = RNG.integers(-8, 7, size=shape).astype(np.float32) + 0.5
    x[..., ::3] = steps[..., ::3] / 7.0
    x[..., 0] = 1.0            # amax 1 -> scale 1/7, ties land exactly
    return x


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quant_scale_and_quantize_equal(axis):
    x = _with_ties((9, 24))
    s_j = np.asarray(jq.quant_scale(jnp.asarray(x), axis=axis))
    s_t = _np(tq.quant_scale(_t(x), axis=axis))
    np.testing.assert_array_equal(s_t, s_j)
    q_j = np.asarray(jq.quantize(jnp.asarray(x), jnp.asarray(s_j)))
    q_t = _np(tq.quantize(_t(x), _t(s_t)))
    assert q_t.dtype == np.int8
    np.testing.assert_array_equal(q_t, q_j)


def test_quantize_rounds_half_to_even():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 6.5, 7.0]], np.float32)
    q = _np(tq.quantize(_t(x), torch.ones((1, 1))))
    np.testing.assert_array_equal(q, [[0, 2, 2, 0, -2, -2, 6, 7]])


@pytest.mark.parametrize("axis", [-1, 0])
def test_pack_unpack_int4_equal(axis):
    q = RNG.integers(-8, 8, size=(6, 10)).astype(np.int8)
    p_j = np.asarray(jq.pack_int4(jnp.asarray(q), axis=axis))
    p_t = _np(tq.pack_int4(_t(q), axis=axis))
    assert p_t.dtype == np.uint8
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(_np(tq.unpack_int4(_t(p_j), axis=axis)), q)


@pytest.mark.parametrize("K,row_mult", [(7, 2), (16, 2), (33, 4), (64, 8)])
def test_kmajor_layout_equal(K, row_mult):
    N = 12
    q = RNG.integers(-8, 8, size=(K, N)).astype(np.int8)
    km_j = np.asarray(jp.pack_kmajor(jnp.asarray(q), row_mult))
    km_t = _np(tp.pack_kmajor(_t(q), row_mult))
    np.testing.assert_array_equal(km_t, km_j)
    np.testing.assert_array_equal(_np(tp.unpack_kmajor(_t(km_j)))[:K], q)
    packed = np.asarray(jq.pack_int4(jnp.asarray(q), axis=-1))
    np.testing.assert_array_equal(
        _np(tp.nmajor_to_kmajor(_t(packed), row_mult)),
        np.asarray(jp.nmajor_to_kmajor(jnp.asarray(packed), row_mult)))


@pytest.fixture(scope="module")
def masters():
    """Reduced qwen2-0.5b float masters from the JAX package, 2 layers."""
    cfg = j_get_config("qwen2-0.5b").reduced(n_layers=2)
    params = j_init_model(jax.random.PRNGKey(3), cfg)
    return cfg, jax.tree.map(np.asarray, params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_plan_pack_tree_same_bytes_and_scales(masters):
    jcfg, np_params = masters
    kw = dict(quant_backend="w4a4_packed")
    j_packed = j_plan_pack_tree(jax.tree.map(jnp.asarray, np_params), jcfg,
                                j_active_plan(jcfg, JRuntime(**kw)))
    cfg = get_config("qwen2-0.5b").reduced(n_layers=2)
    t_packed = plan_pack_tree(params_from_jax(np_params, "cpu"), cfg,
                              active_plan(cfg, Runtime(**kw)))
    j_leaves = dict(_leaves(jax.tree.map(np.asarray, j_packed)))
    t_leaves = dict(_leaves(t_packed))
    assert sorted(j_leaves) == sorted(t_leaves)
    assert any(k.endswith("/packed") for k in t_leaves)
    for name, leaf in j_leaves.items():
        got = _np(t_leaves[name])
        assert got.dtype == leaf.dtype, name
        np.testing.assert_array_equal(got, leaf, err_msg=name)


def test_pack_for_serving_adds_kernel_layout(masters):
    jcfg, np_params = masters
    cfg = get_config("qwen2-0.5b").reduced(n_layers=2)
    served = pack_for_serving(params_from_jax(np_params, "cpu"), cfg,
                              Runtime(quant_backend="w4a4_packed"))
    w = served["layers"]["u0"]["ffn"]["w_in"]
    np.testing.assert_array_equal(
        _np(w["packed_km"]),
        np.asarray(jp.nmajor_to_kmajor(jnp.asarray(_np(w["packed"])))))
