"""Port parity: the plain PyTorch versions of the three CUDA kernels against
the JAX package's XLA twins (the path its kernels take off a TPU), and the
dispatch contract.  tests/test_torch_cuda.py holds the CUDA kernels against
these plain versions on a GPU.

Tolerances: the W4A4 integer core is exact; W4A4 outputs get the tie-aware
bound of tests/test_kernels.py.  The decode and flash plain versions copy
the twins' blocking, so they agree to float32 summation-order noise
(atol 1e-5) in f32 and to one bf16 rounding step of outputs below 4 in
magnitude (atol 2e-2, the bound the JAX package holds its Pallas kernels
to) in bf16.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.packing import pack_kmajor as j_pack_kmajor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int4_matmul import (  # noqa: E402
    int4_matmul_fused_cuda, int4_matmul_fused_plain)
from repro_torch.kernels.packing import pack_kmajor  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    flash_prefill_cuda, paged_decode_attention_cuda)

RNG = np.random.default_rng(11)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.to(torch.float32).numpy()


# ------------------------------------------------------------ W4A4 GEMM ----
@pytest.mark.parametrize("M,K,N", [(5, 71, 33), (1, 129, 64), (17, 64, 130)])
def test_w4a4_integer_core_exact(M, K, N):
    """Rows whose amax is 7 quantize with scale 1, so with unit weight
    scales the output is the integer dot itself."""
    x = RNG.integers(-8, 8, size=(M, K)).astype(np.float32)
    x[:, 0] = 7.0
    x = np.clip(x, -7, 7)
    w_q = RNG.integers(-8, 8, size=(K, N)).astype(np.int8)
    got = int4_matmul_fused_plain(_t(x), pack_kmajor(_t(w_q)),
                                  torch.ones((1, N)))
    want = x.astype(np.int64) @ w_q.astype(np.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("M,K,N", [(5, 71, 33), (1, 129, 64), (17, 64, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4a4_plain_matches_xla_twin(M, K, N, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    x = jnp.asarray(RNG.standard_normal((M, K)).astype(np.float32)).astype(jdt)
    w_q = RNG.integers(-8, 8, size=(K, N)).astype(np.int8)
    w_scale = (RNG.random((1, N)) + 0.05).astype(np.float32)
    w_km = np.asarray(j_pack_kmajor(jnp.asarray(w_q)))
    want = np.asarray(jops.int4_matmul_fused_kmajor(
        x, jnp.asarray(w_km), jnp.asarray(w_scale)))
    got = ops.int4_matmul_fused_kmajor(_t(_f32(x), tdt), _t(w_km),
                                       _t(w_scale)).numpy()
    x32 = _f32(x)
    a_scale = np.maximum(np.abs(x32).max(axis=1, keepdims=True), 1e-8) / 7.0
    ratio = x32 / a_scale
    ties = (np.abs(ratio - np.round(ratio)) == 0.5).sum(axis=1)
    tol = np.abs(want) * 1e-5 + 1e-5 \
        + (ties * 8.0 * a_scale[:, 0] * float(w_scale.max()))[:, None]
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


# -------------------------------------------------------- paged decode ----
def _decode_case(ps, B=4, H=4, KV=2, hd=16, pps=6):
    P = B * pps + 3
    q = RNG.standard_normal((B, H, hd)).astype(np.float32)
    k = RNG.standard_normal((P, ps, KV, hd)).astype(np.float32)
    v = RNG.standard_normal((P, ps, KV, hd)).astype(np.float32)
    max_ctx = pps * ps
    last = np.array([max_ctx - 1, -1, max_ctx // 2, 0], np.int32)[:B]
    tbl = np.full((B, pps), P, np.int32)            # sentinel slots
    pages = RNG.permutation(P).astype(np.int32)
    used = 0
    for b, lp in enumerate(last):
        n = (lp // ps + 1) if lp >= 0 else 0
        tbl[b, :n] = pages[used:used + n]
        used += n
    return q, k, v, tbl, last


@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_xla_twin(ps, window, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    q, k, v, tbl, last = _decode_case(ps)
    want = jops.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(tbl), jnp.asarray(last), window=window)
    got = ops.paged_decode_attention(
        _t(q, tdt), _t(k, tdt), _t(v, tdt), _t(tbl), _t(last), window=window)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=0)
    assert not _f32(got)[1].any()                 # inactive row -> zeros


# -------------------------------------------------------- flash prefill ----
def _flash_case(B=2, S=21, H=4, KV=2, hd=16, pads=(0, 6)):
    q = RNG.standard_normal((B, S, H, hd)).astype(np.float32)
    k = RNG.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = RNG.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1)) \
        - np.asarray(pads, np.int32)[:, None]
    return q, k, v, np.where(pos >= 0, pos, -1).astype(np.int32)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_xla_twin(window, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    q, k, v, pos = _flash_case()
    want = jops.flash_prefill(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                              jnp.asarray(v, jdt), jnp.asarray(pos),
                              jnp.asarray(pos), window=window)
    got = ops.flash_prefill(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(pos),
                            _t(pos), window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=0)
    assert not _f32(got)[1, :6].any()             # left padding -> zeros


# ---------------------------------------------------- dispatch contract ----
def test_cuda_wrappers_refuse_cpu_tensors_and_cpu_never_counts():
    """A CUDA wrapper raises on a CPU tensor (no silent fallback), and the
    CPU path through kernels.ops leaves every launch count untouched."""
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        int4_matmul_fused_cuda(x, torch.zeros((4, 8), dtype=torch.uint8),
                               torch.ones((1, 8)))
    q, k, v, tbl, last = _decode_case(4)
    with pytest.raises(ValueError):
        paged_decode_attention_cuda(_t(q, torch.bfloat16),
                                    _t(k, torch.bfloat16),
                                    _t(v, torch.bfloat16), _t(tbl), _t(last))
    qf, kf, vf, pos = _flash_case()
    with pytest.raises(ValueError):
        flash_prefill_cuda(_t(qf, torch.bfloat16), _t(kf, torch.bfloat16),
                           _t(vf, torch.bfloat16), _t(pos), _t(pos))
    before = ops.launch_counts()
    ops.int4_matmul_fused_kmajor(x, torch.zeros((4, 8), dtype=torch.uint8),
                                 torch.ones((1, 8)))
    ops.paged_decode_attention(_t(q), _t(k), _t(v), _t(tbl), _t(last))
    ops.flash_prefill(_t(qf), _t(kf), _t(vf), _t(pos), _t(pos))
    assert ops.launch_counts() == before
