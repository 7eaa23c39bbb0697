"""Port parity: reduced qwen2-0.5b (2 layers) in repro_torch against
repro.models on identical weights (``convert.params_from_jax``): teacher-
forced forward logits, then a paged prefill of a left-padded prompt and
three decode steps.

Tolerances, with their reasons:

  * float32 activations: both packages run the same integer W4A4 math on
    the same quantized values and differ only in float32 summation order,
    so logits agree to atol 1e-4 (observed ~1e-6).
  * bf16 activations, float weights: both round to bf16 at every op but
    XLA fuses elementwise chains and rounds fewer times, so logits agree
    to atol 0.1 (one bf16 step of the logits' scale is 1/64).
  * bf16 activations, W4A4: a one-step bf16 difference that moves a row's
    amax, or lands a value on the other side of an int4 rounding boundary,
    moves that row's projection by a whole quantization step, and the next
    layers amplify it.  No elementwise bound is meaningful there; the two
    logit vectors must still be strongly correlated (>= 0.7), which a wrong
    kernel or a misrouted weight does not give.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import Runtime as JRuntime  # noqa: E402
from repro.configs import ServingConfig as JServingConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import kv_pages as jkv  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.configs import Runtime, ServingConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import kv_pages as tkv  # noqa: E402

SV = dict(layout="paged", max_batch=2, page_size=4, num_pages=24, max_ctx=32)
# row 1 left-padded by 5 (position -1), as the engine pads prompts
B, S, PAD = 2, 16, (0, 5)
RNG = np.random.default_rng(7)
TOKENS = RNG.integers(0, 256, (B, S)).astype(np.int32)
FEED = RNG.integers(0, 256, (B, 3)).astype(np.int32)
_POS = np.arange(S, dtype=np.int32)[None] - np.asarray(PAD, np.int32)[:, None]
POSITIONS = np.where(_POS >= 0, _POS, -1).astype(np.int32)
# pages 0-7 for row 0; row 1 on scattered pages, sentinel past its need
TABLE = np.array([[0, 1, 2, 3, 4, 5, 6, 7],
                  [12, 9, 15, 11, 24, 24, 24, 24]], np.int32)


def _runtimes(quant, dtype, impl, paged_attn):
    kw = dict(quant_backend=quant, compute_dtype=dtype, cache_dtype=dtype,
              attn_impl=impl, paged_attn=paged_attn)
    return (JRuntime(**kw, aligned_decode=False, remat="none", loss_chunk=0),
            Runtime(**kw))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _run_both(quant, dtype, impl, paged_attn):
    """(jax logits, port logits) for forward, prefill and 3 decode steps,
    stacked along rows, sliced to the real vocab."""
    jcfg = j_get_config("qwen2-0.5b").reduced(n_layers=2)
    cfg = get_config("qwen2-0.5b").reduced(n_layers=2)
    jrt, rt = _runtimes(quant, dtype, impl, paged_attn)
    jp = j_build_params(jcfg, jrt, seed=1)
    tp = prepack_tree(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    valid = POSITIONS >= 0

    out_j = [np.asarray(jt.forward(jp, jnp.asarray(TOKENS), jcfg, jrt,
                                   jnp.asarray(POSITIONS))[0])]
    out_t = [tt.forward(tp, torch.from_numpy(TOKENS), cfg, rt,
                        torch.from_numpy(POSITIONS))[0]]
    out_j[0] = _f32(out_j[0])[valid]
    out_t[0] = _f32(out_t[0])[valid]

    jc = jkv.with_block_tables(
        jkv.init_paged_caches(jcfg, jrt, B, JServingConfig(**SV)),
        jnp.asarray(TABLE))
    tc = tkv.with_block_tables(
        tkv.init_paged_caches(cfg, rt, ServingConfig(**SV), device="cpu"),
        torch.from_numpy(TABLE))
    lj, jc = jt.prefill(jp, jnp.asarray(TOKENS), jcfg, jrt, jc,
                        jnp.asarray(POSITIONS))
    lt, tc = tt.prefill(tp, torch.from_numpy(TOKENS), cfg, rt, tc,
                        torch.from_numpy(POSITIONS))
    out_j.append(_f32(lj))
    out_t.append(_f32(lt))
    last = POSITIONS[:, -1:]
    for i in range(FEED.shape[1]):
        pos = (last + 1 + i).astype(np.int32)
        lj, jc = jt.decode_step(jp, jnp.asarray(FEED[:, i:i + 1]), jcfg, jrt,
                                jc, jnp.asarray(pos))
        lt, tc = tt.decode_step(tp, torch.from_numpy(FEED[:, i:i + 1]), cfg,
                                rt, tc, torch.from_numpy(pos))
        out_j.append(_f32(lj))
        out_t.append(_f32(lt))
    V = cfg.vocab
    return (np.concatenate([o[:, :V] for o in out_j]),
            np.concatenate([o[:, :V] for o in out_t]))


@pytest.mark.parametrize("impl,paged_attn", [("chunked", "gather"),
                                             ("flash", "fused")])
def test_float32_w4a4_logits_match(impl, paged_attn):
    want, got = _run_both("w4a4_packed", "float32", impl, paged_attn)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bf16_float_weights_logits_match():
    want, got = _run_both("float", "bfloat16", "flash", "fused")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)


def test_bf16_w4a4_logits_correlate():
    want, got = _run_both("w4a4_packed", "bfloat16", "flash", "fused")
    assert np.isfinite(got).all()
    corr = np.corrcoef(want.ravel(), got.ravel())[0, 1]
    assert corr >= 0.7, corr
