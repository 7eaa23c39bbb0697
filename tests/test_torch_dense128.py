"""Port parity for the dense head-dim-128 configs: qwen3-4b (qk_norm),
qwen2-vl-2b (M-RoPE, qkv bias, tied embeddings) and internlm2-20b (plain
GQA), the JAX package and the port on the same weights.

  (a) the port's configs are the JAX package's, field for field;
  (b) the port's own init draws the JAX package's tree: the same leaves
      and shapes, q_norm / k_norm ones of [hd] that draw nothing, so the
      weights of the configs without them do not move;
  (c) on the reduced configs (2 layers) with the JAX package's W4A4 serving
      weights (``build_params`` -> ``convert.params_from_jax(..., "cpu")``)
      in float32: forward logits, a paged prefill of a left-padded prompt
      and three decode steps within 1e-4 (both run the same integer W4A4
      math on the same quantized values and differ only in float32
      summation order; observed ~1e-6);
  (d) qk_norm in bf16 with float weights: logits within 0.1, one bf16 step
      at the logits' scale (1/64) and a few more of accumulated rounding,
      the bound of tests/test_torch_model.py;
  (e) the port's engine emits the JAX engine's greedy tokens in float32
      (W4A4 weights, float32 cache) on the paged bucketed step, with the
      same step and token counts.  The JAX engines run once per file, in a
      module-scoped fixture.  The ragged step and M-RoPE's own checks are
      in tests/test_torch_mrope.py.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import kv_pages as jkv  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import kv_pages as tkv  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    InferenceEngine, build_params)

ARCHS = ("qwen3-4b", "qwen2-vl-2b", "internlm2-20b")
F32_ATOL = 1e-4
BF16_ATOL = 0.1

SV = dict(layout="paged", max_batch=2, page_size=4, num_pages=24, max_ctx=32)
B, S, PAD = 2, 16, (0, 5)
RNG = np.random.default_rng(27)
TOKENS = RNG.integers(0, 256, (B, S)).astype(np.int32)
FEED = RNG.integers(0, 256, (B, 3)).astype(np.int32)
_POS = np.arange(S, dtype=np.int32)[None] - np.asarray(PAD, np.int32)[:, None]
POSITIONS = np.where(_POS >= 0, _POS, -1).astype(np.int32)
TABLE = np.array([[0, 1, 2, 3, 4, 5, 6, 7],
                  [12, 9, 15, 11, 24, 24, 24, 24]], np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _leaves(tree, prefix=""):
    """{path: shape} of a parameter tree (JAX arrays or tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


# ------------------------------------------------------- (a) configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_the_jax_config(arch):
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for f in dataclasses.fields(cfg):
        if f.name == "quant":
            assert dataclasses.asdict(cfg.quant) == \
                dataclasses.asdict(jcfg.quant)
        else:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.hd == jcfg.hd == 128
    red, jred = cfg.reduced(n_layers=2), jcfg.reduced(n_layers=2)
    assert (red.hd, red.n_heads, red.n_kv_heads, red.mrope_sections) == \
        (jred.hd, jred.n_heads, jred.n_kv_heads, jred.mrope_sections)


def test_registry_and_the_archs_still_refused():
    assert set(ARCHS) <= set(tconfigs.REGISTRY)
    for arch in ("starcoder2-7b", "musicgen-large", "arctic-480b"):
        assert arch not in tconfigs.REGISTRY
    # qwen3-4b keeps the JAX config's untied lm_head
    assert not tconfigs.get_config("qwen3-4b").tie_embeddings
    assert tconfigs.get_config("qwen2-vl-2b").tie_embeddings


# ------------------------------------------------------ (b) the tree ----
@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_jax_tree(arch):
    jcfg = jconfigs.get_config(arch).reduced(n_layers=2)
    cfg = tconfigs.get_config(arch).reduced(n_layers=2)
    jrt = jconfigs.Runtime(quant_backend="float", remat="none", loss_chunk=0)
    rt = tconfigs.Runtime(quant_backend="float")
    jp = params_from_jax(jax.tree.map(np.asarray,
                                      j_build_params(jcfg, jrt, seed=0)),
                         "cpu")
    tp = build_params(cfg, rt, seed=0, device="cpu")
    assert _leaves(tp) == _leaves(jp)
    attn = tp["layers"]["u0"]["attn"]
    if cfg.qk_norm:
        assert torch.equal(attn["q_norm"], torch.ones((2, cfg.hd)))
        assert torch.equal(attn["k_norm"], torch.ones((2, cfg.hd)))
    else:
        assert "q_norm" not in attn


def test_qk_norm_draws_nothing():
    """The ones of q_norm / k_norm draw nothing from the generator: the same
    config with qk_norm off has bit for bit the same other leaves."""
    cfg = tconfigs.get_config("qwen3-4b").reduced(n_layers=2)
    on = tt.init_model(torch.Generator().manual_seed(3), cfg)
    off = tt.init_model(torch.Generator().manual_seed(3),
                        dataclasses.replace(cfg, qk_norm=False))
    a_on, a_off = on["layers"]["u0"]["attn"], off["layers"]["u0"]["attn"]
    assert set(a_on) - set(a_off) == {"q_norm", "k_norm"}
    for k in a_off:
        assert torch.equal(a_on[k], a_off[k]), k
    assert torch.equal(on["lm_head"]["w"], off["lm_head"]["w"])


# ---------------------------------------------- (c), (d) the logits ----
def _run_both(arch, quant, dtype):
    """(jax logits, port logits): teacher-forced forward, then a paged
    prefill and 3 decode steps (gather decode and chunked prefill, the
    reference's exact paths), stacked along rows, sliced to the vocab."""
    jcfg = jconfigs.get_config(arch).reduced(n_layers=2)
    cfg = tconfigs.get_config(arch).reduced(n_layers=2)
    kw = dict(quant_backend=quant, compute_dtype=dtype, cache_dtype=dtype,
              attn_impl="chunked", paged_attn="gather")
    jrt = jconfigs.Runtime(**kw, aligned_decode=False, remat="none",
                           loss_chunk=0)
    rt = tconfigs.Runtime(**kw)
    jp = j_build_params(jcfg, jrt, seed=1)
    tp = prepack_tree(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    valid = POSITIONS >= 0
    out_j = [_f32(jt.forward(jp, jnp.asarray(TOKENS), jcfg, jrt,
                             jnp.asarray(POSITIONS))[0])[valid]]
    out_t = [_f32(tt.forward(tp, torch.from_numpy(TOKENS), cfg, rt,
                             torch.from_numpy(POSITIONS))[0])[valid]]
    jc = jkv.with_block_tables(
        jkv.init_paged_caches(jcfg, jrt, B, jconfigs.ServingConfig(**SV)),
        jnp.asarray(TABLE))
    tc = tkv.with_block_tables(
        tkv.init_paged_caches(cfg, rt, tconfigs.ServingConfig(**SV),
                              device="cpu"),
        torch.from_numpy(TABLE))
    lj, jc = jt.prefill(jp, jnp.asarray(TOKENS), jcfg, jrt, jc,
                        jnp.asarray(POSITIONS))
    lt, tc = tt.prefill(tp, torch.from_numpy(TOKENS), cfg, rt, tc,
                        torch.from_numpy(POSITIONS))
    out_j.append(_f32(lj))
    out_t.append(_f32(lt))
    for i in range(FEED.shape[1]):
        pos = (POSITIONS[:, -1:] + 1 + i).astype(np.int32)
        lj, jc = jt.decode_step(jp, jnp.asarray(FEED[:, i:i + 1]), jcfg, jrt,
                                jc, jnp.asarray(pos))
        lt, tc = tt.decode_step(tp, torch.from_numpy(FEED[:, i:i + 1]), cfg,
                                rt, tc, torch.from_numpy(pos))
        out_j.append(_f32(lj))
        out_t.append(_f32(lt))
    V = cfg.vocab
    return (np.concatenate([o[:, :V] for o in out_j]),
            np.concatenate([o[:, :V] for o in out_t]))


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_w4a4_logits_match(arch):
    want, got = _run_both(arch, "w4a4_packed", "float32")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_qk_norm_bf16_logits_match():
    want, got = _run_both("qwen3-4b", "float", "bfloat16")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


# ---------------------------------------------- (e) the engine's tokens --
ENGINE_SV = dict(layout="paged", max_batch=3, page_size=4, num_pages=24,
                 max_ctx=40)
TRACE = dict(n_requests=5, rate_per_step=0.8, prompt_lens=(5, 11),
             gen_lens=(3, 6), seed=9)
F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32", cache_dtype="float32")


@pytest.fixture(scope="module")
def jax_runs():
    """{arch: (port weights, JAX stats, JAX finished requests)} for the
    reduced configs (2 layers), W4A4 serving weights in float32, the
    bucketed paged step."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).reduced(n_layers=2)
        jrt = jconfigs.Runtime(**F32, remat="none", loss_chunk=0)
        jparams = j_build_params(jcfg, jrt, seed=2)
        engine = JEngine(jcfg, jrt, jconfigs.ServingConfig(**ENGINE_SV),
                         params=jparams)
        stats, fin = j_run_trace(engine, j_poisson_trace(vocab=jcfg.vocab,
                                                         **TRACE))
        out[arch] = (prepack_tree(params_from_jax(
            jax.tree.map(np.asarray, jparams), "cpu")), stats, fin)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_engine_tokens_identical_to_jax_engine(jax_runs, arch):
    tparams, jstats, jfin = jax_runs[arch]
    cfg = tconfigs.get_config(arch).reduced(n_layers=2)
    engine = InferenceEngine(cfg, tconfigs.Runtime(**F32),
                             tconfigs.ServingConfig(**ENGINE_SV),
                             params=tparams, device="cpu")
    tstats, tfin = run_trace(engine, poisson_trace(vocab=cfg.vocab, **TRACE))
    assert all(r.outcome == "ok" for r in tfin)
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    for key in ("steps", "prefill_tokens", "decode_tokens"):
        assert tstats[key] == jstats[key], key
