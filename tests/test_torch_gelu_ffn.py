"""Port parity for the GELU FFN with biases and the sinusoidal stacks:
starcoder2-7b (GELU MLP with biases, qkv bias, RoPE, G = 9) and
musicgen-large (GELU MLP, ``rope="none"``: sinusoidal positions added to
the embeddings, MHA), the JAX package and the port on the same weights.

  (a) the port's configs are the JAX package's, field for field, with the
      same head dim and padded vocab (musicgen-large's 2048 unpadded);
  (b) the port's init draws the JAX package's tree (w_in, w_out, zero
      b_in / b_out, no w_gate); the SwiGLU FFN's ``d_ff`` override;
  (c) ``apply_ffn`` with random biases against the JAX package's on seeded
      numpy inputs: float32 within 1e-5, and bf16 bit for bit on float
      weights (the tanh GeLU composed op by op, as XLA rounds it);
  (d) on the reduced configs (2 layers) with the JAX package's W4A4
      serving weights in float32: forward logits, a paged prefill of a
      left-padded prompt and three decode steps within 1e-4;
  (e) the port's engine emits the JAX engine's greedy tokens in float32
      (W4A4 weights, float32 cache, chunked prefill, the paged bucketed
      step), with the same step and token counts.  The JAX engines run
      once per file, in a module-scoped fixture.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import kv_pages as jkv  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import kv_pages as tkv  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    InferenceEngine, build_params)

ARCHS = ("starcoder2-7b", "musicgen-large")
F32_ATOL = 1e-4
FFN_F32_ATOL = 1e-5

SV = dict(layout="paged", max_batch=2, page_size=4, num_pages=24, max_ctx=32)
B, S, PAD = 2, 16, (0, 5)
RNG = np.random.default_rng(28)
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
    assert (cfg.hd, cfg.vocab_padded) == (jcfg.hd, jcfg.vocab_padded)
    assert cfg.ffn_type == "gelu"
    if arch == "musicgen-large":
        assert (cfg.rope, cfg.vocab_padded, cfg.hd) == ("none", 2048, 64)
        assert not cfg.tie_embeddings


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
    ffn = tp["layers"]["u0"]["ffn"]
    assert "w_gate" not in ffn
    assert ("b_in" in ffn) == cfg.mlp_bias
    if cfg.mlp_bias:
        assert not ffn["b_in"].any() and not ffn["b_out"].any()


def test_swiglu_d_ff_override_draws_the_jax_shapes():
    jcfg = jconfigs.get_config("qwen2-0.5b").reduced()
    cfg = tconfigs.get_config("qwen2-0.5b").reduced()
    jp = jffn.init_ffn(jax.random.PRNGKey(0), jcfg, d_ff=48)
    tp = tffn.init_ffn(torch.Generator().manual_seed(0), cfg, d_ff=48)
    assert _leaves(tp) == _leaves(jp)
    assert tp["w_gate"].shape == (cfg.d_model, 48)


# ----------------------------------------------------- (c) apply_ffn ----
def _ffn_pair(dtype):
    cfg_j = jconfigs.get_config("starcoder2-7b").reduced()
    cfg_t = tconfigs.get_config("starcoder2-7b").reduced()
    rng = np.random.default_rng(3)
    D, F = cfg_t.d_model, cfg_t.d_ff
    p = {"w_in": rng.standard_normal((D, F)).astype(np.float32) / 8,
         "w_out": rng.standard_normal((F, D)).astype(np.float32) / 11,
         "b_in": rng.standard_normal(F).astype(np.float32),
         "b_out": rng.standard_normal(D).astype(np.float32)}
    x = rng.standard_normal((3, 7, D)).astype(np.float32)
    jrt = jconfigs.Runtime(quant_backend="float", compute_dtype=dtype)
    trt = tconfigs.Runtime(quant_backend="float", compute_dtype=dtype)
    yj = jffn.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x).astype(dtype), cfg_j, jrt)
    yt = tffn.apply_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).to(getattr(torch, dtype)), cfg_t,
                        trt)
    assert yt.dtype == getattr(torch, dtype)
    return _f32(yj), _f32(yt)


def test_gelu_ffn_with_biases_float32():
    want, got = _ffn_pair("float32")
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_F32_ATOL)


def test_gelu_ffn_with_biases_bf16_bit_for_bit():
    want, got = _ffn_pair("bfloat16")
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- (d) the logits ----
def _run_both(arch):
    """(jax logits, port logits): teacher-forced forward, then a paged
    prefill and 3 decode steps, W4A4 weights in float32."""
    jcfg = jconfigs.get_config(arch).reduced(n_layers=2)
    cfg = tconfigs.get_config(arch).reduced(n_layers=2)
    kw = dict(quant_backend="w4a4_packed", compute_dtype="float32",
              cache_dtype="float32", attn_impl="chunked", paged_attn="gather")
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
    want, got = _run_both(arch)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


# ---------------------------------------------- (e) the engine's tokens --
ENGINE_SV = dict(layout="paged", max_batch=3, page_size=4, num_pages=24,
                 max_ctx=40)
TRACE = dict(n_requests=5, rate_per_step=0.8, prompt_lens=(5, 11),
             gen_lens=(3, 6), seed=10)
F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32", cache_dtype="float32")


@pytest.fixture(scope="module")
def jax_runs():
    """{arch: (port weights, JAX stats, JAX finished requests)}."""
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
