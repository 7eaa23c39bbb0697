"""Port parity for M-RoPE (qwen2-vl-2b) and for the ragged step of the
dense head-dim-128 configs: the JAX package and the port on the same
seeded numpy inputs.

  (a) `apply_mrope` against the JAX package's with three distinct position
      streams (temporal, height, width) in float32 within 1e-6 (the same
      f32 op sequence; the two libraries' cos/sin differ by an ulp at
      most), and in bf16 within one bf16 step of the output's scale; with
      three equal streams it is the port's `apply_rope` bit for bit;
  (b) the reduced qwen2-vl-2b (2 layers, W4A4 serving weights in float32)
      fed three distinct streams: forward logits, a paged prefill and
      three decode steps within 1e-4 (float32 summation order only), the
      caches addressed by the temporal stream;
  (c) the port's ragged engine emits the JAX ragged engine's greedy tokens
      in float32 (W4A4 weights; float32 pool, and int8 for qwen3-4b) for
      qwen3-4b, qwen2-vl-2b and internlm2-20b, with the same step and
      token counts.  The JAX engines run once per file.  The int8 case
      runs the JAX engine with jit disabled: under `jax.jit` the JAX
      package's `quantize_kv` gives other int8 codes than its own eager
      op sequence in a few rows (2 of 40,000 seeded float32 (token, head)
      rows; ROADMAP Queue 3 item 3), which sends one request of this
      trace down another path from its first token; eager, the JAX
      engine's tokens are the port's.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.common import apply_mrope as j_apply_mrope  # noqa: E402
from repro.serving import kv_pages as jkv  # noqa: E402
from repro.serving.api import mixed_trace as j_mixed_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import apply_mrope, apply_rope  # noqa: E402
from repro_torch.serving import kv_pages as tkv  # noqa: E402
from repro_torch.serving.api import mixed_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

RNG = np.random.default_rng(31)
MROPE_ATOL = 1e-6
F32_ATOL = 1e-4
THETA = 1000000.0


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _streams(B, S, distinct=True):
    """[3, B, S] int32 position streams: a text run on the temporal stream,
    image-patch grids on the height and width streams (distinct), or the
    temporal stream three times."""
    t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if not distinct:
        return np.stack([t] * 3)
    h = (t // 4 + RNG.integers(0, 3, (B, 1))).astype(np.int32)
    w = (t % 4 * 3 + RNG.integers(0, 5, (B, 1))).astype(np.int32)
    return np.stack([t, h, w]).astype(np.int32)


# --------------------------------------------------- (a) apply_mrope ----
@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)), (16, (2, 3, 3))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_jax_with_distinct_streams(hd, sections, dtype):
    B, S, H = 2, 9, 3
    x = RNG.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = _streams(B, S)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = _f32(j_apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos), THETA,
                              sections))
    got = apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                      THETA, sections)
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    # f32: the same op sequence; bf16: one step at the output's scale
    atol = MROPE_ATOL if dtype == "float32" else \
        2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mrope_equal_streams_is_rope(dtype):
    B, S, H, hd = 2, 11, 2, 128
    x = torch.from_numpy(
        RNG.standard_normal((B, S, H, hd)).astype(np.float32)).to(dtype)
    pos = torch.from_numpy(_streams(B, S, distinct=False))
    got = apply_mrope(x, pos, THETA, (16, 24, 24))
    assert torch.equal(got, apply_rope(x, pos[0], THETA))
    want = j_apply_mrope(jnp.asarray(_f32(x), jnp.float32
                                     if dtype == torch.float32
                                     else jnp.bfloat16),
                         jnp.asarray(pos.numpy()), THETA, (16, 24, 24))
    atol = MROPE_ATOL if dtype == torch.float32 else 2.0 ** -7 * 4
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=atol)


def test_apply_mrope_refuses_sections_off_hd():
    x = torch.zeros((1, 2, 1, 16))
    pos = torch.zeros((3, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="hd/2"):
        apply_mrope(x, pos, THETA, (2, 3, 4))


# ------------------------------- (b) qwen2-vl-2b on three streams ----
def test_qwen2_vl_three_streams_logits_match():
    arch = "qwen2-vl-2b"
    jcfg = jconfigs.get_config(arch).reduced(n_layers=2)
    cfg = tconfigs.get_config(arch).reduced(n_layers=2)
    kw = dict(quant_backend="w4a4_packed", compute_dtype="float32",
              cache_dtype="float32", attn_impl="chunked",
              paged_attn="gather")
    jrt = jconfigs.Runtime(**kw, aligned_decode=False, remat="none",
                           loss_chunk=0)
    rt = tconfigs.Runtime(**kw)
    jp = j_build_params(jcfg, jrt, seed=4)
    tp = prepack_tree(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    B, S = 2, 12
    tokens = RNG.integers(0, 256, (B, S)).astype(np.int32)
    feed = RNG.integers(0, 256, (B, 3)).astype(np.int32)
    pos = _streams(B, S)
    out_j = [_f32(jt.forward(jp, jnp.asarray(tokens), jcfg, jrt,
                             jnp.asarray(pos))[0])]
    out_t = [_f32(tt.forward(tp, torch.from_numpy(tokens), cfg, rt,
                             torch.from_numpy(pos))[0])]
    sv = dict(layout="paged", max_batch=2, page_size=4, num_pages=16,
              max_ctx=24)
    tbl = np.array([[0, 1, 2, 3, 4, 5], [9, 7, 11, 6, 16, 16]], np.int32)
    jc = jkv.with_block_tables(
        jkv.init_paged_caches(jcfg, jrt, B, jconfigs.ServingConfig(**sv)),
        jnp.asarray(tbl))
    tc = tkv.with_block_tables(
        tkv.init_paged_caches(cfg, rt, tconfigs.ServingConfig(**sv),
                              device="cpu"), torch.from_numpy(tbl))
    lj, jc = jt.prefill(jp, jnp.asarray(tokens), jcfg, jrt, jc,
                        jnp.asarray(pos))
    lt, tc = tt.prefill(tp, torch.from_numpy(tokens), cfg, rt, tc,
                        torch.from_numpy(pos))
    out_j.append(_f32(lj)[:, None])
    out_t.append(_f32(lt)[:, None])
    for i in range(feed.shape[1]):
        step = (pos[:, :, -1:] + 1 + i).astype(np.int32)       # [3, B, 1]
        lj, jc = jt.decode_step(jp, jnp.asarray(feed[:, i:i + 1]), jcfg, jrt,
                                jc, jnp.asarray(step))
        lt, tc = tt.decode_step(tp, torch.from_numpy(feed[:, i:i + 1]), cfg,
                                rt, tc, torch.from_numpy(step))
        out_j.append(_f32(lj)[:, None])
        out_t.append(_f32(lt)[:, None])
    V = cfg.vocab
    want = np.concatenate([o[..., :V] for o in out_j], axis=1)
    got = np.concatenate([o[..., :V] for o in out_t], axis=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    # the pools were written at the temporal positions, as the reference's
    np.testing.assert_allclose(
        tc["rep"]["u0"]["attn"]["k"].numpy(),
        np.asarray(jc["rep"]["u0"]["attn"]["k"]), rtol=0, atol=F32_ATOL)


# ------------------------------------------ (c) the ragged engines ----
RAGGED_SV = dict(layout="paged", max_batch=4, page_size=4, num_pages=40,
                 max_ctx=48, step="ragged")
MIXED = dict(n_requests=5, prompt_lens=(5, 9, 14), gen_lens=(3, 5), seed=8)
F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32")
RAGGED_CASES = [("qwen3-4b", "float32"), ("qwen3-4b", "int8"),
                ("qwen2-vl-2b", "float32"), ("internlm2-20b", "float32")]


@pytest.fixture(scope="module")
def jax_ragged():
    """{(arch, pool): (port weights, JAX stats, JAX finished)}: the JAX
    ragged engine on the reduced configs (2 layers), W4A4 in float32;
    eager on a quantized pool (the module docstring's (c))."""
    out, weights = {}, {}
    for arch, pool in RAGGED_CASES:
        jcfg = jconfigs.get_config(arch).reduced(n_layers=2)
        jrt = jconfigs.Runtime(**F32, cache_dtype=pool, remat="none",
                               loss_chunk=0)
        if arch not in weights:
            jp = j_build_params(jcfg, jrt, seed=5)
            weights[arch] = (jp, prepack_tree(params_from_jax(
                jax.tree.map(np.asarray, jp), "cpu")))
        with jax.disable_jit(pool != "float32"):
            engine = JEngine(jcfg, jrt, jconfigs.ServingConfig(**RAGGED_SV),
                             params=weights[arch][0])
            stats, fin = j_run_trace(engine, j_mixed_trace(vocab=jcfg.vocab,
                                                           **MIXED))
        out[(arch, pool)] = (weights[arch][1], stats, fin)
    return out


@pytest.mark.parametrize("arch,pool", RAGGED_CASES)
def test_ragged_engine_tokens_identical_to_jax_engine(jax_ragged, arch,
                                                      pool):
    tparams, jstats, jfin = jax_ragged[(arch, pool)]
    cfg = tconfigs.get_config(arch).reduced(n_layers=2)
    engine = InferenceEngine(cfg, tconfigs.Runtime(**F32, cache_dtype=pool),
                             tconfigs.ServingConfig(**RAGGED_SV),
                             params=tparams, device="cpu")
    tstats, tfin = run_trace(engine, mixed_trace(vocab=cfg.vocab, **MIXED))
    assert all(r.outcome == "ok" for r in tfin)
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    for key in ("steps", "prefill_tokens", "decode_tokens",
                "padding_tokens_wasted", "token_budget"):
        assert tstats[key] == jstats[key], key
    assert tstats["step_mode"] == "ragged"
