"""Port parity for the Mamba-2 SSD mixer (``repro_torch.models.ssm``) and
the mamba2-130m stack served through the contiguous layout: the JAX
package's reduced config (d_model 64, state 32, head dim 16, chunk 16) on
the same weights (``convert.params_from_jax``), in float32.

Tolerance: ``rtol=2e-4, atol=2e-5``, the bound the JAX package holds its
own SSD to across chunk sizes (``tests/test_invariants.py::
test_ssd_chunk_size_invariance``).  The port carries the state across
chunks in a loop where the JAX package runs ``lax.associative_scan``, and
its einsums sum in other orders, so the two differ by float32 rounding
only.  Greedy tokens of the two engines must be equal.  The JAX forwards
and engines run once per file, in module-scoped fixtures."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import Runtime as JRuntime  # noqa: E402
from repro.configs import ServingConfig as JServingConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import quant_plan as jplan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.configs import Runtime, ServingConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant_plan as tplan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ARCH = "mamba2-130m"
TOL = dict(rtol=2e-4, atol=2e-5)
F32 = dict(compute_dtype="float32", quant_backend="float")
RNG = np.random.default_rng(11)


def _jrt(**kw):
    return JRuntime(**kw, remat="none", loss_chunk=0)


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.fixture(scope="module")
def mamba():
    """The reduced config, one block's JAX params and the port's copy."""
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(np.asarray,
                      jssm.init_mamba(jax.random.PRNGKey(3), jcfg))
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def test_config_mirrors_the_jax_package():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert (c.d_inner, c.ssm_heads) == (j.d_inner, j.ssm_heads)
        assert tssm.conv_dim(c) == jssm.conv_dim(j)
    assert (cfg.d_inner, cfg.ssm_heads, tssm.conv_dim(cfg)) == (1536, 24, 1792)
    assert 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads == 3352


def test_init_shapes_and_dtypes_mirror_the_jax_package(mamba):
    jcfg, cfg, jp, _ = mamba
    tp = tssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    for key in ("A_log", "D", "dt_bias", "norm_w", "conv_b"):
        np.testing.assert_allclose(_np(tp[key]), jp[key], rtol=1e-6,
                                   atol=1e-7)
    jc = jssm.init_mamba_cache(jcfg, 3)
    tc = tssm.init_mamba_cache(cfg, 3, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tc.items()} == \
        {k: (v.shape, "torch." + str(v.dtype)) for k, v in jc.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(mamba, with_state):
    jcfg, cfg, jp, tp = mamba
    C = tssm.conv_dim(cfg)
    x = RNG.standard_normal((2, 7, C)).astype(np.float32)
    state = (RNG.standard_normal((2, cfg.ssm_conv - 1, C)).astype(np.float32)
             if with_state else None)
    jy, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(jp["conv_w"]),
                               jnp.asarray(jp["conv_b"]),
                               None if state is None else jnp.asarray(state))
    ty, ts = tssm._causal_conv(torch.from_numpy(x), tp["conv_w"],
                               tp["conv_b"],
                               None if state is None
                               else torch.from_numpy(state))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert ts.dtype == torch.float32


def _both(mamba, x, cache, update, **rt_kw):
    """apply_mamba of both packages on the same x and cache (numpy)."""
    jcfg, cfg, jp, tp = mamba
    jc = None if cache is None else {k: jnp.asarray(v)
                                     for k, v in cache.items()}
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    jy, jnc = _j_apply_mamba(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             jc, jcfg, _jrt(**rt_kw), update)
    ty, tnc = tssm.apply_mamba(tp, torch.from_numpy(x), cfg,
                               Runtime(**rt_kw), tc, update)
    return (np.asarray(jy), jnc), (_np(ty), tnc)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _j_apply_mamba(params, x, cache, cfg, rt, update):
    """The JAX package's apply_mamba, compiled once per config (its eager
    op-by-op dispatch is the slow part of this file)."""
    return jssm.apply_mamba(params, x, cfg, rt, cache, update)


def _cache(cfg, B):
    return {"conv": RNG.standard_normal(
                (B, cfg.ssm_conv - 1, tssm.conv_dim(cfg))).astype(np.float32),
            "ssd": 0.3 * RNG.standard_normal(
                (B, cfg.ssm_heads, cfg.ssm_headdim,
                 cfg.ssm_state)).astype(np.float32)}


@pytest.mark.parametrize("S,with_cache", [(37, False), (16, True),
                                          (40, True)])
def test_apply_mamba_prefill_matches_jax(mamba, S, with_cache):
    """The chunked SSD: S = 37 pads the last chunk, 40 carries a state
    across three chunks from a nonzero starting state."""
    cfg = mamba[1]
    x = RNG.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 2) if with_cache else None
    (jy, jnc), (ty, tnc) = _both(mamba, x, cache, True, **F32)
    np.testing.assert_allclose(ty, jy, **TOL)
    if with_cache:
        for key in ("conv", "ssd"):
            np.testing.assert_allclose(_np(tnc[key]), np.asarray(jnc[key]),
                                       **TOL)
    assert np.isfinite(ty).all()


def test_apply_mamba_decode_matches_jax(mamba):
    cfg = mamba[1]
    x = RNG.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    (jy, jnc), (ty, tnc) = _both(mamba, x, _cache(cfg, 3), True, **F32)
    np.testing.assert_allclose(ty, jy, **TOL)
    for key in ("conv", "ssd"):
        np.testing.assert_allclose(_np(tnc[key]), np.asarray(jnc[key]),
                                   **TOL)


def test_apply_mamba_w4a4_in_float32_matches_jax(mamba):
    """Both projections through the W4A4 GEMM (int_sim: the fused kernel's
    plain version on the CPU) in float32."""
    cfg = mamba[1]
    x = RNG.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    (jy, _), (ty, _) = _both(mamba, x, None, False,
                             compute_dtype="float32", quant_backend="int_sim")
    np.testing.assert_allclose(ty, jy, **TOL)


@pytest.fixture(scope="module")
def stack():
    """The reduced mamba2-130m stack (2 layers) in both packages on the
    JAX package's weights."""
    jcfg = j_get_config(ARCH).reduced(n_layers=2)
    cfg = get_config(ARCH).reduced(n_layers=2)
    jparams = jt.init_model(jax.random.PRNGKey(1), jcfg)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunk_size_invariance(stack, chunk):
    """Logits of a 32-token forward do not depend on the chunk length (the
    JAX package's invariance, held by the port) and equal the JAX
    package's single-chunk logits."""
    jcfg, cfg, jparams, params = stack
    toks = RNG.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    jref = np.asarray(jt.forward(jparams, jnp.asarray(toks),
                                 dataclasses.replace(jcfg, ssm_chunk=32),
                                 _jrt(**F32))[0])
    got, _ = tt.forward(params, torch.from_numpy(toks),
                        dataclasses.replace(cfg, ssm_chunk=chunk),
                        Runtime(**F32))
    np.testing.assert_allclose(_np(got), jref, **TOL)


def test_prefill_then_decode_equals_forward(stack):
    """Serve path == train path on contiguous caches (f32), as
    ``tests/test_models_smoke.py`` holds the JAX package, through
    ``launch.steps.make_prefill_step`` / ``make_decode_step``; the port's
    prefill logits also equal the JAX package's."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    jcfg, cfg, jparams, params = stack
    rt = Runtime(**F32, cache_dtype="float32")
    prefill, decode = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
    B, S, P = 2, 24, 16
    toks = RNG.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tk = torch.from_numpy(toks)
    full, _ = tt.forward(params, tk, cfg, rt)
    full = _np(full)
    caches = tt.init_caches(cfg, rt, batch=B, seq=S, device="cpu")
    lg, caches = prefill(params, tk[:, :P], caches)
    errs = [np.abs(_np(lg) - full[:, P - 1]).max()]
    jlg, _ = jt.prefill(jparams, jnp.asarray(toks[:, :P]), jcfg,
                        _jrt(**F32, cache_dtype="float32"),
                        jt.init_caches(jcfg, _jrt(**F32), batch=B, seq=S))
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    for t in range(P, S):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        lg, caches = decode(params, tk[:, t:t + 1], caches, pos)
        errs.append(np.abs(_np(lg) - full[:, t]).max())
    assert max(errs) < 5e-5, max(errs)


def test_quant_plan_sites_and_packing(stack):
    """The Mamba sites resolve and pack as in the JAX package: in_proj and
    out_proj pre-packed under w4a4_packed (their bytes and scales equal),
    conv_w and the vectors left as masters."""
    jcfg, cfg, jparams, params = stack
    assert tplan.block_leaf_sites("M", cfg) == jplan.block_leaf_sites(
        "M", jcfg)
    plan = tplan.get_plan("*=w4a4_packed;lm_head=float")
    jpk = jplan.plan_pack_tree(jparams, jcfg,
                               jplan.get_plan("*=w4a4_packed;lm_head=float"))
    tpk = tplan.plan_pack_tree(params, cfg, plan)
    for name in ("in_proj", "out_proj"):
        j, t = jpk["layers"]["u0"]["mamba"][name], \
            tpk["layers"]["u0"]["mamba"][name]
        for key in ("packed", "scale"):
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))
    assert isinstance(tpk["layers"]["u0"]["mamba"]["conv_w"], torch.Tensor)
    # a plan that differs between layers splits the stack into blocks
    split = tplan.plan_pack_tree(params, cfg, tplan.get_plan(
        "block[0].*=float;*=w4a4_packed;lm_head=float"))
    assert isinstance(split["layers"], list) and len(split["layers"]) == 2
    assert isinstance(split["layers"][0]["mamba"]["in_proj"], torch.Tensor)
    assert "packed" in split["layers"][1]["mamba"]["in_proj"]


def test_rglru_and_moe_raise():
    for arch in ("recurrentgemma-9b", "arctic-480b"):
        jcfg = j_get_config(arch).reduced()
        cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                  name=jcfg.name, family=jcfg.family,
                                  pattern=jcfg.pattern, tail=jcfg.tail)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            tt.init_model(torch.Generator().manual_seed(0), cfg)


# ----------------------------------------------------------- the engine ----
ENGINE_SV = dict(layout="contiguous", max_batch=3, max_ctx=48)
TRACE = dict(n_requests=5, rate_per_step=0.8, prompt_lens=(5, 11, 16),
             gen_lens=(4, 7), seed=6)
#: name -> Runtime keywords (float32 activations)
ENGINE_PLANS = {"float": dict(quant_plan="*=float"),
                "w4a4": dict(quant_backend="w4a4_packed")}


@pytest.fixture(scope="module")
def jax_engine_runs():
    jcfg = j_get_config(ARCH).reduced(n_layers=2)
    masters = jt.init_model(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name, kw in ENGINE_PLANS.items():
        jrt = _jrt(compute_dtype="float32", **kw)
        engine = JEngine(jcfg, jrt, JServingConfig(**ENGINE_SV),
                         params=jplan.pack_for_serving(masters, jcfg, jrt))
        engine.warmup(TRACE["prompt_lens"])
        out[name] = j_run_trace(engine, j_poisson_trace(vocab=jcfg.vocab,
                                                        **TRACE))
    return jax.tree.map(np.asarray, masters), out


@pytest.mark.parametrize("name", sorted(ENGINE_PLANS))
def test_engine_tokens_equal_the_jax_engine(jax_engine_runs, name):
    """The reduced mamba engine (contiguous, exact-length prefill) emits
    the JAX engine's greedy tokens in float32, with float weights and with
    W4A4-packed projections; one prefill shape per prompt length."""
    masters, runs = jax_engine_runs
    jstats, jfin = runs[name]
    cfg = get_config(ARCH).reduced(n_layers=2)
    rt = Runtime(compute_dtype="float32", **ENGINE_PLANS[name])
    engine = InferenceEngine(cfg, rt, ServingConfig(**ENGINE_SV),
                             params=tplan.pack_for_serving(
                                 params_from_jax(masters, "cpu"), cfg, rt),
                             device="cpu")
    engine.warmup(TRACE["prompt_lens"])
    tstats, tfin = run_trace(engine, poisson_trace(vocab=cfg.vocab, **TRACE))
    assert all(r.outcome == "ok" for r in tfin)
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    for key in ("prefill_tokens", "decode_tokens", "steps",
                "padding_tokens_wasted"):
        assert tstats[key] == jstats[key], key
    assert tstats["recompiles"]["by_fn"] == jstats["recompiles"]["by_fn"]
    assert tstats["recompiles"]["by_fn"]["prefill"] == 3
    assert tstats["recompiles"]["steady_state"] == 0
    assert tstats["layout"] == "contiguous"


def test_mamba_refuses_the_paged_layout():
    cfg = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="use layout='contiguous'"):
        InferenceEngine(cfg, Runtime(**F32), ServingConfig(), device="cpu")


def test_serve_cli_defaults_to_contiguous_for_mamba(capsys, monkeypatch):
    import json
    import sys

    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--requests", "3", "--prompt-lens", "5,9", "--gen-lens", "3"])
    serve.main()
    report = json.loads(capsys.readouterr().out)
    assert report["layout"] == "contiguous"
    assert report["contiguous"]["requests_finished"] == 3
    assert report["recompiles_steady_state"] == 0
    assert report["contiguous"]["profile"]["attn_us"] == 0.0


def test_new_modules_import_no_jax():
    """The slice's modules (the SSD mixer, the mamba2-130m config, the
    contiguous steps) import neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "src"
    probe = ("import sys, repro_torch.models.ssm, "
             "repro_torch.configs.mamba2_130m, repro_torch.launch.steps, "
             "repro_torch.launch.serve; print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
