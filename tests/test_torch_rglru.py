"""Port parity for the RG-LRU block (``repro_torch.models.rglru``) and the
hybrid recurrentgemma-9b stack served through the contiguous layout: the
JAX package's reduced config (5 layers, (R, R, A) + (R, R), d_model 64,
lru_width 64, 4 heads over 1 KV head, local window 16) on the same
weights (``convert.params_from_jax``), in float32.

Tolerances.  Decode is one recurrence step; its projections and
elementwise ops run in the same order as the JAX package's, but XLA's
``exp``, ``tanh`` and ``log1p`` on the CPU are not PyTorch's, so it is held
to ``DECODE_TOL`` (a few float32 steps; measured 2.4e-7 on outputs up to
2.5, 4.8e-7 on the state).  Prefill runs a doubling scan where the JAX package runs
``lax.associative_scan``: the same products in another order, held to
``rtol=2e-4, atol=2e-5``, the bound ``test_torch_ssm.py`` holds the SSD
to (and the whole stack's logits likewise).  In bf16 the tanh GeLU and
the sigmoid gates are held to the JAX package bit for bit: composed op by
op, each op rounding to bf16, as XLA evaluates them.  Greedy tokens of the
two engines must be equal.  The JAX forwards and engines run once per
file, in module-scoped fixtures."""

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
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.configs import Runtime, ServingConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant_plan as tplan  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=2e-4, atol=2e-5)
#: one recurrence step (decode): a few float32 steps of the block's output
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)
F32 = dict(compute_dtype="float32", quant_backend="float")
RNG = np.random.default_rng(17)


def _jrt(**kw):
    return JRuntime(**kw, remat="none", loss_chunk=0)


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.fixture(scope="module")
def lru():
    """The reduced config, one block's JAX RG-LRU params and the port's
    copy."""
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(np.asarray, jrg.init_rglru(jax.random.PRNGKey(3), jcfg))
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def test_config_mirrors_the_jax_package():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    r = cfg.reduced()
    assert (r.n_layers, r.n_repeats, r.d_model, r.lru_width,
            r.local_window, r.n_kv_heads) == (5, 1, 64, 64, 16, 1)
    assert (cfg.n_repeats, cfg.hd, cfg.vocab_padded) == (12, 256, 256000)


def test_init_shapes_and_dtypes_mirror_the_jax_package(lru):
    jcfg, cfg, jp, _ = lru
    tp = trg.init_rglru(torch.Generator().manual_seed(0), cfg)
    assert sorted(tp) == sorted(jp)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    for key in ("conv_b", "b_a", "b_x"):
        np.testing.assert_array_equal(_np(tp[key]), jp[key])
    # log(expm1(c)) at c ~ 1e-4 (a^c near 0.999) magnifies the one-ulp
    # differences of the two libraries' log and expm1 (measured 3e-6
    # relative)
    np.testing.assert_allclose(_np(tp["lam"]), jp["lam"], rtol=1e-5)
    jc = jrg.init_rglru_cache(jcfg, 3)
    tc = trg.init_rglru_cache(cfg, 3, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tc.items()} == \
        {k: (v.shape, "torch." + str(v.dtype)) for k, v in jc.items()}


_J_GELU = jax.jit(jax.nn.gelu)
_J_SIGMOID = jax.jit(jax.nn.sigmoid)
#: (the JAX package's function, compiled; the port's)
ELEMENTWISE = {"gelu": (_J_GELU, trg.gelu_tanh),
               "sigmoid": (_J_SIGMOID, trg._logistic)}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_gelu_and_gates_round_as_xla_in_bf16(name):
    """The tanh GeLU and the sigmoid gates in bf16 equal ``jax.nn.gelu``
    and ``jax.nn.sigmoid`` bit for bit (a fused PyTorch gelu / sigmoid
    rounds once and differs in ~40% of these elements)."""
    jf, tf = ELEMENTWISE[name]
    x = (RNG.standard_normal(100_000) * 4).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    got = tf(tx)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jf(jx).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    fused = (torch.nn.functional.gelu(tx, approximate="tanh")
             if name == "gelu" else torch.sigmoid(tx))
    assert (fused.float().numpy() != want).any()


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_gelu_and_gates_in_float32(name):
    """In float32 the same ops agree within a few float32 steps: XLA's
    tanh and exp on the CPU are not PyTorch's (measured 5.8e-7
    absolute)."""
    jf, tf = ELEMENTWISE[name]
    x = (RNG.standard_normal(100_000) * 4).astype(np.float32)
    np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 37])
def test_linear_scan_is_the_recurrence(S):
    """The doubling scan equals the step-by-step recurrence (float64, so
    the orders agree to rounding)."""
    a = torch.from_numpy(RNG.uniform(0.2, 1.0, (2, S, 5)))
    b = torch.from_numpy(RNG.standard_normal((2, S, 5)))
    h, want = torch.zeros((2, 5), dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(trg.linear_scan(a, b).numpy(),
                               torch.stack(want, dim=1).numpy(), rtol=1e-12,
                               atol=1e-12)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _j_apply_rglru(params, x, cache, cfg, rt, update):
    """The JAX package's apply_rglru, compiled once per config."""
    return jrg.apply_rglru(params, x, cfg, rt, cache, update)


def _both(lru, x, cache, update, **rt_kw):
    """apply_rglru of both packages on the same x and cache (numpy)."""
    jcfg, cfg, jp, tp = lru
    jc = None if cache is None else {k: jnp.asarray(v)
                                     for k, v in cache.items()}
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    jy, jnc = _j_apply_rglru(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             jc, jcfg, _jrt(**rt_kw), update)
    ty, tnc = trg.apply_rglru(tp, torch.from_numpy(x), cfg,
                              Runtime(**rt_kw), tc, update)
    return (np.asarray(jy), jnc), (_np(ty), tnc)


def _cache(cfg, B):
    W = cfg.lru_width
    return {"conv": RNG.standard_normal(
                (B, cfg.ssm_conv - 1, W)).astype(np.float32),
            "h": RNG.standard_normal((B, W)).astype(np.float32)}


def test_apply_rglru_decode_matches_jax(lru):
    """Eight decode steps, each from the state the last one left (a
    non-zero start): the output and the new conv and h state at
    DECODE_TOL (measured max |diff| 2.4e-7 on outputs up to 2.5)."""
    cfg = lru[1]
    cache = _cache(cfg, 3)
    for _ in range(8):
        x = RNG.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        (jy, jnc), (ty, tnc) = _both(lru, x, cache, True, **F32)
        np.testing.assert_allclose(ty, jy, **DECODE_TOL)
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np(tnc[key]), np.asarray(jnc[key]),
                                       **DECODE_TOL)
        cache = {k: np.asarray(v) for k, v in jnc.items()}


@pytest.mark.parametrize("S,with_cache", [(37, False), (16, True),
                                          (40, True)])
def test_apply_rglru_prefill_matches_jax(lru, S, with_cache):
    """The scan from zero state (S = 37) and from a non-zero h and conv
    state (a resume), its final state returned."""
    cfg = lru[1]
    x = RNG.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 2) if with_cache else None
    (jy, jnc), (ty, tnc) = _both(lru, x, cache, True, **F32)
    np.testing.assert_allclose(ty, jy, **TOL)
    if with_cache:
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np(tnc[key]), np.asarray(jnc[key]),
                                       **TOL)
    assert np.isfinite(ty).all()


def test_apply_rglru_w4a4_in_float32_matches_jax(lru):
    """The five projections through the W4A4 GEMM (int_sim: the fused
    kernel's plain version on the CPU), the gates' biases on top."""
    jcfg, cfg, jp, tp = lru
    x = RNG.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    (jy, _), (ty, _) = _both(lru, x, None, False, compute_dtype="float32",
                             quant_backend="int_sim")
    np.testing.assert_allclose(ty, jy, **TOL)


# ------------------------------------------------------------ the stack ----
@pytest.fixture(scope="module")
def stack():
    """The reduced recurrentgemma-9b stack (5 layers) in both packages on
    the JAX package's weights, the gate biases made non-zero."""
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jt.init_model(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(4)
    for unit in ("u0", "u1"):
        for b in ("b_a", "b_x"):
            leaf = jparams["layers"][unit]["lru"][b]
            jparams["layers"][unit]["lru"][b] = jnp.asarray(
                0.5 * rng.standard_normal(leaf.shape), jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


#: name -> (Runtime keywords, plan of the packed weights or None)
STACK_PLANS = {"float": dict(quant_plan="*=float"),
               "w4a4_packed": dict(quant_backend="w4a4_packed")}


@functools.partial(jax.jit, static_argnums=(2, 3))
def _j_forward(params, tokens, cfg, rt):
    return jt.forward(params, tokens, cfg, rt)[0]


@functools.partial(jax.jit, static_argnums=(2, 3))
def _j_prefill(params, tokens, cfg, rt, caches):
    return jt.prefill(params, tokens, cfg, rt, caches)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _j_decode(params, token, cfg, rt, caches, positions):
    return jt.decode_step(params, token, cfg, rt, caches, positions)


@pytest.mark.parametrize("plan", sorted(STACK_PLANS))
def test_forward_matches_jax(stack, plan):
    """Logits of a 24-token forward under *=float and under W4A4-packed
    weights (the same packed bytes in both packages), float32."""
    jcfg, cfg, jparams, params = stack
    kw = dict(STACK_PLANS[plan], compute_dtype="float32")
    jrt, rt = _jrt(**kw), Runtime(**kw)
    jp = jplan.pack_for_serving(jparams, jcfg, jrt)
    tp = tplan.pack_for_serving(params, cfg, rt)
    toks = RNG.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    want = np.asarray(_j_forward(jp, jnp.asarray(toks), jcfg, jrt))
    got, _ = tt.forward(tp, torch.from_numpy(toks), cfg, rt)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_prefill_then_decode_matches_jax_and_forward(stack):
    """Serve path == train path on contiguous caches (float32) through
    ``launch.steps.make_prefill_step`` / ``make_decode_step``, as
    ``tests/test_models_smoke.py`` holds the JAX package, and each step's
    logits equal the JAX package's."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    jcfg, cfg, jparams, params = stack
    kw = dict(F32, cache_dtype="float32")
    rt, jrt = Runtime(**kw), _jrt(**kw)
    prefill, decode = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
    B, S, P = 2, 20, 12
    toks = RNG.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tk = torch.from_numpy(toks)
    full = _np(tt.forward(params, tk, cfg, rt)[0])
    caches = tt.init_caches(cfg, rt, batch=B, seq=S, device="cpu")
    jc = jt.init_caches(jcfg, jrt, batch=B, seq=S)
    lg, caches = prefill(params, tk[:, :P], caches)
    jlg, jc = _j_prefill(jparams, jnp.asarray(toks[:, :P]), jcfg, jrt, jc)
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    errs = [np.abs(_np(lg) - full[:, P - 1]).max()]
    for t in range(P, S):
        pos = np.full((B, 1), t, np.int32)
        lg, caches = decode(params, tk[:, t:t + 1], caches,
                            torch.from_numpy(pos))
        jlg, jc = _j_decode(jparams, jnp.asarray(toks[:, t:t + 1]), jcfg,
                            jrt, jc, jnp.asarray(pos))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        errs.append(np.abs(_np(lg) - full[:, t]).max())
    assert max(errs) < 5e-5, max(errs)


def test_local_window_ring_buffer_wraps(stack):
    """The JAX package's ``test_local_window_ring_buffer_wraps``: prefill
    8 tokens, decode to 40, far past the window of 16 (the ring wraps
    twice); every step's logits equal the port's own full forward and
    the JAX package's decode."""
    jcfg, cfg, jparams, params = stack
    assert cfg.local_window == 16
    kw = dict(F32, cache_dtype="float32", attn_chunk_q=8)
    rt, jrt = Runtime(**kw), _jrt(**kw)
    B, S, P = 1, 40, 8
    toks = RNG.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tk = torch.from_numpy(toks)
    with torch.inference_mode():
        full = _np(tt.forward(params, tk, cfg, rt)[0])
        caches = tt.init_caches(cfg, rt, batch=B, seq=S, device="cpu")
        lg, caches = tt.prefill(params, tk[:, :P], cfg, rt, caches)
    jc = jt.init_caches(jcfg, jrt, batch=B, seq=S)
    _, jc = _j_prefill(jparams, jnp.asarray(toks[:, :P]), jcfg, jrt, jc)
    assert caches["rep"]["u2"]["attn"]["k"].shape[2] == 16   # [R, B, 16, ..]
    errs = []
    for t in range(P, S):
        pos = np.full((B, 1), t, np.int32)
        with torch.inference_mode():
            lg, caches = tt.decode_step(params, tk[:, t:t + 1], cfg, rt,
                                        caches, torch.from_numpy(pos))
        jlg, jc = _j_decode(jparams, jnp.asarray(toks[:, t:t + 1]), jcfg,
                            jrt, jc, jnp.asarray(pos))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        errs.append(np.abs(_np(lg) - full[:, t]).max())
    assert max(errs) < 5e-5, max(errs)


def test_quant_plan_sites_and_packing(stack):
    """The R sites resolve and pack as in the JAX package: the five lru
    projections and the FFN's pre-packed under w4a4_packed (bytes and
    scales equal), conv_w, lam and the biases left as masters."""
    jcfg, cfg, jparams, params = stack
    for bt in ("R", "A"):
        assert tplan.block_leaf_sites(bt, cfg) == jplan.block_leaf_sites(
            bt, jcfg)
    plan = tplan.get_plan("*=w4a4_packed;lm_head=float")
    jlog, tlog = {}, {}
    jpk = jplan.plan_pack_tree(
        jparams, jcfg, jplan.get_plan("*=w4a4_packed;lm_head=float"),
        site_log=jlog)
    tpk = tplan.plan_pack_tree(params, cfg, plan, site_log=tlog)
    assert tlog == jlog
    assert tplan.plan_repeat_uniform(plan, cfg)
    for where in (("layers", "u0"), ("layers", "u1"), ("tail0",),
                  ("tail1",)):
        j, t = jpk, tpk
        for key in where:
            j, t = j[key], t[key]
        for name in ("in_x", "in_g", "w_a", "w_x", "out"):
            for key in ("packed", "scale"):
                np.testing.assert_array_equal(
                    t["lru"][name][key].numpy(),
                    np.asarray(j["lru"][name][key]))
        for name in ("w_in", "w_gate", "w_out"):
            assert "packed" in t["ffn"][name]
        for name in ("conv_w", "conv_b", "lam", "b_a", "b_x"):
            assert isinstance(t["lru"][name], torch.Tensor)
    assert isinstance(tpk["lm_head"]["w"], torch.Tensor)


# ----------------------------------------------------------- the engine ----
ENGINE_SV = dict(layout="contiguous", max_batch=2, max_ctx=48)
TRACE = dict(n_requests=5, rate_per_step=0.8, prompt_lens=(5, 19),
             gen_lens=(4, 9), seed=6)
#: name -> Runtime keywords (float32 activations and cache: a bf16 cache
#: puts the attention output on the bf16 grid, where ~17% of rows hold an
#: exact .5 quantize tie, and the JAX engine's jitted quantize, which
#: rounds as a multiply by the reciprocal, sends ~half of those the other
#: way; ROADMAP Queue 3 item 3)
ENGINE_PLANS = {"float": dict(quant_plan="*=float"),
                "w4a4": dict(quant_backend="w4a4_packed")}
ENGINE_RT = dict(compute_dtype="float32", cache_dtype="float32")


@pytest.fixture(scope="module")
def jax_engine_runs(stack):
    jcfg, _, masters, _ = stack
    out = {}
    for name, kw in ENGINE_PLANS.items():
        jrt = _jrt(**ENGINE_RT, **kw)
        engine = JEngine(jcfg, jrt, JServingConfig(**ENGINE_SV),
                         params=jplan.pack_for_serving(masters, jcfg, jrt))
        engine.warmup(TRACE["prompt_lens"])
        out[name] = j_run_trace(engine, j_poisson_trace(vocab=jcfg.vocab,
                                                        **TRACE))
    return out


#: an activation this close to a rounding boundary of the int4 quantize
#: (in units of its step) can round the other way in the JAX package,
#: whose float32 activations differ from the port's by ~1e-6 relative
#: (ROADMAP Queue 3 item 3): a request whose row holds one may emit other
#: tokens from that step on
TIE = 1e-5


def _serve_with_ties(engine, monkeypatch):
    """Serve TRACE (run_trace's arrivals) recording, for each engine step
    and batch slot, the closest any W4A4 activation of that slot's rows
    came to a .5 rounding boundary, the step each request's tokens came
    out of and its slot.  Returns (stats, finished, {(step, slot):
    closeness}, {rid: [step of token 0, ...]}, {rid: slot})."""
    import repro_torch.kernels.int4_matmul as im

    now = {"step": 0, "slots": []}
    ties, made, slot_of = {}, {}, {}
    quantize = im.quantize

    def spy(x, scale, bits=4):
        r = x / scale
        frac = (r - torch.floor(r) - 0.5).abs().amin(dim=1)    # per row
        per = frac.shape[0] // len(now["slots"])
        for i, slot in enumerate(now["slots"]):
            key = (now["step"], slot)
            ties[key] = min(ties.get(key, 1.0),
                            frac[i * per:(i + 1) * per].min().item())
        return quantize(x, scale, bits)

    def tagged(fn):
        def call(params, tokens, caches, positions, tbl, slots):
            now["slots"] = slots.tolist()
            return fn(params, tokens, caches, positions, tbl, slots)
        return call

    monkeypatch.setattr(im, "quantize", spy)
    for name in ("_prefill", "_decode"):
        monkeypatch.setattr(engine, name, tagged(getattr(engine, name)))
    engine_step = engine.step

    def step():
        now["step"] += 1
        out = engine_step()
        for r in engine.scheduler.running.values():
            slot_of.setdefault(r.rid, r.slot)
        for r in list(engine.scheduler.running.values()) + \
                engine._finished:
            got = made.setdefault(r.rid, [])
            got += [now["step"]] * (len(r.tokens) - len(got))
        return out

    monkeypatch.setattr(engine, "step", step)
    stats, fin = run_trace(engine, poisson_trace(vocab=engine.cfg.vocab,
                                                 **TRACE))
    return stats, fin, ties, made, slot_of


@pytest.mark.parametrize("name", sorted(ENGINE_PLANS))
def test_engine_tokens_equal_the_jax_engine(stack, jax_engine_runs, name,
                                            monkeypatch):
    """The reduced hybrid engine (contiguous, exact-length prefill, the
    window wrapping past 16 tokens) emits the JAX engine's greedy tokens
    in float32, with float weights and with W4A4-packed projections; one
    prefill shape per prompt length.  Under W4A4 a request's tokens must
    be equal up to the first step in which one of its rows held an
    activation within TIE of a rounding boundary (the quantize's tie
    rounding differs, ROADMAP Queue 3 item 3); the requests that meet none
    must be equal throughout (measured: all five equal)."""
    _, cfg, _, params = stack
    jstats, jfin = jax_engine_runs[name]
    rt = Runtime(**ENGINE_RT, **ENGINE_PLANS[name])
    engine = InferenceEngine(cfg, rt, ServingConfig(**ENGINE_SV),
                             params=tplan.pack_for_serving(params, cfg, rt),
                             device="cpu")
    engine.warmup(TRACE["prompt_lens"])
    tstats, tfin, ties, made, slot_of = _serve_with_ties(engine,
                                                         monkeypatch)
    assert all(r.outcome == "ok" for r in tfin)
    for key in ("prefill_tokens", "decode_tokens", "steps"):
        assert tstats[key] == jstats[key], key
    assert tstats["recompiles"]["by_fn"] == jstats["recompiles"]["by_fn"]
    assert tstats["recompiles"]["by_fn"]["prefill"] == 2
    assert tstats["layout"] == "contiguous"
    if name == "float":
        assert not ties
        assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
        return
    untied = 0
    for t, j in zip(tfin, jfin):
        steps = made[t.rid]
        tied = [s for (s, slot), f in ties.items()
                if slot == slot_of[t.rid] and steps[0] <= s <= steps[-1]
                and f < TIE]
        cut = min(tied, default=steps[-1] + 1)
        held = [i for i, s in enumerate(steps) if s < cut]
        assert [t.tokens[i] for i in held] == [j.tokens[i] for i in held]
        untied += not tied
    assert untied >= len(tfin) // 2


def test_reused_slot_starts_from_zero_state(stack):
    """With one slot, the second request takes the slot the first left:
    its prefill starts from zero h and conv state (the row is reset, not
    carried), so its tokens equal its run on a fresh engine, and after it
    the slot's state is its own."""
    _, cfg, _, params = stack
    rt = Runtime(**F32)
    sv = ServingConfig(layout="contiguous", max_batch=1, max_ctx=48)
    first, second = (RNG.integers(0, cfg.vocab, n).astype(np.int32)
                     for n in (13, 9))

    def serve(prompts):
        engine = InferenceEngine(cfg, rt, sv, params=params, device="cpu")
        for p in prompts:
            engine.submit(p, 6)
        engine.run_until_idle()
        return engine, {r.rid: r.tokens for r in engine.collect()}

    reused, toks = serve([first, second])
    fresh, alone = serve([second])
    assert toks[1] == alone[0]
    for unit in ("u0", "u1"):
        lru_a = reused.caches["rep"][unit]["lru"]
        lru_b = fresh.caches["rep"][unit]["lru"]
        for key in ("h", "conv"):
            assert torch.equal(lru_a[key], lru_b[key])


def test_serve_cli_defaults_to_contiguous_and_refuses_a_bad_depth(
        capsys, monkeypatch):
    import json
    import sys

    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--requests", "3", "--prompt-lens", "5,9", "--gen-lens", "3"])
    serve.main()
    report = json.loads(capsys.readouterr().out)
    assert report["layout"] == "contiguous" and report["n_layers"] == 5
    assert report["contiguous"]["requests_finished"] == 3
    assert report["recompiles_steady_state"] == 0
    prof = report["contiguous"]["profile"]
    assert 0 < prof["attn_us"] < prof["decode_step_us"] * 5
    for layers in (3, 6, 7):
        with pytest.raises(ValueError, match=r"2 \+ 3 \* k"):
            serve.model_config(ARCH, True, layers)
    assert serve.model_config(ARCH, False, 8).n_layers == 8
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--layers",
                                      "6", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main()
    assert "2 + 3 * k" in capsys.readouterr().err
