"""Port parity for the ragged token-major step and the quantized KV pools:
the JAX package and the port on the same seeded numpy inputs.

  (a) `quantize_kv` / `dequantize_kv`: bytes, scales and dequantized values
      equal the reference's exactly (integer outputs of one op sequence).
  (b) `paged_write` / `ragged_paged_write` into int8 and int4 pools: pool
      bytes and scales equal the reference's exactly, dropped rows
      (negative positions, padding slots, sentinel pages) included.
  (c) the plain paged decode version on int8/int4 pools against
      ``paged_decode_attention_xla``, and (d) the plain ragged version
      against ``ragged_attention_xla``, with the tolerances of
      tests/test_torch_kernels.py: float32 summation-order noise (1e-5) in
      f32 and one bf16 rounding step (2e-2) in bf16; padding rows exactly 0.
  (e) `plan_tokens` makes the reference's plans.
  (f) the port's ragged engine emits exactly the JAX ragged engine's greedy
      tokens in float32 (W4A4 weights, int8 pools included), with the same
      step and token counts; (g) on the port alone the ragged step emits the
      bucketed step's tokens; (h) the serve CLI's report on the CPU.
"""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.serving.kv_pages as jkv  # noqa: E402
import repro.serving.scheduler as jsched  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.serving.kv_pages as tkv  # noqa: E402
import repro_torch.serving.scheduler as tsched  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ragged_attention import ragged_attention_xla  # noqa: E402
from repro.models.attention import dequantize_kv as j_dequantize_kv  # noqa: E402
from repro.models.attention import quantize_kv as j_quantize_kv  # noqa: E402
from repro.serving.api import mixed_trace as j_mixed_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ragged_attention import (  # noqa: E402
    ragged_decode_attention_cuda, ragged_decode_attention_plain)
from repro_torch.models.attention import dequantize_kv, quantize_kv  # noqa: E402
from repro_torch.serving.api import bursty_trace, mixed_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

RNG = np.random.default_rng(12)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _np(x):
    """A JAX array or a torch tensor as numpy (bf16 through f32)."""
    if isinstance(x, torch.Tensor):
        return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _values(shape, jdt):
    """Seeded K/V-like values in dtype `jdt`, with an all-zero row (the
    +1e-8 of the scale) and a row of exact quantization ties."""
    v = (RNG.standard_normal(shape) * 3).astype(np.float32)
    v[0, 0] = 0.0
    v[0, 1] = np.linspace(-127, 127, shape[-1]) / 2      # x.5 steps
    return jnp.asarray(v, jdt)


# ------------------------------------------------------ (a) quantize_kv ----
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_kv_bytes_and_scales_equal(int4, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    val = _values((9, 5, 2, 16), jdt)
    jq, js = j_quantize_kv(val, int4)
    q, s = quantize_kv(_t(_np(val), tdt), int4)
    assert q.dtype == (torch.uint8 if int4 else torch.int8)
    assert s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_np(dequantize_kv(q, s)),
                                  _np(j_dequantize_kv(jq, js)))


# -------------------------------------------- (b) writes into the pools ----
def _pool_pair(cache_dtype, P=7, ps=4, pps=4, maxB=3):
    """One layer's pool in both packages (zeros), with its geometry."""
    cfg = tconfigs.get_config("qwen2-0.5b").reduced()
    sv = dict(layout="paged", max_batch=maxB, page_size=ps, num_pages=P,
              max_ctx=pps * ps)
    jc = jkv.init_paged_attn_cache(cfg, jconfigs.Runtime(
        cache_dtype=cache_dtype), maxB, jconfigs.ServingConfig(**sv))
    tc = tkv.init_paged_caches(cfg, tconfigs.Runtime(cache_dtype=cache_dtype),
                               tconfigs.ServingConfig(**sv), device="cpu")
    tc = {k: v[0] for k, v in tc["rep"]["u0"]["attn"].items()}
    return cfg, jc, tc


def _assert_pools_equal(jc, tc):
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                      err_msg=name)


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_write_quantized_pool_equal(cache_dtype, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    cfg, jc, tc = _pool_pair(cache_dtype)
    P = jc["k"].shape[0]
    tbl = np.array([[2, 5, P, P], [0, 3, 6, P]], np.int32)  # sentinel slots
    pos = np.array([[-1, 3, 4, 9, 13], [0, 1, 6, 11, -2]], np.int32)
    k = _values((2, 5, cfg.n_kv_heads, cfg.hd), jdt)
    v = _values((2, 5, cfg.n_kv_heads, cfg.hd), jdt)
    jout = jkv.paged_write(dict(jc, tbl=jnp.asarray(tbl)), k, v,
                           jnp.asarray(pos))
    tkv.paged_write(dict(tc, tbl=_t(tbl)), _t(_np(k), tdt), _t(_np(v), tdt),
                    _t(pos))
    _assert_pools_equal(jout, tc)
    assert tc["k_scale"].count_nonzero() > 0


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ragged_paged_write_quantized_pool_equal(cache_dtype, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    cfg, jc, tc = _pool_pair(cache_dtype)
    P = jc["k"].shape[0]
    tbl = np.array([[2, 5, P, P], [0, 3, 6, P], [P, P, P, P]], np.int32)
    # rows: slot 0 and 1 at assorted positions, a padding row, a position
    # behind a sentinel page (dropped), slot 2 (all sentinel, dropped)
    slots = np.array([0, 1, -1, 0, 1, 2, 0, -1], np.int32)
    pos = np.array([[0, 5, -1, 7, 13, 2, 9, 4]], np.int32)
    k = _values((1, 8, cfg.n_kv_heads, cfg.hd), jdt)
    v = _values((1, 8, cfg.n_kv_heads, cfg.hd), jdt)
    jout = jkv.ragged_paged_write(
        dict(jc, tbl=jnp.asarray(tbl), slots=jnp.asarray(slots)), k, v,
        jnp.asarray(pos))
    tkv.ragged_paged_write(dict(tc, tbl=_t(tbl), slots=_t(slots)),
                           _t(_np(k), tdt), _t(_np(v), tdt), _t(pos))
    _assert_pools_equal(jout, tc)
    assert tc["k_scale"].count_nonzero() > 0


def test_quantized_paged_read_equal():
    """The gather read of a quantized pool dequantizes to the reference's
    bf16 values, sentinel slots as exact zeros."""
    cfg, jc, tc = _pool_pair("int4")
    P = jc["k"].shape[0]
    tbl = np.array([[2, 5, P, P]], np.int32)
    pos = np.array([[0, 1, 4, 6]], np.int32)
    k = _values((1, 4, cfg.n_kv_heads, cfg.hd), jnp.bfloat16)
    jc = jkv.paged_write(dict(jc, tbl=jnp.asarray(tbl)), k, k,
                         jnp.asarray(pos))
    tc = tkv.paged_write(dict(tc, tbl=_t(tbl)), _t(_np(k), torch.bfloat16),
                         _t(_np(k), torch.bfloat16), _t(pos))
    last = np.array([6], np.int32)
    want = jkv.paged_read(jc, jnp.asarray(last))
    got = tkv.paged_read(tc, _t(last))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))


# ------------------------------------------- (c) plain decode, quantized ----
def _quant_pools(P, ps, KV, hd, cache_dtype):
    pools = []
    for _ in range(2):
        vals = jnp.asarray(RNG.standard_normal((P, ps, KV, hd)), jnp.float32)
        pools.append(j_quantize_kv(vals, int4=cache_dtype == "int4"))
    return pools


@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_quantized_matches_xla_twin(ps, cache_dtype, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    B, H, KV, hd, pps = 4, 4, 2, 16, 6
    P = B * pps + 3
    (kq, ks), (vq, vs) = _quant_pools(P, ps, KV, hd, cache_dtype)
    q = RNG.standard_normal((B, H, hd)).astype(np.float32)
    last = np.array([pps * ps - 1, -1, pps * ps // 2, 0], np.int32)
    tbl = np.full((B, pps), P, np.int32)
    pages = RNG.permutation(P).astype(np.int32)
    used = 0
    for b, lp in enumerate(last):
        n = (lp // ps + 1) if lp >= 0 else 0
        tbl[b, :n] = pages[used:used + n]
        used += n
    for window in (0, 5):
        want = jops.paged_decode_attention(
            jnp.asarray(q, jdt), kq, vq, jnp.asarray(tbl), jnp.asarray(last),
            ks, vs, window=window)
        got = ops.paged_decode_attention(
            _t(q, tdt), _t(kq), _t(vq), _t(tbl), _t(last), _t(ks), _t(vs),
            window=window)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
        assert not _np(got)[1].any()                  # inactive row -> zeros


# --------------------------------------------------- (d) plain ragged ----
@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("pp", [1, 2])
def test_ragged_plain_matches_xla_twin(ps, cache_dtype, pp):
    """The dims of the reference's ragged kernel test: two live table rows
    at assorted positions, a dead (all-sentinel) table row, and interior
    padding rows, which must be exact zeros."""
    rng = np.random.default_rng(ps * 7 + len(cache_dtype))
    P, KV, G, hd, pps, maxB = 8, 2, 2, 8, 3, 3
    H = KV * G
    if cache_dtype == "bfloat16":
        kq = jnp.asarray(rng.standard_normal((P, ps, KV, hd)), jnp.bfloat16)
        vq = jnp.asarray(rng.standard_normal((P, ps, KV, hd)), jnp.bfloat16)
        ks = vs = None
    else:
        int4 = cache_dtype == "int4"
        kq, ks = j_quantize_kv(jnp.asarray(
            rng.standard_normal((P, ps, KV, hd)), jnp.float32), int4)
        vq, vs = j_quantize_kv(jnp.asarray(
            rng.standard_normal((P, ps, KV, hd)), jnp.float32), int4)
    tbl = np.full((maxB, pps), P, np.int32)
    tbl[:2] = rng.permutation(P)[:2 * pps].reshape(2, pps)
    slot = np.asarray([0, 1, -1, 0, 1, -1], np.int32)
    max_pos = pps * ps - 1
    pos = np.asarray([0, max_pos, -1, max_pos // 2, max_pos // 3, -1],
                     np.int32)
    q = rng.standard_normal((6, H, hd)).astype(np.float32)
    want = ragged_attention_xla(
        jnp.asarray(q, jnp.bfloat16), kq, vq, jnp.asarray(tbl),
        jnp.asarray(slot), jnp.asarray(pos), ks, vs, pp=pp)
    if ks is None:
        pools = (_t(_np(kq), torch.bfloat16), _t(_np(vq), torch.bfloat16),
                 None, None)
    else:
        pools = (_t(kq), _t(vq), _t(ks), _t(vs))
    tk, tv, tks, tvs = pools
    got = ragged_decode_attention_plain(
        _t(q, torch.bfloat16), tk, tv, _t(tbl), _t(slot), _t(pos), tks, tvs,
        pp=pp)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)
    assert (_np(got)[slot < 0] == 0).all()


def test_ragged_dispatch_contract():
    """The ragged CUDA wrapper refuses CPU tensors (no fallback), and the
    CPU path through kernels.ops runs the plain version without counting a
    launch."""
    P, ps, KV, hd = 4, 4, 2, 64
    q = torch.zeros((3, 14, hd), dtype=torch.bfloat16)
    pool = torch.zeros((P, ps, KV, hd), dtype=torch.bfloat16)
    tbl = torch.full((2, 2), P, dtype=torch.int32)
    slot = torch.tensor([0, -1, 1], dtype=torch.int32)
    pos = torch.tensor([3, -1, 0], dtype=torch.int32)
    with pytest.raises(ValueError):
        ragged_decode_attention_cuda(q, pool, pool, tbl, slot, pos)
    before = ops.launch_counts()
    out = ops.ragged_paged_attention(q, pool, pool, tbl, slot, pos)
    assert out.shape == q.shape and not out.any()
    assert ops.launch_counts() == before
    assert "ragged_decode_attention" in before


# ---------------------------------------------------- (e) plan_tokens ----
def _plans(configs, kv_pages, sched):
    """The reference's scripted planner case, step by step."""
    sv = configs.ServingConfig(layout="paged", max_batch=4, page_size=4,
                               num_pages=32, max_ctx=32)
    s = sched.Scheduler(kv_pages.PagedKVCacheManager(sv), max_batch=4)
    for rid, L in enumerate((6, 10, 5)):
        s.submit(sched.Request(rid=rid, prompt=np.arange(L, dtype=np.int32),
                               max_new=4))
    s.admit(now=0.0)
    r0 = s.running[0]
    r0.n_cached, r0.decoding = 6, True
    r0.tokens.append(1)
    out = [s.plan_tokens(8)]
    s.running[1].n_cached = 7
    out.append(s.plan_tokens(8))
    r1, r2 = s.running[1], s.running[2]
    r1.n_cached, r1.decoding = 10, True
    r2.n_cached, r2.decoding = 5, True
    out.append(s.plan_tokens(2))
    return [[(r.rid, start, n) for r, start, n in plan] for plan in out]


def test_plan_tokens_identical():
    got = _plans(tconfigs, tkv, tsched)
    assert got == _plans(jconfigs, jkv, jsched)
    assert got == [[(0, 6, 1), (1, 0, 7)],
                   [(0, 6, 1), (1, 7, 3), (2, 0, 4)],
                   [(0, 6, 1), (1, 10, 1)]]


# --------------------------------------- (f) ragged engine vs JAX engine ----
F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32")
RAGGED_SV = dict(layout="paged", max_batch=4, page_size=4, num_pages=40,
                 max_ctx=48, step="ragged")
MIXED = dict(n_requests=6, prompt_lens=(5, 9, 14), gen_lens=(3, 5), seed=4)


@pytest.fixture(scope="module")
def jax_params():
    """The reference's 2-layer reduced qwen2-0.5b W4A4 serving weights and
    the port's copy of them, built once for the file."""
    jcfg = jconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    jrt = jconfigs.Runtime(**F32, cache_dtype="float32", remat="none",
                           loss_chunk=0)
    jparams = j_build_params(jcfg, jrt, seed=0)
    return jcfg, jparams, prepack_tree(params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.mark.parametrize("token_budget", [0, 6], ids=["auto", "budget6"])
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_ragged_engine_tokens_identical_to_jax_engine(jax_params,
                                                      token_budget,
                                                      cache_dtype):
    jcfg, jparams, tparams = jax_params
    cfg = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    sv = dict(RAGGED_SV, token_budget=token_budget)
    je = JEngine(jcfg, jconfigs.Runtime(**F32, cache_dtype=cache_dtype,
                                        remat="none", loss_chunk=0),
                 jconfigs.ServingConfig(**sv), params=jparams)
    jstats, jfin = j_run_trace(je, j_mixed_trace(vocab=jcfg.vocab, **MIXED))
    te = InferenceEngine(cfg, tconfigs.Runtime(**F32, cache_dtype=cache_dtype),
                         tconfigs.ServingConfig(**sv), params=tparams,
                         device="cpu")
    tstats, tfin = run_trace(te, mixed_trace(vocab=cfg.vocab, **MIXED))
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    assert all(r.outcome == "ok" for r in tfin)
    for key in ("steps", "prefill_tokens", "decode_tokens",
                "padding_tokens_wasted", "token_budget",
                "tokens_prefilled_saved"):
        assert tstats[key] == jstats[key], key
    assert tstats["step_mode"] == "ragged"


# ------------------------------------ (g) ragged == bucketed, port only ----
@pytest.mark.parametrize("spec", [
    ("bfloat16", 4, 0, "mixed"),       # auto budget
    ("bfloat16", 1, 6, "bursty"),      # 1-token pages, tight budget
    ("int8", 4, 6, "bursty"),
    ("int4", 4, 9, "mixed"),
], ids=lambda s: "-".join(map(str, s)))
def test_ragged_tokens_equal_bucketed(spec):
    """The reference's ragged-vs-bucketed property on a subset of its specs
    (float weights, bf16 activations).  Lossy pools prefill over the cache
    on the bucketed side, as the ragged step does by construction."""
    cache_dtype, ps, tb, kind = spec
    cfg = tconfigs.get_config("qwen2-0.5b").reduced()
    if kind == "mixed":
        trace = mixed_trace(6, [5, 9, 14], [3, 4], cfg.vocab, seed=1)
    else:
        trace = bursty_trace(6, 3, 3, [5, 9, 14], [3, 4], cfg.vocab, seed=1)
    (_, fin_b), (_, fin_r), eng = _both_steps(
        cfg, trace, cache_dtype, ps, tb, num_pages=96 if ps == 1 else 48)
    assert [r.tokens for r in fin_r] == [r.tokens for r in fin_b]
    assert eng.metrics.counter("ragged_budget_grows_total").value == 0


def _both_steps(cfg, trace, cache_dtype, ps, tb, num_pages):
    """Run `trace` through a bucketed and a ragged engine on one set of
    float weights; returns both (stats, finished) and the ragged engine."""
    rt = tconfigs.Runtime(quant_backend="float", cache_dtype=cache_dtype,
                          prefill_over_cache=cache_dtype != "bfloat16")
    params, out = None, []
    for step in ("bucketed", "ragged"):
        eng = InferenceEngine(
            cfg, rt, tconfigs.ServingConfig(
                layout="paged", max_batch=4, page_size=ps,
                num_pages=num_pages, max_ctx=64, step=step,
                token_budget=tb if step == "ragged" else 0),
            params=params, device="cpu")
        params = eng.params
        out.append(run_trace(eng, trace))
    return out[0], out[1], eng


def test_ragged_budget_grows_and_tokens_still_match():
    """An explicit budget below max_batch doubles the step the decode set
    (plus one prefill-chunk row) outgrows it, and the tokens still equal
    the bucketed step's (the reference's budget-growth case)."""
    cfg = tconfigs.get_config("qwen2-0.5b").reduced()
    trace = mixed_trace(5, [3, 4], [6], cfg.vocab, seed=1)
    (_, fin_b), (s_r, fin_r), eng = _both_steps(cfg, trace, "bfloat16", 4,
                                                2, num_pages=48)
    assert [r.tokens for r in fin_r] == [r.tokens for r in fin_b]
    assert eng.metrics.counter("ragged_budget_grows_total").value >= 1
    assert s_r["token_budget"] >= 4


# ------------------------------------------------------------ (h) CLI ----
def test_serve_cli_ragged_int8_mixed_report(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-0.5b", "--reduced", "--layers", "1",
        "--device", "cpu", "--step", "ragged", "--cache-dtype", "int8",
        "--scenario", "mixed", "--requests", "4", "--prompt-lens", "8,12",
        "--gen-lens", "3", "--max-batch", "2", "--num-pages", "16",
        "--max-ctx", "64"])
    serve.main()
    report = json.loads(capsys.readouterr().out)
    stats = report["paged"]
    assert report["step"] == "ragged" and report["cache_dtype"] == "int8"
    assert report["scenario"] == "mixed" and report["device"] == "cpu"
    assert stats["step_mode"] == "ragged"
    assert stats["token_budget"] == 64          # prompt_bucket(2 + 2 * 16)
    assert stats["requests_finished"] == 4 and stats["outcomes"] == {"ok": 4}
    assert stats["decode_tokens"] == 4 * 2      # 1st token ends the prefill
    assert stats["prefill_tokens"] == 8 + 12 + 8 + 12
    assert stats["padding_tokens_wasted"] > 0
    assert set(report["kernel_launches"].values()) == {0}
