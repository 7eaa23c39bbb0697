"""Port parity for the contiguous (static-slot) KV layout and the
``--layout compare`` harness.

  * The ring cache ops (`init_attn_cache`, `_cache_write`, `_cache_read`)
    against the JAX package on seeded numpy inputs, for bf16, f32, int8 and
    int4 caches: the ring wrapping under a window, negative positions to
    the drop slot, and the prefill's resume rule (positions the row has
    already cached are dropped).  Integer and copied data, so exact.
  * The port engine's paged and contiguous runs of one trace emit the same
    tokens (the JAX package's ``test_engine_paged_vs_contiguous_bit_
    identical``) in float32 W4A4, bf16 W4A4 and bf16 with float weights,
    and the contiguous engine emits the JAX contiguous engine's tokens on
    the same weights (``convert.params_from_jax``) in float32 W4A4 and in
    bf16 with float weights.  bf16 W4A4 tokens are not compared across the
    two packages: a one-step bf16 difference that crosses an int4 rounding
    boundary moves a whole row (ROADMAP Queue 3 item 7), and at this size
    the first tokens already differ.

The JAX engines run once per file, in module-scoped fixtures."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import Runtime as JRuntime  # noqa: E402
from repro.configs import ServingConfig as JServingConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import quant_plan as jplan  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import kv_pages as jkv  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.configs import Runtime, ServingConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant_plan as tplan  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import kv_pages as tkv  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ARCH = "qwen2-0.5b"
CACHE_DTYPES = ("bfloat16", "float32", "int8", "int4")
RNG = np.random.default_rng(13)


def _np(t):
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _jnp_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_caches_equal(tc, jc):
    assert sorted(tc) == sorted(jc)
    for key in jc:
        want = _jnp_np(jc[key])
        got = _np(tc[key])
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def _kv(shape, dtype):
    """K/V values of `dtype` (bf16 for a bf16 cache, as the model writes
    them), identical in both packages."""
    a = RNG.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(_jnp_np(j).copy())
    return j, t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _configs(window=0):
    over = dict(local_window=window) if window else {}
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), **over)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **over)
    return jcfg, cfg


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
@pytest.mark.parametrize("window", [0, 6])
def test_init_write_read_equal_the_jax_package(cache_dtype, window):
    """A prefill of 10 positions (row 1 left-padded by 3: positions -1 go
    to the drop slot), then four decode writes; with a window of 6 the ring
    has 6 slots and wraps.  Every leaf and both reads equal the JAX
    package's after every write."""
    jcfg, cfg = _configs(window)
    jrt = JRuntime(cache_dtype=cache_dtype)
    rt = Runtime(cache_dtype=cache_dtype)
    B, seq = 2, 16
    jc = jattn.init_attn_cache(jcfg, jrt, B, seq)
    tc = tattn.init_attn_cache(cfg, rt, B, seq, "cpu")
    _assert_caches_equal(tc, jc)
    assert tc["k"].shape[1] == (min(seq, window) if window else seq)
    pos = np.stack([np.arange(10), np.arange(10) - 3]).astype(np.int32)
    pos = np.where(pos >= 0, pos, -1)
    writes = [pos] + [np.asarray([[10 + i], [7 + i]], np.int32)
                      for i in range(4)]
    for p in writes:
        shape = (B, p.shape[1], cfg.n_kv_heads, cfg.hd)
        jk, tk = _kv(shape, cache_dtype)
        jv, tv = _kv(shape, cache_dtype)
        jc = jattn._cache_write(jc, jk, jv, jnp.asarray(p), aligned=False)
        tc = tattn._cache_write(tc, tk, tv, torch.from_numpy(p))
        _assert_caches_equal(tc, jc)
        for got, want in zip(tattn._cache_read(tc), jattn._cache_read(jc)):
            np.testing.assert_array_equal(_np(got), _jnp_np(want))
    # the drop slot took nothing: row 1's left padding left no position
    assert set(np.unique(_np(tc["kpos"])[1])) <= set(range(0, 11)) | {-1}


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefill_resume_writes_only_the_uncached_suffix(cache_dtype):
    """A prefill over a row that has already cached 6 positions (a resume
    re-presenting them) writes only positions >= pos, through
    `apply_attention` on the same weights in both packages: ``pos`` and
    ``kpos`` exact, the skipped slots exactly 0, K/V to float32 rounding
    (int8: the same codes, or one code apart where a float32 rounding
    difference crosses a rounding boundary)."""
    jcfg, cfg = _configs()
    kw = dict(cache_dtype=cache_dtype, compute_dtype="float32",
              quant_backend="float", attn_impl="chunked")
    jrt = JRuntime(**kw, aligned_decode=False)
    rt = Runtime(**kw)
    jp = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(2),
                                                       jcfg))
    tp = params_from_jax(jp, "cpu")
    B, S = 2, 10
    x = RNG.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jc = jattn.init_attn_cache(jcfg, jrt, B, 16)
    tc = tattn.init_attn_cache(cfg, rt, B, 16, "cpu")
    jc = dict(jc, pos=jnp.asarray([6, 0], jnp.int32))
    tc = dict(tc, pos=torch.tensor([6, 0], dtype=torch.int32))
    jy, jnc = jattn.apply_attention(jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(x), jcfg, jrt,
                                    jnp.asarray(pos), jc, update_cache=True)
    ty, tnc = tattn.apply_attention(tp, torch.from_numpy(x), cfg, rt,
                                    torch.from_numpy(pos), tc,
                                    update_cache=True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(tnc["pos"]), np.asarray(jnc["pos"]))
    np.testing.assert_array_equal(_np(tnc["kpos"]), np.asarray(jnc["kpos"]))
    kpos = _np(tnc["kpos"])
    assert (kpos[0, :6] == -1).all() and (kpos[0, 6:10] == range(6, 10)).all()
    assert (kpos[1, :10] == range(10)).all()
    for key in ("k", "v"):
        got = _np(tnc[key]).astype(np.float32)
        want = _jnp_np(jnc[key]).astype(np.float32)
        if cache_dtype == "int8":
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (got[0, :6] == 0).all()


def test_decode_attends_the_ring_as_the_jax_package():
    """The contiguous decode branch (write, then exact attention over the
    cache) on a cache filled by a prefill, f32, float weights."""
    jcfg, cfg = _configs(window=6)
    kw = dict(cache_dtype="float32", compute_dtype="float32",
              quant_backend="float", attn_impl="chunked")
    jrt, rt = JRuntime(**kw, aligned_decode=False), Runtime(**kw)
    jp = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(5),
                                                       jcfg))
    tp = params_from_jax(jp, "cpu")
    jc = jattn.init_attn_cache(jcfg, jrt, 2, 16)
    tc = tattn.init_attn_cache(cfg, rt, 2, 16, "cpu")
    for step in range(9):
        p = np.asarray([[step], [step - 2]], np.int32)
        p = np.where(p >= 0, p, -1)
        x = RNG.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jattn.apply_attention(jax.tree.map(jnp.asarray, jp),
                                       jnp.asarray(x), jcfg, jrt,
                                       jnp.asarray(p), jc, update_cache=True)
        ty, tc = tattn.apply_attention(tp, torch.from_numpy(x), cfg, rt,
                                       torch.from_numpy(p), tc,
                                       update_cache=True)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(tc["kpos"]), np.asarray(jc["kpos"]))


def test_rows_gather_scatter():
    """`gather_rows` / `scatter_rows` equal the JAX package's on a model
    cache tree (`init_caches`, equal to the JAX package's); rows not named
    are untouched."""
    jcfg = j_get_config(ARCH).reduced(n_layers=2)
    cfg = get_config(ARCH).reduced(n_layers=2)
    rt, jrt = Runtime(cache_dtype="int8"), JRuntime(cache_dtype="int8")
    jc = jt.init_caches(jcfg, jrt, batch=4, seq=8)
    tc = tt.init_caches(cfg, rt, batch=4, seq=8, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jc)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), tc))
    vals = jax.tree.map(lambda a: RNG.integers(-5, 5, a.shape).astype(
        np.asarray(a).dtype), jax.tree.map(np.asarray, jc))
    jc = jax.tree.map(jnp.asarray, vals)
    tc = jax.tree.map(lambda a: torch.from_numpy(a.copy()), vals)
    rows = [3, 1]
    jsub = jkv.gather_rows(jc, rows)
    tsub = tkv.gather_rows(tc, torch.tensor(rows))
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jsub),
                 jax.tree.map(lambda t: t.numpy(), tsub))
    fresh = tt.init_caches(cfg, rt, batch=2, seq=8, device="cpu")
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(lambda t: t.numpy(), fresh),
                 jax.tree.map(np.asarray,
                              jt.init_caches(jcfg, jrt, batch=2, seq=8)))
    jout = jkv.scatter_rows(jc, jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: t.numpy(), fresh)), rows)
    tout = tkv.scatter_rows(tc, fresh, torch.tensor(rows))
    assert tout is tc                                   # in place
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jout),
                 jax.tree.map(lambda t: t.numpy(), tout))
    np.testing.assert_array_equal(tout["rep"]["u0"]["attn"]["k"][:, 0]
                                  .numpy(),
                                  vals["rep"]["u0"]["attn"]["k"][:, 0])


# ----------------------------------------------------------- the engine ----
ENGINE_SV = dict(max_batch=2, page_size=8, num_pages=32, max_ctx=32)
TRACE = dict(n_requests=4, rate_per_step=1.0, prompt_lens=(8,),
             gen_lens=(4,), seed=5)
#: name -> Runtime keywords
ENGINE_RUNS = {
    "float32 W4A4": dict(quant_backend="w4a4_packed", compute_dtype="float32",
                         cache_dtype="float32", attn_impl="chunked"),
    "bf16 W4A4": dict(quant_backend="w4a4_packed", attn_impl="chunked"),
    "bf16 float": dict(quant_plan="*=float", attn_impl="chunked"),
}
#: the runs whose tokens are held to the JAX engine's
JAX_HELD = ("float32 W4A4", "bf16 float")


@pytest.fixture(scope="module")
def jax_contiguous_runs():
    """The JAX contiguous engine's tokens under each run, on one set of
    masters (reduced qwen2-0.5b, 2 layers)."""
    jcfg = j_get_config(ARCH).reduced(n_layers=2)
    masters = jt.init_model(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name in JAX_HELD:
        jrt = JRuntime(**ENGINE_RUNS[name], remat="none", loss_chunk=0)
        eng = JEngine(jcfg, jrt, JServingConfig(layout="contiguous",
                                                **ENGINE_SV),
                      params=jplan.pack_for_serving(masters, jcfg, jrt))
        _, fin = j_run_trace(eng, j_poisson_trace(vocab=jcfg.vocab, **TRACE))
        out[name] = [r.tokens for r in fin]
    return jax.tree.map(np.asarray, masters), out


@pytest.mark.parametrize("name", sorted(ENGINE_RUNS))
def test_engine_layouts_equal_each_other_and_the_jax_engine(
        jax_contiguous_runs, name):
    masters, runs = jax_contiguous_runs
    cfg = get_config(ARCH).reduced(n_layers=2)
    rt = Runtime(**ENGINE_RUNS[name])
    params = tplan.pack_for_serving(params_from_jax(masters, "cpu"), cfg, rt)
    tokens = {}
    for layout in ("paged", "contiguous"):
        eng = InferenceEngine(cfg, rt, ServingConfig(layout=layout,
                                                     **ENGINE_SV),
                              params=params, device="cpu")
        eng.warmup(TRACE["prompt_lens"])
        stats, fin = run_trace(eng, poisson_trace(vocab=cfg.vocab, **TRACE))
        assert all(r.outcome == "ok" and len(r.tokens) == 4 for r in fin)
        assert stats["layout"] == layout
        assert stats["recompiles"]["steady_state"] == 0
        tokens[layout] = [r.tokens for r in fin]
    assert tokens["contiguous"] == tokens["paged"]
    if name in JAX_HELD:
        assert tokens["contiguous"] == runs[name]


def test_contiguous_snapshot_restore_continues_bit_identically():
    """Stop a contiguous engine mid-run, restore it into a new engine, and
    every request emits the uninterrupted run's tokens (the rows are
    restored verbatim, nothing is recomputed)."""
    cfg = get_config(ARCH).reduced(n_layers=2)
    rt = Runtime(quant_backend="float", compute_dtype="float32",
                 cache_dtype="float32", attn_impl="chunked")
    sv = ServingConfig(layout="contiguous", **ENGINE_SV)
    trace = poisson_trace(vocab=cfg.vocab, **dict(TRACE, gen_lens=(7,)))

    def start(params=None):
        eng = InferenceEngine(cfg, rt, sv, params=params, seed=1,
                              device="cpu")
        for item in trace:
            eng.submit(item.prompt, item.max_new)
        return eng

    ref = start()
    ref.run_until_idle()
    want = {r.rid: r.tokens for r in ref.collect()}
    eng = start(ref.params)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    assert snap["tbl"] is None
    new = InferenceEngine.restore(snap, params=ref.params)
    new.run_until_idle()
    got = {r.rid: r.tokens for r in eng.collect() + new.collect()}
    assert got == want and len(got) == len(trace)


def test_contiguous_refuses_the_ragged_step():
    with pytest.raises(AssertionError, match="paged only"):
        ServingConfig(layout="contiguous", step="ragged")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_contiguous_steps_touch_only_their_rows(arch):
    """The contiguous serving steps on the engine's whole cache tree:
    prefill resets its slot's row and fills it as a prefill into a fresh
    row does; decode steps the rows it names; a row whose position is -1
    (padding, warm-up) writes back what it read; rows not named are
    untouched."""
    cfg = get_config(arch).reduced(n_layers=2)
    rt = Runtime(quant_backend="float", compute_dtype="float32",
                 cache_dtype="float32", attn_impl="chunked")
    prefill, tail, decode = tsteps.make_serving_steps(cfg, rt, paged=False,
                                                      max_ctx=16)
    assert tail is None
    params = tt.init_model(torch.Generator().manual_seed(0), cfg)
    caches = tt.init_caches(cfg, rt, batch=4, seq=16, device="cpu")

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif v.dtype.is_floating_point:
                v.copy_(torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(v.numel())))
    fill(caches)
    for rows in (caches["rep"]["u0"].values()):
        if "kpos" in rows:
            rows["kpos"][:] = torch.arange(16, dtype=torch.int32)
            rows["pos"][:] = 16

    def row(tree, r):
        return tkv.gather_rows(tree, torch.tensor([r]))

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(
            jax.tree.leaves(jax.tree.map(np.asarray, a)),
            jax.tree.leaves(jax.tree.map(np.asarray, b))))

    before = {r: row(caches, r) for r in range(4)}
    toks = torch.tensor([[3, 5, 7, 9, 11]], dtype=torch.int32)
    pad = torch.full((1, 5), -1, dtype=torch.int32)
    prefill(params, toks, caches, pad, None, torch.tensor([3]))
    assert all(same(row(caches, r), before[r]) for r in range(4))
    pos = torch.arange(5, dtype=torch.int32)[None]
    tok, _ = prefill(params, toks, caches, pos, None, torch.tensor([3]))
    want_logits, want_row = tt.prefill(
        params, toks, cfg, rt, tt.init_caches(cfg, rt, 1, 16, "cpu"), pos)
    assert tok.tolist() == [int(want_logits[0, :cfg.vocab].argmax())]
    assert same(row(caches, 3), want_row)
    assert all(same(row(caches, r), before[r]) for r in range(3))
    before = {r: row(caches, r) for r in range(4)}
    feed = torch.tensor([[4], [6]], dtype=torch.int32)
    fpos = torch.tensor([[5], [-1]], dtype=torch.int32)
    want_logits, want = tt.decode_step(
        params, feed, cfg, rt, tkv.gather_rows(caches, torch.tensor([3, 1])),
        fpos)
    tok, _ = decode(params, feed, caches, fpos, None, torch.tensor([3, 1]))
    assert tok.tolist() == want_logits[:, :cfg.vocab].argmax(-1).tolist()
    assert same(row(caches, 3), row(want, 0))
    assert not same(row(caches, 3), before[3])
    assert all(same(row(caches, r), before[r]) for r in range(3))
