"""Port parity for the serving stack: the host-side page manager and
scheduler make the JAX package's decisions on a scripted trace, the paged
pool drops and zero-reads what the reference drops and zero-reads, and the
whole engine emits the reference's greedy tokens on a Poisson trace."""

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
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine, build_params  # noqa: E402


# ------------------------------------------------ scheduler + page manager --
def _scripted_trace(configs, kv_pages, sched):
    """Admit, share a cached prefix, grow until the pool runs dry, preempt,
    finish, resume over warm pages.  Returns the state after every step."""
    sv = configs.ServingConfig(layout="paged", max_batch=2, page_size=4,
                               num_pages=6, max_ctx=24, prefix_cache=True)
    kv = kv_pages.PagedKVCacheManager(sv)
    s = sched.Scheduler(kv, max_batch=2)
    base = np.arange(100, 108, dtype=np.int32)
    a = sched.Request(rid=0, prompt=np.concatenate([base, [1]]).astype(
        np.int32), max_new=8)
    b = sched.Request(rid=1, prompt=np.concatenate([base, [2, 3]]).astype(
        np.int32), max_new=8)
    states = []

    def snap(tag, extra=None):
        states.append((tag, extra,
                       [(r.rid, r.slot, r.n_cached) for r in s.batch()],
                       [r.rid for r in s.waiting],
                       {k: list(v) for k, v in kv.pages.items()},
                       dict(kv.refcount), list(kv.blank), list(kv.warm),
                       dict(kv.index), s.n_preemptions, kv.n_hit_tokens,
                       kv.n_evictions))
        s.check_invariants()
        kv.check_invariants()

    s.submit(a)
    snap("admit a", [r.rid for r in s.admit(now=0.0)])
    a.n_cached = len(a.prompt)                      # a's prefill
    kv.register_upto(0, a.prefix, a.n_cached)
    a.tokens.append(5)
    s.submit(b)
    snap("admit b (prefix hit)", [(r.rid, r.n_cached) for r in s.admit(1.0)])
    b.n_cached = len(b.prompt)
    kv.register_upto(1, b.prefix, b.n_cached)
    b.tokens.append(6)
    for step in range(8):                           # decode until dry
        snap(f"decode {step}", [r.rid for r in s.ensure_decode()])
        for r in s.batch():
            r.n_cached += 1
            r.tokens.append(7 + step)
            kv.register_upto(r.rid, r.prefix, r.n_cached)
    s.finish(a, now=2.0)
    snap("finish a")
    snap("resume b", [(r.rid, r.n_cached) for r in s.admit(now=3.0)])
    return states


def test_scheduler_and_page_manager_decisions_identical():
    want = _scripted_trace(jconfigs, jkv, jsched)
    got = _scripted_trace(tconfigs, tkv, tsched)
    assert got == want
    tags = {t[0]: t for t in got}
    assert tags["admit b (prefix hit)"][1] == [(1, 8)]       # 2 pages shared
    assert got[-1][9] >= 1                                   # b was preempted
    assert got[-1][1] and got[-1][1][0][1] > 0               # resumed on a hit


# ----------------------------------------------------------- device pool --
def test_paged_write_drops_and_sentinel_reads_zero():
    """Negative positions and sentinel table entries write nothing; sentinel
    slots read as exact zeros even when the clamped page holds data; the
    read equals the JAX package's."""
    cfg = tconfigs.get_config("qwen2-0.5b").reduced()
    KV, hd = cfg.n_kv_heads, cfg.hd
    P, ps = 6, 4
    sv = dict(layout="paged", max_batch=1, page_size=ps, num_pages=P,
              max_ctx=16)
    rt = tconfigs.Runtime(cache_dtype="float32")
    caches = tkv.init_paged_caches(cfg, rt, tconfigs.ServingConfig(**sv),
                                   device="cpu")
    pool_k = caches["rep"]["u0"]["attn"]["k"][0]
    pool_v = caches["rep"]["u0"]["attn"]["v"][0]
    pool_k[P - 1] = 9.0                      # poison the clamp target
    tbl = torch.tensor([[2, 5, P, P]], dtype=torch.int32)
    cache = {"tbl": tbl, "k": pool_k, "v": pool_v}
    pos = torch.tensor([[-2, -1, 5, 9]], dtype=torch.int32)
    vals = torch.arange(1, 5, dtype=torch.float32)[None, :, None, None] \
        * torch.ones((1, 4, KV, hd))
    tkv.paged_write(cache, vals, -vals, pos)
    flat_k = pool_k.reshape(P * ps, KV, hd)
    assert (flat_k[5 * ps + 1] == 3.0).all()            # position 5 landed
    written = torch.zeros(P * ps, dtype=torch.bool)
    written[5 * ps + 1] = True
    written[(P - 1) * ps:] = True                       # the poison
    assert (flat_k[~written] == 0).all()                # nothing else moved
    k, v, kpos = tkv.paged_read(cache, torch.tensor([9], dtype=torch.int32))
    assert (k[0, 8:] == 0).all() and (v[0, 8:] == 0).all()
    assert kpos[0].tolist() == list(range(10)) + [-1] * 6

    jsv = jconfigs.ServingConfig(**sv)
    jc = dict(jkv.init_paged_attn_cache(cfg, jconfigs.Runtime(
        cache_dtype="float32"), 1, jsv), tbl=jnp.asarray(tbl.numpy()))
    jc["k"] = jnp.asarray(pool_k.numpy())
    jc["v"] = jnp.asarray(pool_v.numpy())
    jk, jv, jpos = jkv.paged_read(jc, jnp.asarray([9], jnp.int32))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(kpos.numpy(), np.asarray(jpos))


# ---------------------------------------------------------------- engine --
ENGINE_SV = dict(layout="paged", max_batch=4, page_size=4, num_pages=14,
                 max_ctx=48, prefix_cache=True)
TRACE = dict(n_requests=8, rate_per_step=0.7, prompt_lens=(5, 12, 20),
             gen_lens=(4, 9), seed=3)


def test_engine_greedy_tokens_identical_to_jax_engine():
    """float32 activations and pool, chunked attention, W4A4 weights: the
    pool is small enough that requests are preempted and resume over
    prefix-cache hits, and every greedy token must equal the reference's."""
    kw = dict(attn_impl="chunked", quant_backend="w4a4_packed",
              cache_dtype="float32", compute_dtype="float32")
    jcfg = jconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    cfg = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    jrt = jconfigs.Runtime(**kw, remat="none", loss_chunk=0)
    jparams = j_build_params(jcfg, jrt, seed=0)
    je = JEngine(jcfg, jrt, jconfigs.ServingConfig(**ENGINE_SV),
                 params=jparams)
    jstats, jfin = j_run_trace(je, j_poisson_trace(vocab=jcfg.vocab,
                                                   **TRACE))
    te = InferenceEngine(cfg, tconfigs.Runtime(**kw),
                         tconfigs.ServingConfig(**ENGINE_SV),
                         params=prepack_tree(params_from_jax(
                             jax.tree.map(np.asarray, jparams), "cpu")),
                         device="cpu")
    tstats, tfin = run_trace(te, poisson_trace(vocab=cfg.vocab, **TRACE))
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    assert all(r.outcome == "ok" for r in tfin)
    for key in ("requests_preempted", "tokens_prefilled_saved",
                "prefill_tokens", "decode_tokens", "steps"):
        assert tstats[key] == jstats[key], key
    assert tstats["requests_preempted"] > 0
    assert tstats["tokens_prefilled_saved"] > 0


def test_engine_runs_on_cuda_unless_cpu_is_asked_for():
    cfg = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=1)
    rt = tconfigs.Runtime(quant_backend="w4a4_packed")
    sv = tconfigs.ServingConfig(max_batch=1, num_pages=8, max_ctx=32)
    if torch.cuda.is_available():
        engine = InferenceEngine(cfg, rt, sv)
        assert engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, rt, sv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_params(cfg, rt)
    engine = InferenceEngine(cfg, rt, sv, device="cpu")
    assert engine.device.type == "cpu"
    assert all(t.device.type == "cpu"
               for t in engine.caches["rep"]["u0"]["attn"].values())


def test_serve_cli_report_on_cpu():
    """The port's serve entry point at reduced width on the CPU: every
    request retires and the report carries the device and the launches
    (none: CPU tensors run the plain versions)."""
    from repro_torch.launch.serve import serve

    report = serve("qwen2-0.5b", reduced=True, layers=1, max_batch=2,
                   num_pages=16, max_ctx=64, requests=3, prompt_lens=(8, 12),
                   gen_lens=(3,), device="cpu")
    assert report["device"] == "cpu" and report["n_layers"] == 1
    assert report["paged"]["requests_finished"] == 3
    assert report["paged"]["decode_tokens"] == 3 * 2   # 1st token at prefill
    assert set(report["kernel_launches"].values()) == {0}
    assert report["tokens_per_s"] > 0
    assert report["recompiles_steady_state"] == 0
    assert report["paged"]["recompiles"]["total"] > 0
