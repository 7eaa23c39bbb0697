"""The request lifecycle, port against the JAX package: cancel, deadlines,
earliest-deadline-first admission, load shedding, injected step faults,
the step watchdog, the stuck-engine error and snapshot/restore.

(a) The host-side scheduler and page manager make the JAX package's
    decisions over one scripted event sequence (EDF admission, cancel of a
    queued and of a running request, the deadline sweep over the queue
    and the running set, shedding, an injected allocator failure, a
    state/load_state round trip).
(b) One engine session (2 layers of the reduced qwen2-0.5b, W4A4 in
    float32, step clock) through both engines: the same outcomes, tokens,
    counters and stats() outcome counts.
(c) The fault-tolerance runtime and the port engine's watchdog, injected
    faults and `EngineStuckError`.
(d) Snapshot/restore: a restored engine continues with the uninterrupted
    run's tokens (which are the JAX engine's), frees the engine it
    replaced, and a restore into an engine already warmed up under the
    `CapturedStep` replay double of ``tests/test_torch_graphs.py`` keeps
    the pools' and the table pool's storage and replays its graphs.
"""

import dataclasses
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.distributed.fault_tolerance as jft  # noqa: E402
import repro.serving.kv_pages as jkv  # noqa: E402
import repro.serving.scheduler as jsched  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.distributed.fault_tolerance as tft  # noqa: E402
import repro_torch.serving.kv_pages as tkv  # noqa: E402
import repro_torch.serving.scheduler as tsched  # noqa: E402
from repro.serving.chaos import _StepClock as JClock  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.observability import Telemetry  # noqa: E402
from repro_torch.serving.chaos import InjectedFault, _StepClock  # noqa: E402
from repro_torch.serving.engine import (EngineStuckError,  # noqa: E402
                                        InferenceEngine, _pool_leaves)
from test_torch_graphs import ReplayDouble, record  # noqa: E402


# ------------------------------------------- (a) scheduler + page manager --
def _scripted(configs, kv_pages, sched):
    """EDF admission, an injected allocator failure, cancel queued and
    running, the deadline sweep, shedding, a state round trip.  Returns
    the observable state after every event."""
    sv = configs.ServingConfig(layout="paged", max_batch=2, page_size=4,
                               num_pages=10, max_ctx=24, prefix_cache=True,
                               max_queue=3)
    kv = kv_pages.PagedKVCacheManager(sv)
    s = sched.Scheduler(kv, max_batch=2, max_queue=3)
    base = np.arange(40, 48, dtype=np.int32)

    def req(rid, tail, deadline=None):
        return sched.Request(rid=rid, prompt=np.concatenate(
            [base, np.asarray(tail, np.int32)]), max_new=6,
            deadline=deadline)

    states = []

    def snap(tag, extra=None):
        states.append((tag, extra,
                       [(r.rid, r.slot, r.n_cached) for r in s.batch()],
                       [(r.rid, r.state, r.outcome, r.t_finish)
                        for r in s.waiting],
                       {k: list(v) for k, v in kv.pages.items()},
                       dict(kv.refcount), list(kv.blank), list(kv.warm),
                       s.n_preemptions, kv.n_lookups, kv.n_hit_tokens,
                       kv.fail_next_admits, list(s._free_slots)))
        s.check_invariants()
        kv.check_invariants()

    reqs = [req(0, [1]), req(1, [2, 3], deadline=9.0), req(2, [4]),
            req(3, [5], deadline=4.0)]
    for r in reqs[:3]:
        s.submit(r)
    try:
        s.submit(reqs[3])
        shed = False
    except sched.ShedError:
        shed = True
    snap("submit + shed", shed)
    kv.fail_next_admits = 1
    snap("injected failure", [r.rid for r in s.admit(now=0.0)])
    snap("EDF admit", [r.rid for r in s.admit(now=1.0)])
    for r in s.batch():                    # prefill and one decode token
        r.n_cached = len(r.prompt)
        kv.register_upto(r.rid, r.prefix, r.n_cached)
        r.tokens.append(7)
    s.submit(reqs[3])                      # the queue has room again
    snap("cancel queued", getattr(s.cancel(2, now=2.0), "rid", None))
    snap("cancel running", getattr(s.cancel(0, now=2.5), "rid", None))
    snap("cancel unknown", s.cancel(99, now=2.5))
    snap("admit after cancels", [r.rid for r in s.admit(now=3.0)])
    snap("expire", [(r.rid, r.outcome) for r in s.expire(now=9.0)])
    st = kv.state()
    kv2 = kv_pages.PagedKVCacheManager(sv)
    kv2.load_state(st)
    snap("state round trip", kv2.state() == st)
    for rid in list(s.running):
        s.finish(s.running[rid], now=10.0)
    snap("drained", kv.in_use)
    return states


def test_scheduler_lifecycle_decisions_equal_jax_package():
    want = _scripted(jconfigs, jkv, jsched)
    got = _scripted(tconfigs, tkv, tsched)
    assert got == want
    tags = {tag: extra for tag, extra, *_ in got}
    assert tags["submit + shed"] is True
    assert tags["injected failure"] == []          # nothing admitted
    assert tags["EDF admit"] == [1, 0]              # the deadline first
    assert tags["cancel queued"] == 2 and tags["cancel running"] == 0
    assert tags["admit after cancels"] == [3]
    assert tags["expire"] == [(1, "timeout"), (3, "timeout")]
    assert tags["state round trip"] is True and tags["drained"] == 0


def test_request_fields_equal_jax_package():
    """snapshot() copies a Request field by field: the port's dataclass has
    the JAX package's fields in its order."""
    assert ([f.name for f in dataclasses.fields(tsched.Request)]
            == [f.name for f in dataclasses.fields(jsched.Request)])
    assert tsched.OUTCOMES == jsched.OUTCOMES


# --------------------------------------------------- (b) engine session --
F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32", cache_dtype="float32")
SV = dict(layout="paged", max_batch=2, page_size=4, num_pages=24, max_ctx=32,
          max_queue=3)


@pytest.fixture(scope="module")
def setup():
    """The same W4A4 weights for both packages and one warmed JAX engine on
    a step clock, built once for the file."""
    jcfg = jconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    jrt = jconfigs.Runtime(**F32, remat="none", loss_chunk=0)
    jparams = j_build_params(jcfg, jrt, seed=0)
    tparams = prepack_tree(params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    jclock = JClock()
    jeng = JEngine(jcfg, jrt, jconfigs.ServingConfig(**SV), params=jparams,
                   clock=jclock)
    jeng.warmup([8])
    return jeng, jclock, tparams


def _port_engine(tparams, clock=None, telemetry=None, **sv):
    cfg = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    return InferenceEngine(
        cfg, tconfigs.Runtime(**F32),
        tconfigs.ServingConfig(**dict(SV, **sv)), params=tparams,
        device="cpu", telemetry=telemetry,
        **({"clock": clock} if clock is not None else {}))


def _prompt(shift, L=7):
    return ((np.arange(L, dtype=np.int32) * 5 + shift) % 256).astype(
        np.int32)


def _session(eng, clock, shed_error):
    """EDF admission, a shed, a cancel of a queued and of a decoding
    request, a timeout in the queue and one mid-decode; returns what each
    request retired with."""
    out, events = {}, []
    t0 = len(eng._all)                      # rids continue on a reused engine

    def step(t):
        clock.t = float(t)
        eng.step()
        for r in eng.collect():
            out[r.rid - t0] = (r.outcome, list(r.tokens))

    clock.t = 0.0
    a = eng.submit(_prompt(1), 6)
    b = eng.submit(_prompt(2), 20, deadline_s=5.0)   # times out mid-decode
    c = eng.submit(_prompt(3), 6, deadline_s=50.0)
    try:
        eng.submit(_prompt(4), 6)
    except shed_error:
        events.append("shed")
    for r in eng.collect():
        out[r.rid - t0] = (r.outcome, list(r.tokens))
    step(0)                                 # EDF: b and c run, a waits
    events.append(sorted(r - t0 for r in eng.scheduler.running))
    events.append(eng.cancel(a))            # queued
    step(1)
    events.append(eng.cancel(c))            # decoding
    events.append(eng.cancel(c))            # already retired
    events.append(eng.cancel(10_000))       # unknown
    eng.submit(_prompt(5), 4, arrival=50.0, deadline_s=1.5)  # expires queued
    g = eng.submit(_prompt(6), 4)
    t = 2
    while not eng.scheduler.idle:
        assert t < 60
        step(t)
        t += 1
    events.append(g - t0)
    return out, events, eng.stats()["outcomes"]


def test_engine_session_equals_jax_engine(setup):
    jeng, jclock, tparams = setup
    j_before = dict(jeng.metrics.snapshot()["counters"])
    want = _session(jeng, jclock, jsched.ShedError)
    j_after = jeng.metrics.snapshot()["counters"]
    clock = _StepClock()
    eng = _port_engine(tparams, clock=clock)
    eng.warmup([8])
    got = _session(eng, clock, tsched.ShedError)
    assert got[:2] == want[:2]
    out, events, outcomes = got
    assert events == ["shed", [1, 2], True, True, False, False, 5]
    assert {k: v[0] for k, v in out.items()} == {
        0: "cancelled", 1: "timeout", 2: "cancelled", 3: "shed",
        4: "timeout", 5: "ok"}
    assert 0 < len(out[1][1]) < 20 and len(out[5][1]) == 4
    assert outcomes == {"ok": 1, "cancelled": 2, "timeout": 2, "shed": 1}
    assert eng.kv.in_use == 0
    counters = eng.metrics.snapshot()["counters"]
    delta = {k: v - j_before.get(k, 0) for k, v in j_after.items()
             if v != j_before.get(k, 0)}
    for key in ("serving_cancelled_total", "serving_timeout_total",
                "serving_shed_total", "requests_finished_total",
                'requests_retired_total{outcome="cancelled"}',
                'requests_retired_total{outcome="timeout"}',
                'requests_retired_total{outcome="shed"}',
                'requests_retired_total{outcome="ok"}',
                "requests_submitted_total", "sched_admissions_total",
                "decode_tokens_total", "prefill_tokens_total"):
        assert counters[key] == delta[key], key
    assert counters["serving_cancelled_total"] == 2


# --------------------------------------------- (c) fault tolerance ----
@pytest.mark.parametrize("ft", [tft, jft], ids=["port", "jax"])
def test_run_with_retries_and_step_timer(ft):
    calls, seen = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError(f"transient {len(calls)}")
        return "done"

    assert ft.run_with_retries(flaky, max_retries=2,
                               on_failure=lambda a, e: seen.append(
                                   (a, str(e)))) == "done"
    assert seen == [(0, "transient 1"), (1, "transient 2")]
    calls.clear()
    with pytest.raises(RuntimeError, match="transient 2"):
        ft.run_with_retries(flaky, max_retries=1)
    timer = ft.StepTimer(alpha=0.5)
    timer.start()
    assert timer.stop() >= 0.0 and timer.ewma is not None
    assert timer.is_straggler(cluster_median_s=-1.0)
    wd = ft.Watchdog(1e-4)
    with wd:
        import time
        time.sleep(0.05)
    assert wd.fired.is_set()


def test_injected_step_fault_is_retried(setup):
    _, _, tparams = setup
    eng = _port_engine(tparams)
    eng.warmup([8])
    rid = eng.submit(_prompt(1), 4)
    eng.inject_step_fault(InjectedFault("boom"))
    # the first attempt raises before any state changes; the retry steps
    tft.run_with_retries(eng.step, max_retries=2)
    assert eng.n_steps == 1 and eng.scheduler.running
    eng.run_until_idle()
    fin = {r.rid: r for r in eng.collect()}
    assert fin[rid].outcome == "ok" and len(fin[rid].tokens) == 4
    steps = eng.n_steps
    eng.inject_step_fault(InjectedFault("boom2"))
    with pytest.raises(InjectedFault):
        eng.step()
    assert eng.n_steps == steps             # a faulted step never ran


def test_watchdog_counts_and_strict_raises(setup):
    _, _, tparams = setup
    eng = _port_engine(tparams, step_deadline_s=1e-6)
    eng.warmup([8])
    eng.submit(_prompt(1), 3)
    eng.run_until_idle()                   # lenient: counts, never raises
    c = eng.metrics.snapshot()["counters"]
    assert c["serving_step_deadline_exceeded_total"] >= 1
    assert {r.outcome for r in eng.collect()} == {"ok"}
    strict = _port_engine(tparams, step_deadline_s=1e-6,
                          step_deadline_strict=True)
    strict.submit(_prompt(1), 3)
    with pytest.raises(tft.StepDeadlineExceeded, match="serving step 0"):
        strict.run_until_idle()
    with pytest.raises(AssertionError):
        tconfigs.ServingConfig(step_deadline_s=-1.0)


def test_run_until_idle_raises_typed_stuck_error(setup):
    _, _, tparams = setup
    clock = _StepClock()                   # frozen: the arrival never comes
    eng = _port_engine(tparams, clock=clock)
    rid = eng.submit(_prompt(1), 4, arrival=100.0)
    with pytest.raises(EngineStuckError, match="queued rids") as ei:
        eng.run_until_idle(max_steps=3)
    assert ei.value.queued == [rid] and ei.value.running == []
    assert ei.value.max_steps == 3
    assert (ei.value.pool_in_use, ei.value.pool_pages) == (0, 24)
    assert eng.metrics.snapshot()["counters"][
        "serving_engine_stuck_total"] == 1


# ------------------------------------------------- (d) snapshot/restore --
PROMPTS = [(_prompt(1), 8), (_prompt(2, L=9), 8), (_prompt(3, L=5), 6)]


def _drain(eng, clock, t, out):
    while not eng.scheduler.idle:
        assert t < 100
        clock.t = float(t)
        eng.step()
        for r in eng.collect():
            out[r.rid] = list(r.tokens)
        t += 1
    return out


def _start(eng, clock, steps=3):
    """Submit PROMPTS (max_batch 2: one waits) and run `steps` steps."""
    for p, n in PROMPTS:
        eng.submit(p, n)
    for t in range(steps):
        clock.t = float(t)
        eng.step()
    return {r.rid: list(r.tokens) for r in eng.collect()}


@pytest.fixture(scope="module")
def uninterrupted(setup):
    """PROMPTS through the JAX engine and through a port engine without a
    stop: the tokens every restored run must emit."""
    jeng, jclock, tparams = setup
    t0 = len(jeng._all)
    for p, n in PROMPTS:
        jeng.submit(p, n)
    jtok = {k - t0: v for k, v in _drain(jeng, jclock, 0, {}).items()}
    clock = _StepClock()
    eng = _port_engine(tparams, clock=clock)
    eng.warmup([8, 16])
    assert _drain(eng, clock, 0, _start(eng, clock, 0)) == jtok
    return jtok


def test_snapshot_restore_token_identity(setup, uninterrupted):
    _, _, tparams = setup
    clock = _StepClock()
    eng = _port_engine(tparams, clock=clock)
    eng.warmup([8, 16])
    out = _start(eng, clock)
    snap = eng.snapshot()
    assert set(snap) >= {"requests", "kv", "caches", "tbl", "counters"}
    old = weakref.ref(eng)
    eng = InferenceEngine.restore(snap, params=tparams, clock=clock)
    # nothing else holds the replaced engine: it is freed, graphs and all
    assert old() is None
    eng.kv.check_invariants()
    eng.scheduler.check_invariants()
    assert eng.n_steps == 3 and eng.device.type == "cpu"
    assert _drain(eng, clock, 3, out) == uninterrupted
    assert eng.kv.in_use == 0


def test_restore_into_warmed_captured_engine_keeps_storage(setup,
                                                           uninterrupted):
    """Graphs captured by warmup stay valid: the restore copies the pools
    and the table pool into the tensors they were captured on, and the
    resumed run replays them."""
    _, _, tparams = setup
    clock = _StepClock()
    src = _port_engine(tparams, clock=clock)
    src.warmup([8, 16])
    out = _start(src, clock)
    snap = src.snapshot()
    eng = _port_engine(tparams, clock=clock,
                       telemetry=Telemetry(strict_recompiles=True))
    eng._capture_steps(record, ReplayDouble)
    eng.warmup([8, 16])
    captured = eng.stats()["recompiles"]["total"]
    ptrs = [t.data_ptr() for _, t in _pool_leaves(eng.caches)]
    tbl = eng._tbl.data_ptr()
    eng._load_snapshot(snap)
    assert [t.data_ptr() for _, t in _pool_leaves(eng.caches)] == ptrs
    assert eng._tbl.data_ptr() == tbl
    for (_, t), want in zip(_pool_leaves(eng.caches), snap["caches"]):
        assert torch.equal(t, want)
    assert torch.equal(eng._tbl, snap["tbl"])
    ReplayDouble.replays = 0
    assert _drain(eng, clock, 3, out) == uninterrupted
    rec = eng.stats()["recompiles"]
    assert rec["steady_state"] == 0 and rec["total"] == captured
    assert ReplayDouble.replays > 0
