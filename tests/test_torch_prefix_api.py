"""Shared-prefix traffic, the `ServingAPI` facade, the trace recorder,
`profile()` and the CLI's lifecycle scenarios, port against the JAX
package.

(a) `shared_prefix_trace` draws the JAX package's arrays from a seed.
(b) One shared-prefix trace through the JAX engine and the port engine
    (2 layers of the reduced qwen2-0.5b, W4A4 in float32, trace recorder
    on), bucketed and ragged: the same tokens, the same prefix statistics
    in stats(), the same Chrome trace (lanes, and every span's name, lane
    and arguments), and `profile()` with the JAX keys at the same step.
(c) Prefix cache on vs off in the port: the same tokens, hit rate > 0.5.
(d) `ServingAPI` end to end, with the JAX facade's surface.
(e) The CLI on the CPU: ``--scenario shared_prefix`` with ``--trace-out``,
    ``--metrics off``, ``chaos`` and ``cancel_storm``.
"""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.observability import Telemetry as JTelemetry  # noqa: E402
from repro.serving.api import ServingAPI as JServingAPI  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.api import \
    shared_prefix_trace as j_shared_prefix_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.observability import Telemetry  # noqa: E402
from repro_torch.serving.api import (ServingAPI, run_trace,  # noqa: E402
                                     shared_prefix_trace)
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.scheduler import ShedError  # noqa: E402

F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32", cache_dtype="float32")
#: three 4-token pages of system prompt, then a 4- or 9-token suffix
TRACE = dict(n_requests=6, rate_per_step=0.7, sys_len=12, user_lens=(4, 9),
             gen_lens=(4, 6), seed=1)
WARM = (4, 9, 16, 21)
SV = {"bucketed": dict(layout="paged", max_batch=4, page_size=4,
                       num_pages=40, max_ctx=48),
      "ragged": dict(layout="paged", max_batch=4, page_size=4, num_pages=40,
                     max_ctx=48, step="ragged", token_budget=16)}
#: the prefix fields of stats()
PREFIX_FIELDS = ("prefill_tokens", "tokens_prefilled_saved",
                 "prefix_hit_rate", "prefix_cache", "requests_preempted",
                 "outcomes", "decode_tokens", "padding_tokens_wasted",
                 "token_utilization", "steps")


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=5, n_system_prompts=3),
                                dict(seed=2, rate_per_step=3.0)])
def test_shared_prefix_trace_equals_jax_package(kw):
    args = dict(n_requests=9, rate_per_step=0.5, sys_len=20,
                user_lens=(3, 7, 11), gen_lens=(2, 5), vocab=1000)
    args.update(kw)
    got = shared_prefix_trace(**args)
    want = j_shared_prefix_trace(**args)
    assert len(got) == len(want) == args["n_requests"]
    for g, w in zip(got, want):
        assert g.arrival_step == w.arrival_step and g.max_new == w.max_new
        assert g.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, w.prompt)
    prefixes = {tuple(g.prompt[:args["sys_len"]]) for g in got}
    assert len(prefixes) <= args.get("n_system_prompts", 1)


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    jrt = jconfigs.Runtime(**F32, remat="none", loss_chunk=0)
    jparams = j_build_params(jcfg, jrt, seed=0)
    tparams = prepack_tree(params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    return jcfg, jrt, jparams, tparams


def _port_engine(tparams, sv, **kw):
    cfg = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    return InferenceEngine(cfg, tconfigs.Runtime(**F32),
                           tconfigs.ServingConfig(**sv), params=tparams,
                           device="cpu", **kw)


def _serve(eng, trace):
    eng.warmup(WARM)
    stats, fin = run_trace(eng, trace)
    return stats, [r.tokens for r in fin], eng.trace.to_chrome(), \
        eng.profile()


@pytest.fixture(scope="module")
def runs(weights):
    """The shared-prefix trace through both engines in both step modes,
    trace recorders on: mode -> {"jax" | "port": (stats, tokens, chrome
    trace, profile)}."""
    jcfg, jrt, jparams, tparams = weights
    out = {}
    for mode, sv in SV.items():
        je = JEngine(jcfg, jrt, jconfigs.ServingConfig(**sv), params=jparams,
                     telemetry=JTelemetry(trace=True))
        jtrace = j_shared_prefix_trace(vocab=jcfg.vocab, **TRACE)
        je.warmup(WARM)
        jstats, jfin = j_run_trace(je, jtrace)
        jout = (jstats, [r.tokens for r in jfin], je.trace.to_chrome(),
                je.profile())
        te = _port_engine(tparams, sv, telemetry=Telemetry(trace=True))
        out[mode] = {"jax": jout, "port": _serve(
            te, shared_prefix_trace(vocab=jcfg.vocab, **TRACE))}
    return out


@pytest.mark.parametrize("mode", list(SV))
def test_engine_tokens_and_prefix_stats_equal_jax_engine(runs, mode):
    (jstats, jtok, _, _), (tstats, ttok, _, _) = (runs[mode]["jax"],
                                                 runs[mode]["port"])
    assert ttok == jtok
    for field in PREFIX_FIELDS:
        assert tstats[field] == jstats[field], field
    assert tstats["tokens_prefilled_saved"] > 0
    counters = tstats["metrics"]["counters"]
    jcounters = jstats["metrics"]["counters"]
    for key in ("prefix_lookups_total", "prefix_hits_total",
                "prefix_hit_pages_total", "prefix_hit_tokens_total",
                "tail_prefill_tokens_total"):
        assert counters.get(key) == jcounters.get(key), key


def _spans(chrome):
    """Every span and lane name of a Chrome trace, timing left out."""
    lanes = sorted((e["tid"], e["args"]["name"]) for e in chrome["traceEvents"]
                   if e["ph"] == "M" and e["name"] == "thread_name")
    spans = sorted((e["name"], e["tid"], json.dumps(e.get("args", {}),
                                                    sort_keys=True))
                   for e in chrome["traceEvents"] if e["ph"] == "X")
    return lanes, spans


@pytest.mark.parametrize("mode", list(SV))
def test_trace_recorder_matches_jax_run(runs, mode):
    jchrome, tchrome = runs[mode]["jax"][2], runs[mode]["port"][2]
    (jlanes, jspans), (tlanes, tspans) = _spans(jchrome), _spans(tchrome)
    assert tlanes == jlanes == [(0, "engine")] + [
        (1 + s, f"slot{s}") for s in range(4)]
    assert tspans == jspans
    names = {n for n, _, _ in tspans}
    want = {"step", "r0"} | ({"prefill", "tail_prefill"} if mode == "bucketed"
                             else {"chunk_prefill"})
    assert want <= names
    assert tchrome["otherData"] == jchrome["otherData"]
    json.loads(json.dumps(tchrome))


@pytest.mark.parametrize("mode", list(SV))
def test_profile_has_jax_keys_and_step(runs, mode):
    jprof, tprof = runs[mode]["jax"][3], runs[mode]["port"][3]
    assert set(tprof) == set(jprof)
    assert tprof["at_step"] == jprof["at_step"] > 0
    assert tprof["decode_step_us"] > 0 and tprof["attn_us"] > 0
    assert 0 < tprof["attn_frac"] <= 1
    stats = runs[mode]["port"][0]
    assert "profile" not in stats          # run_trace's stats predate it


@pytest.mark.parametrize("mode", list(SV))
def test_prefix_cache_on_off_token_identity(weights, mode):
    _, _, _, tparams = weights
    vocab = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=2).vocab
    trace = shared_prefix_trace(vocab=vocab, **dict(TRACE, rate_per_step=0.3))
    out = {}
    for on in (True, False):
        eng = _port_engine(tparams, dict(SV[mode], prefix_cache=on))
        eng.warmup(WARM)
        stats, fin = run_trace(eng, trace)
        out[on] = (stats, [r.tokens for r in fin])
    assert out[True][1] == out[False][1]
    assert out[True][0]["prefix_hit_rate"] > 0.5
    assert out[False][0]["tokens_prefilled_saved"] == 0
    assert out[True][0]["prefill_tokens"] < out[False][0]["prefill_tokens"]


def test_serving_api_end_to_end(weights):
    """submit / cancel / step / collect / stats / trace / metrics_text on
    the port's facade, whose public surface is the JAX facade's."""
    public = {n for n in dir(JServingAPI) if not n.startswith("_")}
    assert public == {n for n in dir(ServingAPI) if not n.startswith("_")}
    _, _, _, tparams = weights
    sv = dict(SV["bucketed"], max_batch=2, max_queue=2)
    api = ServingAPI(_port_engine(tparams, sv,
                                  telemetry=Telemetry(trace=True)))
    api.engine.warmup((4, 9))
    vocab = api.engine.cfg.vocab
    trace = shared_prefix_trace(vocab=vocab, **TRACE)
    a = api.submit(trace[0].prompt, 5)
    assert api.step() == 1                      # a's pages are registered
    b = api.submit(trace[1].prompt, 5, deadline_s=60.0)
    c = api.submit(trace[2].prompt, 5)
    with pytest.raises(ShedError):              # the queue of two is full
        api.submit(trace[3].prompt, 5)
    assert api.step() == 2                      # b joins a; c waits
    assert api.cancel(c) and not api.cancel(c)
    while api.step():
        pass
    done = {r.rid: r for r in api.collect()}
    assert {r: done[r].outcome for r in (a, b, c)} == {
        a: "ok", b: "ok", c: "cancelled"}
    assert [r.outcome for r in done.values()].count("shed") == 1
    assert len(done[a].tokens) == len(done[b].tokens) == 5
    stats = api.stats()
    assert stats["outcomes"] == {"ok": 2, "cancelled": 1, "shed": 1}
    assert stats["tokens_prefilled_saved"] > 0       # b hit a's system pages
    text = api.metrics_text()
    assert "serving_cancelled_total 1" in text
    assert "serving_shed_total 1" in text
    assert 'requests_retired_total{outcome="ok"} 2' in text
    names = {e["name"] for e in api.trace.to_chrome()["traceEvents"]}
    assert {"step", "prefill", "tail_prefill", f"r{a}"} <= names


def _cli(monkeypatch, capsys, *args):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-0.5b", "--reduced", "--layers", "2",
        "--device", "cpu", "--requests", "5", "--prompt-lens", "4,9",
        "--gen-lens", "3,5", "--max-batch", "2", *args])
    tserve.main()
    return json.loads(capsys.readouterr().out)


def test_cli_shared_prefix_trace_out_and_metrics_off(monkeypatch, capsys,
                                                     tmp_path):
    path = tmp_path / "trace.json"
    rep = _cli(monkeypatch, capsys, "--scenario", "shared_prefix",
               "--sys-len", "16", "--trace-out", str(path))
    assert rep["sys_len"] == 16 and rep["tokens_prefilled_saved"] > 0
    assert rep["prefix_hit_rate"] > 0 and rep["recompiles_steady_state"] == 0
    assert rep["trace_out"] == str(path)
    assert set(rep["paged"]["profile"]) == {
        "decode_step_us", "attn_us", "gemm_other_us", "attn_frac", "at_step"}
    assert rep["paged"]["profile_at_step"] == rep["paged"]["steps"]
    chrome = json.loads(path.read_text())
    lanes = {e["tid"] for e in chrome["traceEvents"] if e["ph"] == "M"}
    assert lanes == {0, 1, 2}
    assert any(e["name"] == "tail_prefill" for e in chrome["traceEvents"])
    off = _cli(monkeypatch, capsys, "--scenario", "shared_prefix",
               "--metrics", "off")
    assert off["paged"]["metrics"]["counters"] == {}
    assert off["paged"]["recompiles"]["total"] == 0
    assert "trace_out" not in off


@pytest.mark.parametrize("scenario", ["chaos", "cancel_storm"])
def test_cli_chaos_scenarios(monkeypatch, capsys, scenario):
    rep = _cli(monkeypatch, capsys, "--scenario", scenario,
               "--chaos-seed", "3", "--num-pages", "16")
    assert rep["scenario"] == scenario and rep["seed"] == 3
    assert rep["survivors_identical"] and rep["leaked_pages"] == 0
    assert rep["recompiles_steady_state"] == 0
    assert [r["step_mode"] for r in rep["runs"]] == ["bucketed", "ragged"]
    for run in rep["runs"]:
        assert sum(run["outcomes"].values()) == 5
        assert run["events"]["stop_resumes"] == 1
    if scenario == "cancel_storm":
        assert all(r["events"]["cancels"] > 0 for r in rep["runs"])
