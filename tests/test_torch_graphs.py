"""The compiled step on the CPU: the port's recompile sentinel against the
JAX package's, the port engine's capture counts against the JAX engine's
compile counts on one trace, and `CapturedStep`'s key, copy and
launch-count logic under a replay double of ``torch.cuda.CUDAGraph``.

(a) ``JitWatch`` in both packages, called with the same sequence, gives
    the same counts, events and registry counters, and raises on a
    steady-state recompile under ``strict``.
(b) At 2 layers, the port engine's ``stats()["recompiles"]`` (each new
    shape of an eager step counts, the sentinel's novelty fallback) equals
    the JAX engine's (jit cache growth) on the same warmup and trace,
    bucketed and ragged.
(c) The port engine with its steps wrapped in `CapturedStep` over a
    replay double emits the eager engine's tokens, launch counts and
    capture counts over a trace with preemption and prefix hits.
(d) `CapturedStep` raises when a call hands it other parameter, pool or
    table storage.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.observability import MetricsRegistry as JRegistry  # noqa: E402
from repro.observability.jit_watch import JitWatch as JJitWatch  # noqa: E402
from repro.observability.jit_watch import \
    RecompileError as JRecompileError  # noqa: E402
from repro.serving.api import mixed_trace as j_mixed_trace  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import CapturedStep  # noqa: E402
from repro_torch.observability import Telemetry  # noqa: E402
from repro_torch.observability.jit_watch import (JitWatch,  # noqa: E402
                                                 NullJitWatch,
                                                 RecompileError)
from repro_torch.observability.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serving.api import mixed_trace, poisson_trace  # noqa: E402
from repro_torch.serving.api import run_trace  # noqa: E402
from repro_torch.serving.engine import STEP_NAMES  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402


# ------------------------------------------------------- (a) the sentinel --
class _Cached:
    """A step with a settable cache size, as a jit or a CapturedStep."""

    def __init__(self):
        self.size = 0

    def _cache_size(self):
        return self.size


#: (fn, shape, cache growth before the poll); "absorb" re-baselines
SEQUENCE = [
    ("prefill", (1, 32), 1), ("prefill", (1, 32), 0),
    ("decode", (4, 1), 1), ("decode", (8, 1), 1), ("decode", (4, 1), 0),
    ("absorb", None, 2),                    # probe captures, not counted
    ("decode", (8, 1), 0), ("prefill", (1, 64), 1),
    ("decode", (4, 1), 1),                  # a steady-state recompile
    ("stub", (1, 8), 0), ("stub", (1, 8), 0), ("stub", (1, 16), 0),
]


def _drive(watch, caches):
    out = []
    for name, shape, grow in SEQUENCE:
        if name == "absorb":
            for c in caches.values():
                c.size += grow
            watch.absorb()
            continue
        if name in caches:
            caches[name].size += grow
        out.append(watch.after_call(name, shape, step=len(out)))
    return out


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_jit_watch_matches_jax_package(pkg):
    """The same calls give the same deltas, snapshot and counters in both
    packages (`stub` has no cache API: the novelty fallback)."""
    results = {}
    for name, (W, R) in {"port": (JitWatch, MetricsRegistry),
                         "jax": (JJitWatch, JRegistry)}.items():
        reg = R()
        w = W(reg)
        caches = {"prefill": _Cached(), "decode": _Cached()}
        for fn, c in caches.items():
            w.register(fn, c)
        w.register("stub", lambda: None)
        w.register("absent", None)
        deltas = _drive(w, caches)
        results[name] = (deltas, w.snapshot(), reg.snapshot()["counters"])
    deltas, snap, counters = results[pkg]
    assert (deltas, snap, counters) == results["jax"]
    assert deltas == [1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1]
    assert snap["total"] == 7 and snap["steady_state"] == 1
    assert snap["by_fn"] == {"prefill": 2, "decode": 3, "stub": 2}
    assert [e["steady_state"] for e in snap["events"]] == [
        False, False, False, False, True, False, False]


@pytest.mark.parametrize("W,E", [(JitWatch, RecompileError),
                                 (JJitWatch, JRecompileError)],
                         ids=["port", "jax"])
def test_jit_watch_strict_raises_on_steady_state_recompile(W, E):
    w = W(strict=True)
    c = _Cached()
    w.register("decode", c)
    c.size = 1
    assert w.after_call("decode", (8, 1), step=0) == 1
    c.size = 3                              # two probe captures
    w.absorb("decode")
    assert w.after_call("decode", (8, 1), step=1) == 0
    c.size = 4
    with pytest.raises(E, match=r"decode recompiled for already-seen shape "
                                r"\(8, 1\) at step 2 \(\+1"):
        w.after_call("decode", (8, 1), step=2)


def test_telemetry_bundle_and_null_watch():
    tm = Telemetry(strict_recompiles=True)
    assert isinstance(tm.jit_watch, JitWatch) and tm.jit_watch.strict
    assert tm.jit_watch.registry is tm.registry and tm.enabled
    off = Telemetry.disabled()
    assert isinstance(off.jit_watch, NullJitWatch) and not off.enabled
    off.jit_watch.register("decode", _Cached())
    assert off.jit_watch.after_call("decode", (1, 1)) == 0
    assert off.jit_watch.snapshot() == {"total": 0, "steady_state": 0,
                                        "by_fn": {}, "events": []}


# --------------------------------------- (b) engines, port vs JAX counts --
F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32", cache_dtype="float32")
BUCKETED_SV = dict(layout="paged", max_batch=4, page_size=4, num_pages=14,
                   max_ctx=48, prefix_cache=True)
RAGGED_SV = dict(layout="paged", max_batch=4, page_size=4, num_pages=40,
                 max_ctx=48, step="ragged", token_budget=2)
POISSON = dict(n_requests=8, rate_per_step=0.7, prompt_lens=(5, 12, 20),
               gen_lens=(4, 9), seed=3)
#: one arrival a step, each decoding 6 tokens: the decode set outgrows the
#: ragged step's token budget of 2 mid-run
MIXED = dict(n_requests=5, prompt_lens=(3, 4), gen_lens=(6,), seed=1)
#: warmup covers the 8- and 16-token buckets; the 20-token prompts and the
#: resumed prefixes hit the 32-token bucket first mid-run
WARM_LENS = (5, 12)


@pytest.fixture(scope="module")
def weights():
    """The reference's 2-layer reduced qwen2-0.5b W4A4 weights and the
    port's copy of them, built once for the file."""
    jcfg = jconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    jparams = j_build_params(jcfg, jconfigs.Runtime(**F32, remat="none",
                                                    loss_chunk=0), seed=0)
    return jcfg, jparams, prepack_tree(params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))


def _port_engine(tparams, sv, **kw):
    cfg = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    return InferenceEngine(cfg, tconfigs.Runtime(**F32),
                           tconfigs.ServingConfig(**sv), params=tparams,
                           device="cpu", **kw)


def _port_run(eng, sv):
    vocab = eng.cfg.vocab
    if sv.get("step") == "ragged":
        trace = mixed_trace(vocab=vocab, **MIXED)
    else:
        trace = poisson_trace(vocab=vocab, **POISSON)
    eng.warmup(WARM_LENS)
    return run_trace(eng, trace)


@pytest.mark.parametrize("sv", [BUCKETED_SV, RAGGED_SV],
                         ids=["bucketed", "ragged"])
def test_engine_recompiles_equal_jax_engines(weights, sv):
    """Warmup, then a trace: the same compiles per step function and shape,
    at the same steps, and none in steady state.  Bucketed: a prompt bucket
    first hit mid-run (32) counts as a compile in both engines.  Ragged:
    a token budget of 2 grows to 4 mid-run, a compile in both."""
    jcfg, jparams, tparams = weights
    je = JEngine(jcfg, jconfigs.Runtime(**F32, remat="none", loss_chunk=0),
                 jconfigs.ServingConfig(**sv), params=jparams)
    je.warmup(WARM_LENS)
    if sv.get("step") == "ragged":
        jtrace = j_mixed_trace(vocab=jcfg.vocab, **MIXED)
    else:
        jtrace = j_poisson_trace(vocab=jcfg.vocab, **POISSON)
    jstats, jfin = j_run_trace(je, jtrace)
    tstats, tfin = _port_run(_port_engine(tparams, sv), sv)
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    want, got = jstats["recompiles"], tstats["recompiles"]
    assert got["total"] == want["total"]
    assert got["by_fn"] == want["by_fn"]
    assert got["steady_state"] == want["steady_state"] == 0
    assert got["events"] == want["events"]
    mid_run = [e for e in got["events"] if e["step"] > 0]
    assert mid_run, "the trace hits no new shape after warmup"


# ------------------------------------------- (c) the replay double ----
class ReplayDouble:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU.  `record`, the
    capture, runs the step's Python as a real capture does (launch counts
    move, and CapturedStep takes them back), but also its work, which on
    the CPU rewrites the K/V the eager first call wrote with the same
    values.  `replay` re-runs the recorded callable on the static buffers
    and, as a real replay runs no wrapper, leaves the launch counts as it
    found them."""

    replays = 0

    def __init__(self):
        self.run = None

    def replay(self):
        counts = ops.launch_counts()
        self.run()
        ops.reset_launch_counts()
        ops.add_launch_counts(counts)
        ReplayDouble.replays += 1


def record(graph, run):
    graph.run = run
    run()


@pytest.fixture
def counted(monkeypatch):
    """The CPU dispatch of the kernels on the path counts a launch per
    call into its CUDA wrapper's count, as the wrapper does on the card."""
    for name, kernel in (("int4_matmul_fused_kmajor", "int4_matmul_fused"),
                         ("paged_decode_attention", "paged_decode_attention"),
                         ("ragged_paged_attention",
                          "ragged_decode_attention")):
        plain = getattr(ops, name)

        def counting(*a, _plain=plain, _kernel=kernel, **kw):
            ops.CUDA_WRAPPERS[_kernel].launches += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(ops, name, counting)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("sv", [BUCKETED_SV, RAGGED_SV],
                         ids=["bucketed", "ragged"])
def test_captured_engine_equals_eager_engine(weights, counted, sv):
    """Tokens, launch counts and compile counts of the captured engine
    equal the eager one's; every shape after its first call replays."""
    _, _, tparams = weights
    runs, calls = {}, [0]

    def counting(fn):
        def step(*args):
            calls[0] += 1
            return fn(*args)
        return step

    for mode in ("eager", "captured"):
        eng = _port_engine(tparams, sv, telemetry=Telemetry(
            strict_recompiles=True))
        steps = [n for n in STEP_NAMES if getattr(eng, "_" + n) is not None]
        if mode == "captured":
            eng._capture_steps(record, ReplayDouble)
        else:                       # the watch keeps the unwrapped steps
            for n in steps:
                setattr(eng, "_" + n, counting(getattr(eng, "_" + n)))
        ops.reset_launch_counts()
        ReplayDouble.replays = 0
        stats, fin = _port_run(eng, sv)
        runs[mode] = (stats, [r.tokens for r in fin], ops.launch_counts(),
                      ReplayDouble.replays, eng)
    (es, etok, en, _, _), (cs, ctok, cn, replays, eng) = (runs["eager"],
                                                         runs["captured"])
    assert ctok == etok
    assert cn == en and en["int4_matmul_fused"] > 0
    assert cs["recompiles"] == es["recompiles"]
    graphs = sum(getattr(eng, "_" + n)._cache_size() for n in steps)
    assert graphs == cs["recompiles"]["total"] > 0
    # every step call but a shape's first replays
    assert replays == calls[0] - graphs > 0
    if sv.get("step") == "ragged":
        assert cs["metrics"]["counters"]["ragged_budget_grows_total"] >= 1
    else:
        assert cs["requests_preempted"] > 0
        assert cs["tokens_prefilled_saved"] > 0


def test_captured_step_keys_copies_and_counts():
    """One graph per input shape and dtype; a replay reads the inputs it
    is handed (host or device tensors), returns the static output, and
    adds the capture's launches."""
    calls = []

    def step(params, tokens, caches, positions, tbl_all, slots):
        ops.CUDA_WRAPPERS["lut_mul4"].launches += 2
        calls.append(tokens.shape)
        return (tokens[:, -1] + positions[:, -1] + params["w"][0]
                + tbl_all[slots.long(), 0]), caches

    params = {"w": torch.tensor([100], dtype=torch.int32)}
    caches = {"rep": {"u0": {"attn": {"k": torch.zeros(3)}}}, "tail": {}}
    tbl = torch.tensor([[10], [20]], dtype=torch.int32)
    cs = CapturedStep(step, "cpu", record, ReplayDouble)
    ops.reset_launch_counts()

    def call(tok, pos, slots):
        out, c = cs(params, torch.tensor(tok, dtype=torch.int32), caches,
                    torch.tensor(pos, dtype=torch.int32), tbl,
                    torch.tensor(slots, dtype=torch.int32))
        assert c is caches
        return out.tolist()

    assert call([[1, 2]], [[3, 4]], [0]) == [2 + 4 + 100 + 10]
    assert cs._cache_size() == 1 and len(calls) == 2   # eager + capture
    assert ops.launch_counts()["lut_mul4"] == 2         # the eager call's
    assert call([[5, 6]], [[7, 8]], [1]) == [6 + 8 + 100 + 20]
    assert cs._cache_size() == 1
    assert ops.launch_counts()["lut_mul4"] == 4
    assert call([[1], [2]], [[0], [1]], [1, 0]) == [121, 113]  # new shape
    assert cs._cache_size() == 2
    tbl[1, 0] = 30                                    # read in place
    assert call([[5, 6]], [[7, 8]], [1]) == [6 + 8 + 100 + 30]
    assert cs._cache_size() == 2
    assert ops.launch_counts()["lut_mul4"] == 8
    ops.reset_launch_counts()


# -------------------------------------------- (d) donated storage ----
@pytest.mark.parametrize("swap", ["params", "pool", "table"])
def test_captured_step_refuses_other_storage(swap):
    def step(params, tokens, caches, positions, tbl_all, slots):
        return tokens[:, 0], caches

    params = {"w": torch.zeros(2), "layers": [{"b": torch.zeros(1)}]}
    caches = {"rep": {"u0": {"attn": {"k": torch.zeros(3),
                                      "tbl": torch.zeros(1)}}}, "tail": {}}
    tbl = torch.zeros((1, 1), dtype=torch.int32)
    cs = CapturedStep(step, "cpu", record, ReplayDouble)
    ins = (torch.zeros((1, 2), dtype=torch.int32),
           torch.zeros((1, 2), dtype=torch.int32),
           torch.zeros((1,), dtype=torch.int32))
    cs(params, ins[0], caches, ins[1], tbl, ins[2])
    # a new routing leaf is a per-call value, not donated storage
    caches["rep"]["u0"]["attn"]["tbl"] = torch.ones(1)
    cs(params, ins[0], caches, ins[1], tbl, ins[2])
    if swap == "params":
        params["layers"][0]["b"] = torch.zeros(1)
    elif swap == "pool":
        caches["rep"]["u0"]["attn"]["k"] = torch.zeros(3)
    else:
        tbl = tbl.clone()
    with pytest.raises(ValueError, match="same storage on every call"):
        cs(params, ins[0], caches, ins[1], tbl, ins[2])
