"""The port's plan autotuner (``repro_torch/kernels/autotune.py``), the twin
of ``tests/test_autotune.py``: plan-constraint invariants, the on-disk
cache round trip, the search with an injected timer, and what the CUDA
wrappers take from the cache.

What a wrapper would launch is read on the CPU without a card: the
wrapper's operands are CPU tensors that report ``is_cuda`` (the device
check is the wrapper's first line), and ``_build.load`` returns a
recording library whose launch functions return 0, so the plan's
arguments are read as the kernel would get them and nothing is launched.
The card test at the end runs the tuner with its CUDA-event timer and
holds each winner to its plain version.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, autotune, ops  # noqa: E402
from repro_torch.kernels import int4_matmul as i4  # noqa: E402
from repro_torch.kernels import lut4_matmul as l4  # noqa: E402
from repro_torch.kernels import w4a16_matmul as w16  # noqa: E402
from repro_torch.kernels.packing import pack_kmajor  # noqa: E402

#: qwen2-0.5b's w_in / w_gate projection
K, N = 896, 4864


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    """Point the cache at a per-test file and reset in-memory state."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.ENV_CACHE_PATH, str(path))
    autotune.reset()
    yield path
    autotune.reset()


class _OnCuda(torch.Tensor):
    """A CPU tensor that passes the wrappers' device check."""

    @property
    def is_cuda(self):
        return True


class _Recorder:
    """A kernel library whose launch functions record their arguments and
    return 0 (success): nothing runs."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def launched(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "load", lambda name, bind: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    counts = ops.launch_counts()
    yield lib
    ops.reset_launch_counts()
    ops.add_launch_counts(counts)


def _operands(M, K_, N_, G=0, dtype=torch.float32, seed=0):
    """x [M, K] of `dtype`, a_q/a_scale, the planar weight and its scale
    (grouped [K // G, 1, N] when G), as on the serving path."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K_)).astype(np.float32))
    w_q = torch.from_numpy(rng.integers(-8, 8, (K_, N_)).astype(np.int8))
    a_q = torch.from_numpy(rng.integers(-8, 8, (M, K_)).astype(np.int8))
    a_scale = torch.from_numpy(rng.uniform(0.5, 2, (M, 1)).astype(np.float32))
    if G:
        w_km = pack_kmajor(w_q, 2 * G)
        w_scale = torch.from_numpy(
            rng.uniform(0.5, 2, (K_ // G, 1, N_)).astype(np.float32))
    else:
        w_km = pack_kmajor(w_q)
        w_scale = torch.from_numpy(
            rng.uniform(0.5, 2, (1, N_)).astype(np.float32))
    return x.to(dtype), a_q, a_scale, w_km, w_scale


def _on_cuda(*ts):
    return [t.as_subclass(_OnCuda) for t in ts]


def _launch_args(lib, op, M, K_, N_, G=0, dtype="float32", **kw):
    """Call the op's CUDA wrapper on recorded CPU operands: the plan part
    of the one launch's arguments."""
    x, a_q, a_scale, w_km, w_scale = _operands(
        M, K_, N_, G, getattr(torch, dtype))
    lib.calls.clear()
    if op == "int4_matmul" and dtype == "float32":
        i4.int4_matmul_fused_cuda(*_on_cuda(x, w_km, w_scale), **kw)
        sl = slice(9, 14)
    elif op == "int4_matmul":
        i4.int4_matmul_cuda(*_on_cuda(a_q, a_scale, w_km, w_scale), **kw)
        sl = slice(9, 14)
    elif op == "gemm.lut4":
        l4.lut4_matmul_cuda(*_on_cuda(a_q, a_scale, w_km, w_scale), **kw)
        sl = slice(11, 15)
    else:
        w16.w4a16_matmul_cuda(*_on_cuda(x, w_km, w_scale), G or K_, **kw)
        sl = slice(12, 18)
    assert len(lib.calls) == 1, lib.calls
    return lib.calls[0][1][sl]


#: (op, dtype, group size) of every tuned kernel entry
OPS = (("int4_matmul", "float32", 0), ("int4_matmul", "int8", 0),
       ("gemm.lut4", "int8", 0), ("w4a16_matmul", "bfloat16", 128),
       ("w4a16_matmul", "bfloat16", 0), ("w4a16_matmul", "float32", 0))


# ------------------------------------------------------------ plan rules --
@pytest.mark.parametrize("M,K_,N_,G", [(1, 512, 512, 0), (256, 384, 128, 64),
                                       (7, 9, 24, 0), (128, 1024, 4096, 128)])
def test_rule_plans_respect_kernel_constraints(M, K_, N_, G):
    """Each op's rule plan, as an entry, is one its kernel takes, and
    taking it back gives the rule's plan."""
    Kh = -(-K_ // 2)
    if not G:
        p = i4.w4a4_plan(M, K_, N_, Kh)
        assert (p.bm, p.bn) in i4.TILES and p.splits <= i4.MAX_SPLITS
        assert p.splits == 1 or p.rows % i4.KSTEP == 0
        assert i4.w4a4_plan_from(i4.plan_entry(p), M, K_, N_, Kh) == p
        q = l4.lut4_plan(M, K_, N_, Kh)
        assert q.bm in l4.BMS and (q.bm == 64) == (M > 16)
        assert l4.lut4_plan_from(l4.plan_entry(q), M, K_, N_, Kh) == q
    Kh = w16._kh(K_, G)
    for bf16 in (True, False):
        r = w16._rule(M, K_, N_, G, "bfloat16" if bf16 else "float32")
        assert w16.w4a16_plan_from(w16.plan_entry(r), M, K_, N_, Kh, G,
                                   bf16) == r
        if M <= w16.SPLITK_MAX_M:
            assert r.rows <= 128 and (not G or G % r.rows == 0)


def test_candidates_include_rule_and_are_unique():
    for op, dtype, G in OPS:
        for M in (8, 256):
            cands = autotune.candidate_plans(op, M, K, N, dtype, G)
            t = autotune.tuning(op)
            assert cands[0] == t.rule(M, K, N, G, dtype)
            assert len({json.dumps(c, sort_keys=True) for c in cands}) \
                == len(cands)
            for c in cands:
                t.check(c, M, K, N, G, dtype)
    # more than one candidate where there is a choice to make
    assert len(autotune.candidate_plans("int4_matmul", 256, K, N,
                                        "float32")) > 4
    assert len(autotune.candidate_plans("w4a16_matmul", 256, K, N,
                                        "bfloat16", 128)) == 2


def test_untuned_lookup_builds_no_key(monkeypatch):
    """With the cache empty a lookup returns at once: every eager launch
    of an untuned run pays no key formatting and no dict search."""
    def no_key(*a, **kw):
        raise AssertionError("an untuned lookup built a cache key")

    monkeypatch.setattr(autotune, "cache_key", no_key)
    for op, dtype, G in OPS:
        assert autotune.lookup(op, 8, K, N, dtype, G) is None
    assert autotune._LOADED_FROM is not None        # the file was read


def test_lookup_without_cache_returns_rule_plans(launched):
    """No cache file: the lookup finds nothing and every wrapper launches
    its rule's plan."""
    assert autotune.lookup("int4_matmul", 8, K, N, "float32") is None
    p = i4.w4a4_plan(8, K, N, K // 2)
    for dtype in ("float32", "int8"):
        assert _launch_args(launched, "int4_matmul", 8, K, N,
                            dtype=dtype) == (p.bm, p.bn, p.vec, p.rows,
                                             p.splits)
    q = l4.lut4_plan(8, K, N, K // 2)
    assert _launch_args(launched, "gemm.lut4", 8, K, N) \
        == (q.bm, q.vec, q.rows, q.splits)
    s = w16.splitk_plan(8, N, 512, 128)
    assert _launch_args(launched, "w4a16_matmul", 8, K, N, 128,
                        "bfloat16") == (0, s.vec, 0, s.mt, s.rows, s.splits)
    r = w16.prefill_plan(256, K, N, 512, 128)
    assert _launch_args(launched, "w4a16_matmul", 256, K, N, 128,
                        "bfloat16") == (2, r.w_vec, r.x_vec, r.bm, 0, 0)


# ------------------------------------------------------------ cache round --
def test_tune_persists_and_lookup_round_trips(isolated_cache):
    """tune() -> JSON on disk -> fresh in-memory state reads it back."""
    target = {"bm": 32, "bn": 64, "rows": 128, "splits": 4}

    def fake_timer(fn):
        entry = fn()                              # make_call returns it
        return 1.0 if entry == target else 100.0

    best, us = autotune.tune(
        "int4_matmul", lambda entry: (lambda e=entry: e),
        64, K, N, "float32", timer=fake_timer)
    assert best == target and us == 1.0
    assert isolated_cache.exists()

    autotune.reset()                              # force a re-read from disk
    assert autotune.lookup("int4_matmul", 64, K, N, "float32") == target
    assert i4.launch_plan(64, K, N, K // 2, True, "float32") \
        == i4.w4a4_plan_from(target, 64, K, N, K // 2)


def test_tagged_entry_wins_over_untagged(isolated_cache):
    key_args = ("w4a16_matmul", 8, K, N, "bfloat16")
    autotune._CACHE[autotune.cache_key(*key_args, group_size=128)] = \
        {"mt": 2, "rows": 128, "splits": 4, "us": 5.0}
    autotune._CACHE[autotune.cache_key(*key_args, group_size=128,
                                       tag="ffn.w_in")] = \
        {"mt": 1, "rows": 64, "splits": 8, "us": 2.0}
    autotune.save_cache()
    autotune.reset()
    tagged = autotune.lookup(*key_args, group_size=128, tag="ffn.w_in")
    untagged = autotune.lookup(*key_args, group_size=128)
    other_site = autotune.lookup(*key_args, group_size=128, tag="attn.qkv")
    assert tagged == {"mt": 1, "rows": 64, "splits": 8}
    assert untagged == other_site == {"mt": 2, "rows": 128, "splits": 4}


def test_cache_key_distinguishes_dtype_shape_backend():
    keys = {
        autotune.cache_key("int4_matmul", 8, 256, 512, "int8"),
        autotune.cache_key("int4_matmul", 8, 256, 512, "float32"),
        autotune.cache_key("int4_matmul", 16, 256, 512, "int8"),
        autotune.cache_key("int4_matmul", 8, 256, 512, "int8", backend="tpu"),
        autotune.cache_key("w4a16_matmul", 8, 256, 512, "int8"),
        autotune.cache_key("int4_matmul", 8, 256, 512, "int8", group_size=64),
    }
    assert len(keys) == 6
    # the port's entries carry its own backend: the JAX package's never
    # match, and the fields are the reference's
    assert autotune.cache_key("gemm.lut4", 8, 256, 512, "int8") \
        == "gemm.lut4|m8|k256|n512|int8|g0|cuda"


def test_corrupt_cache_file_is_ignored(isolated_cache):
    isolated_cache.write_text("{not json")
    assert autotune.load_cache() == 0
    assert autotune.lookup("int4_matmul", 8, 64, 64, "int8") is None
    assert i4.launch_plan(8, 64, 64, 32, True, "int8") \
        == i4.w4a4_plan(8, 64, 64, 32)


def test_load_skips_malformed_entries(isolated_cache):
    key = autotune.cache_key
    isolated_cache.write_text(json.dumps({
        key("int4_matmul", 8, K, N, "float32"):
            {"bm": 16, "bn": 64, "rows": 224, "splits": 2, "us": 1.0},
        key("int4_matmul", 16, K, N, "float32"): {"bm": 16},
        key("int4_matmul", 32, K, N, "float32"):
            {"bm": "16", "bn": 64, "rows": 224},
        key("int4_matmul", 64, K, N, "float32"):        # not instantiated
            {"bm": 16, "bn": 128, "rows": 448},
        key("int4_matmul", 128, K, N, "float32"):       # rows and splits
            {"bm": 64, "bn": 64, "rows": 224, "splits": 3},
        key("gemm.lut4", 8, K, N, "int8"):              # bm below M
            {"bm": 4, "rows": 448},
        key("w4a16_matmul", 8, K, N, "bfloat16", 128):  # rows not in G
            {"mt": 1, "rows": 96},
        key("attn.prefill", 8, K, N, "bfloat16"): {"bm": 8, "bn": 0,
                                                    "bk": 64},
        key("int4_matmul", 8, K, N, "int8", backend="tpu"):
            {"bm": 16, "bn": 64, "rows": 448},
        "bad|key": {"bm": 8},
        "worse|key": 17,
    }))
    assert autotune.load_cache() == 1


def test_tune_skips_failing_candidates(isolated_cache):
    # a plan the kernel cannot take is skipped: by the op's check before
    # make_call runs (a tile the kernel does not instantiate), or by the
    # wrapper's ValueError before any launch; each skip bumps the
    # rejection counter
    good = {"bm": 64, "bn": 128, "rows": 448, "splits": 1}
    no_tile = {"bm": 16, "bn": 128, "rows": 448, "splits": 1}
    refused = {"bm": 64, "bn": 64, "rows": 448, "splits": 1}
    made = []

    def make_call(entry):
        made.append(entry)

        def run():
            if entry == refused:
                raise ValueError("the wrapper refuses this plan")
            return entry
        return run

    def fake_timer(fn):
        fn()
        return 10.0

    from repro_torch.observability.metrics import global_registry
    rejected = global_registry().counter(
        "autotune_tiles_rejected_total",
        "autotune candidates skipped: a plan the kernel cannot take",
        op="int4_matmul")
    before = rejected.value
    best, _ = autotune.tune("int4_matmul", make_call, 256, K, N, "float32",
                            candidates=[no_tile, refused, good],
                            timer=fake_timer)
    assert best == good
    assert no_tile not in made
    assert rejected.value == before + 2


def test_tune_propagates_programming_errors(isolated_cache):
    # a TypeError is a bug in make_call, and a failed launch (RuntimeError
    # from _build.check) may have poisoned the CUDA context: neither is a
    # rejected plan, so both escape instead of skipping the candidate
    for err in (TypeError("bug, not a bad plan"),
                RuntimeError("int4_matmul: CUDA launch failed")):
        def make_call(entry, err=err):
            def run():
                raise err
            return run

        with pytest.raises(type(err)):
            autotune.tune("int4_matmul", make_call, 64, K, N, "float32",
                          candidates=[{"bm": 64, "bn": 128, "rows": 448}],
                          timer=lambda fn: (fn(), 10.0)[1])
    with pytest.raises(ValueError, match="no plan search"):
        autotune.tune("attn.unknown", lambda e: (lambda: e), 8, 512,
                      896, "bfloat16", timer=lambda fn: 1.0)
    assert autotune._CACHE == {}


def test_tune_key_matches_wrapper_lookup_key(isolated_cache, launched,
                                             monkeypatch):
    """Each CUDA wrapper asks the cache under the key ``tune`` writes
    (op, shape, *activation* dtype, group size): a drift here would make
    every tuned entry dead weight."""
    asked = []
    real = autotune.lookup

    def spy(*args, **kw):
        asked.append(autotune.cache_key(*args, **kw))
        return real(*args, **kw)

    monkeypatch.setattr(autotune, "lookup", spy)
    for op, dtype, G in OPS:
        for M in (8, 256):
            cands = autotune.candidate_plans(op, M, K, N, dtype, G)
            target = cands[-1]
            autotune.tune(op, lambda e: (lambda: e), M, K, N, dtype,
                          group_size=G, timer=lambda fn: 1.0,
                          candidates=[target])
            key = autotune.cache_key(op, M, K, N, dtype, G)
            assert key in autotune._CACHE
            asked.clear()
            got = _launch_args(launched, op, M, K, N, G, dtype)
            assert asked == [key]
            want = _launch_args(launched, op, M, K, N, G, dtype,
                                plan=target)
            assert got == want


# ----------------------------------------------------------- integration ---
def test_tuned_plan_reaches_the_launch_for_its_shape_only(launched):
    """A cache entry changes the plan the CUDA wrapper would launch for
    that shape and nothing else; the plan functions read the same."""
    rule8 = _launch_args(launched, "int4_matmul", 8, K, N)
    rule16 = _launch_args(launched, "int4_matmul", 16, K, N)
    rule_unfused = _launch_args(launched, "int4_matmul", 8, K, N,
                                dtype="int8")
    entry = {"bm": 32, "bn": 64, "rows": 128, "splits": 4}
    autotune._CACHE[autotune.cache_key("int4_matmul", 8, K, N,
                                       "float32")] = {**entry, "us": 1.0}
    assert _launch_args(launched, "int4_matmul", 8, K, N) \
        == (32, 64, 16, 128, 4) != rule8
    assert _launch_args(launched, "int4_matmul", 16, K, N) == rule16
    assert _launch_args(launched, "int4_matmul", 8, K, N, dtype="int8") \
        == rule_unfused
    p = i4.launch_plan(8, K, N, K // 2, True, "float32")
    assert (p.bm, p.bn, p.rows, p.splits) == (32, 64, 128, 4)

    autotune._CACHE[autotune.cache_key("gemm.lut4", 8, K, N, "int8")] = \
        {"bm": 16, "rows": 32, "splits": 14}
    assert _launch_args(launched, "gemm.lut4", 8, K, N) == (16, 16, 32, 14)
    autotune._CACHE[autotune.cache_key("w4a16_matmul", 8, K, N, "bfloat16",
                                       128)] = {"mt": 1, "rows": 32}
    assert _launch_args(launched, "w4a16_matmul", 8, K, N, 128,
                        "bfloat16") == (0, 16, 0, 1, 32, 16)
    autotune._CACHE[autotune.cache_key("w4a16_matmul", 256, K, N,
                                       "bfloat16", 128)] = \
        {"kernel": "mma", "bm": 32}
    assert _launch_args(launched, "w4a16_matmul", 256, K, N, 128,
                        "bfloat16")[:4] == (2, 16, 16, 32)


@pytest.mark.parametrize("op,dtype,G,entry", [
    ("int4_matmul", "float32", 0, {"bm": 16, "bn": 128, "rows": 448}),
    ("int4_matmul", "int8", 0, {"bm": 16, "bn": 64, "rows": 40}),
    ("gemm.lut4", "int8", 0, {"bm": 64, "rows": 448}),
    ("w4a16_matmul", "bfloat16", 128, {"mt": 4, "rows": 64}),
    ("w4a16_matmul", "bfloat16", 128, {"mt": 1, "rows": 48}),
    ("w4a16_matmul", "float32", 0, {"mt": 1, "rows": 256}),
])
def test_entry_the_kernel_cannot_take_is_refused(launched, op, dtype, G,
                                                 entry):
    """An entry the kernel cannot take raises ValueError from the wrapper
    before any launch, whether a caller hands it in or the cache holds it,
    and the tuner's check refuses it."""
    with pytest.raises(ValueError):
        _launch_args(launched, op, 8, K, N, G, dtype, plan=entry)
    assert launched.calls == []
    with pytest.raises(ValueError):
        autotune.tuning(op).check(entry, 8, K, N, G, dtype)
    autotune._CACHE[autotune.cache_key(op, 8, K, N, dtype, G)] = entry
    with pytest.raises(ValueError):
        _launch_args(launched, op, 8, K, N, G, dtype)
    assert launched.calls == []


def test_plain_versions_ignore_the_cache(monkeypatch):
    """On CPU tensors the ops run the plain versions, which never read the
    cache: the same outputs with and without a tuned entry, and no
    lookup."""
    x, a_q, a_scale, w_km, w_scale = _operands(8, K, N)
    _, _, _, w_g, s_g = _operands(8, K, N, 128)
    calls = (lambda: ops.int4_matmul_fused_kmajor(x, w_km, w_scale),
             lambda: ops.int4_matmul_kmajor(a_q, a_scale, w_km, w_scale),
             lambda: ops.lut4_matmul_kmajor(a_q, a_scale, w_km, w_scale),
             lambda: ops.w4a16_matmul_kmajor(x.to(torch.bfloat16), w_g, s_g,
                                             128))
    before = [c() for c in calls]
    for op, dtype, G in OPS:
        autotune._CACHE[autotune.cache_key(op, 8, K, N, dtype, G)] = \
            autotune.candidate_plans(op, 8, K, N, dtype, G)[-1]

    def no_lookup(*a, **kw):
        raise AssertionError("a plain version read the plan cache")

    monkeypatch.setattr(autotune, "lookup", no_lookup)
    for c, b in zip(calls, before):
        assert torch.equal(c(), b)
    # the exact integer dot, whatever the cache says
    want = torch.matmul(a_q.to(torch.float64), torch.from_numpy(
        np.asarray(i4.unpack_kmajor(w_km)[:K], np.float64)))
    assert torch.equal(before[1], (want.float() * a_scale) * w_scale)


def test_engine_loads_the_cache_when_built(isolated_cache):
    """Building an engine loads the cache file (the JAX engine's
    ``autotune.ensure_loaded()``), so every capture sees the tuned plans."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.serving.engine import InferenceEngine

    entry = {"bm": 16, "bn": 64, "rows": 224, "splits": 2}
    isolated_cache.write_text(json.dumps({autotune.cache_key(
        "int4_matmul", 8, K, N, "float32"): entry}))
    cfg = get_config("qwen2-0.5b").reduced(n_layers=1)
    InferenceEngine(cfg, Runtime(quant_backend="w4a4_packed"),
                    ServingConfig(max_batch=2, page_size=4, num_pages=8,
                                  max_ctx=16), device="cpu")
    assert autotune._LOADED_FROM == str(isolated_cache)
    assert autotune.lookup("int4_matmul", 8, K, N, "float32") == entry


# ----------------------------------------------------------------- card ---
@pytest.mark.cuda
def test_tuned_plans_hold_to_plain_on_card(tmp_path):
    """On the card: the tuner's CUDA-event timer over each op's candidates
    at one qwen2-0.5b shape; every timed candidate's output, and the
    winner's taken back from the saved cache by the wrapper, against the
    plain version: the integer kernels bit for bit, W4A16 within 1e-4 of
    the output's largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    path = str(tmp_path / "tuned.json")
    cases = (("int4_matmul", "float32", 0, 8), ("int4_matmul", "float32", 0,
                                                 256),
             ("gemm.lut4", "int8", 0, 8), ("w4a16_matmul", "bfloat16", 128,
                                           8))
    for op, dtype, G, M in cases:
        x, a_q, a_scale, w_km, w_scale = (
            t.to(dev) for t in _operands(M, K, N, G, getattr(torch, dtype)
                                         if dtype != "int8" else
                                         torch.float32))
        if op == "int4_matmul":
            def run(plan=None):
                return i4.int4_matmul_fused_cuda(x, w_km, w_scale, plan=plan)
            plain = i4.int4_matmul_fused_plain(x, w_km, w_scale)
        elif op == "gemm.lut4":
            def run(plan=None):
                return l4.lut4_matmul_cuda(a_q, a_scale, w_km, w_scale,
                                           plan=plan)
            plain = l4.lut4_matmul_plain(a_q, a_scale, w_km, w_scale)
        else:
            def run(plan=None):
                return w16.w4a16_matmul_cuda(x, w_km, w_scale, G, plan=plan)
            plain = w16.w4a16_matmul_plain(x, w_km, w_scale, G)

        def held(got, entry, op=op, plain=plain):
            if op == "w4a16_matmul":
                err = (got - plain).abs().max().item()
                assert err <= 1e-4 * plain.abs().max().item(), (op, entry,
                                                                err)
            else:
                assert torch.equal(got, plain), (op, M, entry)

        timed = []

        def timer(fn, held=held):
            us = autotune._default_timer(fn)
            held(fn(), fn.entry)
            timed.append(fn.entry)
            return us

        def make_call(entry, run=run):
            def call():
                return run(entry)
            call.entry = entry
            return call

        best, us = autotune.tune(op, make_call, M, K, N, dtype, group_size=G,
                                 timer=timer, path=path)
        assert us < float("inf") and best in timed
        autotune.reset()
        assert autotune.load_cache(path) >= 1
        assert autotune.lookup(op, M, K, N, dtype, G) == best
        held(run(), best)
