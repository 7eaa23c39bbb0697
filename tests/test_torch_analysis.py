"""Golden-fixture suite for the port's contract analyzer
(``repro_torch.analysis``), the twin of ``tests/test_analysis.py``.

Each rule gets at least one known-bad snippet that must fire and one clean
twin that must not; the framework tests (suppression markers, baseline
add/remove semantics, fingerprint stability, the CLI) run on the same
kind of fixtures as the reference's.  Then the cross-checks with the JAX
package's analyzer: its framework-neutral rules give the reference's
findings over ``src`` and ``tests`` finding for finding, each analyzer
reads the other's baseline file to the same entries, the port's gate over
its default paths is clean against ``analysis_baseline_torch.json``, and
the analyzer imports none of torch, jax and repro.

The snippets are *fixtures*, not live code — they model the idioms the
rules were calibrated against (engine step attributes, ``CapturedStep``,
ctypes kernel wrappers, the metrics registry call shape).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import (
    all_rules,
    analyze_paths,
    analyze_source,
    gate,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.cli import DEFAULT_PATHS, main as cli_main

ROOT = Path(__file__).resolve().parent.parent
REPO_SRC = str(ROOT / "src")
#: the two rules whose contracts are framework-neutral (same in both
#: analyzers)
NEUTRAL_RULES = ("tolerance-claim-mismatch", "metrics-label-hygiene")


def run(src: str, rel: str = "src/repro_torch/serving/mod.py",
        only: str = None):
    rules = all_rules()
    if only is not None:
        rules = {only: rules[only]}
    return analyze_source(textwrap.dedent(src), rel, rules)


def rules_of(findings):
    return [f.rule for f in findings]


def test_rule_set():
    assert set(all_rules()) == {
        "capture-hazard", "captured-output-reuse", "host-sync-in-hot-path",
        "cuda-kernel-hygiene", "tolerance-claim-mismatch",
        "metrics-label-hygiene"}


# ------------------------------------------------------ capture-hazard ----
def test_capture_hazard_build_and_invoke_fires():
    bad = """
    import torch
    from repro_torch.launch.steps import CapturedStep
    def f(fn, x, args):
        y = torch.compile(fn)(x)
        return CapturedStep(fn, "cuda", cap, graph)(*args), y
    """
    fs = run(bad, only="capture-hazard")
    assert rules_of(fs) == ["capture-hazard"] * 2
    assert all("built and called in one expression" in f.message for f in fs)


def test_capture_hazard_build_in_loop_fires():
    bad = """
    import torch
    def f(fns, x):
        for fn in fns:
            g = torch.cuda.CUDAGraph()
            step = CapturedStep(fn, "cuda", cap, torch.cuda.CUDAGraph)
            x = step(x)
        return x
    """
    fs = run(bad, only="capture-hazard")
    assert rules_of(fs) == ["capture-hazard"] * 2
    assert all("inside a loop" in f.message for f in fs)


def test_capture_hazard_host_scalar_into_step_fires():
    bad = """
    class Engine:
        def go(self, params, batch, toks):
            nxt, self.caches = self._decode(params, len(batch), self.caches,
                                            toks.shape[0], self._tbl, 3)
            return nxt
    """
    fs = run(bad, only="capture-hazard")
    assert rules_of(fs) == ["capture-hazard"] * 3
    assert "'self._decode'" in fs[0].message and "arg 1" in fs[0].message
    assert "arg 3" in fs[1].message and "arg 5" in fs[2].message


def test_capture_hazard_clean_twin():
    # device tensors into the step attribute, one CapturedStep built at
    # init and called with tensors: all sanctioned
    clean = """
    import torch

    class Engine:
        def __init__(self, fn):
            self._prefill = CapturedStep(fn, "cuda", cap, torch.cuda.CUDAGraph)

        def go(self, params, toks, pos, slots):
            nxt, self.caches = self._prefill(params, self._in(toks),
                                             self.caches, self._in(pos),
                                             self._tbl, self._in(slots))
            return nxt
    """
    assert run(clean, only="capture-hazard") == []


def test_capture_hazard_tensor_kwarg_clean_scalar_kwarg_fires():
    src = """
    import torch
    step = CapturedStep(fn, "cuda", cap, graph)
    def g(x, rows, batch):
        a = step(x, emit_rows=torch.as_tensor(rows))
        b = step(x, emit_rows=len(batch))
        return a, b
    """
    fs = run(src, only="capture-hazard")
    assert rules_of(fs) == ["capture-hazard"]
    assert "kwarg 'emit_rows'" in fs[0].message and "'step'" in fs[0].message


# ------------------------------------------------ captured-output-reuse ----
def test_output_reuse_read_after_second_call_fires():
    bad = """
    class Engine:
        def go(self, params, a, b):
            first, self.caches = self._decode(params, a, self.caches)
            second, self.caches = self._decode(params, b, self.caches)
            return first, second
    """
    fs = run(bad, only="captured-output-reuse")
    assert rules_of(fs) == ["captured-output-reuse"]
    assert "'first'" in fs[0].message and "'self._decode'" in fs[0].message


def test_output_reuse_copy_before_next_call_clean():
    # the engine idiom: each step's tokens reach the host before the next
    # call; the caches the step returns are the caller's own storage
    clean = """
    import numpy as np
    class Engine:
        def go(self, params, a, b):
            first, self.caches = self._decode(params, a, self.caches)
            first = np.asarray(first.cpu())
            kept, self.caches = self._decode(params, b, self.caches)
            kept = kept.clone()
            second, self.caches = self._decode(params, first, self.caches)
            return first, kept, second, self.caches
    """
    assert run(clean, only="captured-output-reuse") == []


def test_output_reuse_local_captured_step_fires():
    bad = """
    def go(fn, params, xs, caches):
        step = CapturedStep(fn, "cuda", cap, graph)
        out = step(params, xs[0], caches)
        out2 = step(params, xs[1], caches)
        return out[0] + out2[0]
    """
    fs = run(bad, only="captured-output-reuse")
    assert rules_of(fs) == ["captured-output-reuse"]
    assert "'out'" in fs[0].message and "'step'" in fs[0].message


def test_output_reuse_one_finding_per_binding():
    bad = """
    class Engine:
        def go(self, params, a, b):
            first, self.caches = self._ragged(params, a, self.caches)
            other, self.caches = self._ragged(params, b, self.caches)
            x = first[0]
            y = first[1]
            return x, y, other
    """
    # overwritten output read twice -> flag the first read only (one
    # finding per binding), not a cascade down the function
    fs = run(bad, only="captured-output-reuse")
    assert len(fs) == 1


# ------------------------------------------------ host-sync-in-hot-path ----
def test_host_sync_in_hot_fn_fires():
    bad = """
    class Engine:
        def _decode_batch(self, batch):
            logits = self.run(batch)
            probs = logits.cpu()
            return probs
    """
    fs = run(bad, only="host-sync-in-hot-path")
    assert rules_of(fs) == ["host-sync-in-hot-path"]
    assert "_decode_batch" in fs[0].message and ".cpu()" in fs[0].message


def test_host_sync_item_and_float_fire():
    bad = """
    import torch
    class Engine:
        def _step_decode(self, x):
            a = x.item()
            b = float(x)
            c = x.to("cpu")
            torch.cuda.synchronize()
            return a + b + c.numpy()
    """
    fs = run(bad, only="host-sync-in-hot-path")
    assert len(fs) == 4            # c.numpy() is of a host value: clean


def test_host_sync_cold_fn_clean():
    # same syncs outside a hot-path function: not the rule's business
    clean = """
    import numpy as np
    class Engine:
        def snapshot(self, x):
            return np.asarray(x.cpu()), x.item()
    """
    assert run(clean, only="host-sync-in-hot-path") == []


def test_host_sync_host_values_clean():
    # len/int/np-constructed values are already host: no transfer to flag
    clean = """
    import numpy as np
    import torch
    class Engine:
        def _decode_batch(self, batch):
            n = len(batch)
            m = int(n)
            z = np.asarray([1, 2, 3])
            t = torch.from_numpy(z).to(self.device)
            return m + z[0].item(), t
    """
    assert run(clean, only="host-sync-in-hot-path") == []


def test_host_sync_result_is_host_downstream():
    # the engine idiom: ONE flagged readback, then int() over the now-host
    # array must NOT cascade into more findings
    bad = """
    import numpy as np
    class Engine:
        def _decode_batch(self, batch, nxt):
            nxt = np.asarray(nxt.cpu())
            for i, req in enumerate(batch):
                req.tokens.append(int(nxt[i]))
            return batch
    """
    fs = run(bad, only="host-sync-in-hot-path")
    assert len(fs) == 1
    assert fs[0].text == "nxt = np.asarray(nxt.cpu())"


# -------------------------------------------------- cuda-kernel-hygiene ----
KERNEL_REL = "src/repro_torch/kernels/fixture_kernel.py"


def test_launch_without_operand_check_fires():
    bad = """
    from . import _build

    def fixture_cuda(a, b):
        out = torch.empty_like(a)
        lib = _build.load("fixture", _bind)
        code = lib.fixture_launch(_build.ptr(a), _build.ptr(b),
                                  _build.ptr(out), a.numel())
        _build.check(lib, code, "fixture")
        return out
    """
    fs = run(bad, rel=KERNEL_REL, only="cuda-kernel-hygiene")
    assert rules_of(fs) == ["cuda-kernel-hygiene"]
    assert "no operand check" in fs[0].message
    assert fs[0].text.startswith("code = lib.fixture_launch(")
    chained = """
    from . import _build

    def fixture_floor_cuda(a):
        _build.load("fixture", _bind).floor_launch(_build.ptr(a))
    """
    fs = run(chained, rel=KERNEL_REL, only="cuda-kernel-hygiene")
    assert rules_of(fs) == ["cuda-kernel-hygiene"]


def test_launch_after_check_call_clean():
    clean = """
    from . import _build
    from .int4_matmul import check_w4a4_operands

    def fixture_cuda(a_q, a_scale, w, w_scale):
        check_w4a4_operands("fixture_cuda", a_q, torch.int8, w, w_scale,
                            a_scale)
        lib = _build.load("fixture", _bind)
        _build.check(lib, lib.fixture_launch(_build.ptr(a_q)), "fixture")
    """
    assert run(clean, rel=KERNEL_REL, only="cuda-kernel-hygiene") == []


def test_launch_after_unrelated_raise_fires():
    # a raise that checks no operand (here the strategy name), or an
    # operand check after the launch, is not the contract
    bad = """
    from . import _build

    def fixture_cuda(a, b, strategy):
        if strategy not in ("onehot", "take"):
            raise ValueError(strategy)
        lib = _build.load("fixture", _bind)
        code = lib.fixture_launch(_build.ptr(a), _build.ptr(b))
        if a.dtype != torch.int8:
            raise TypeError(a.dtype)
        return code
    """
    fs = run(bad, rel=KERNEL_REL, only="cuda-kernel-hygiene")
    assert rules_of(fs) == ["cuda-kernel-hygiene"]
    assert "no operand check" in fs[0].message


def test_check_call_on_no_operand_fires():
    # lut_mul4_cuda's idiom: a check_* of the strategy name alone is not
    # the operand check; the one that counts names what the launch is
    # given, directly or through the names it was computed from
    bad = """
    from . import _build

    def fixture_cuda(a, b, strategy):
        _check_strategy(strategy)
        lib = _build.load("fixture", _bind)
        code = lib.fixture_launch(_build.ptr(a), _build.ptr(b))
        return code
    """
    fs = run(bad, rel=KERNEL_REL, only="cuda-kernel-hygiene")
    assert rules_of(fs) == ["cuda-kernel-hygiene"]
    assert "no operand check" in fs[0].message
    clean = """
    from . import _build

    def fixture_cuda(a, b, strategy):
        _check_strategy(strategy)
        check_mul4_operands("fixture_cuda", a, b)
        a2 = a.reshape(-1)
        lib = _build.load("fixture", _bind)
        code = lib.fixture_launch(_build.ptr(a2), _build.ptr(b))
        return code
    """
    assert run(clean, rel=KERNEL_REL, only="cuda-kernel-hygiene") == []


def test_try_fallback_to_plain_fires():
    bad = """
    def matmul(x, w, s):
        try:
            return int4_matmul_fused_cuda(x, w, s)
        except RuntimeError:
            return int4_matmul_fused_plain(x, w, s)
    """
    # anywhere in the tree, not only in kernel modules
    fs = run(bad, rel="src/repro_torch/core/qlinear.py",
             only="cuda-kernel-hygiene")
    assert rules_of(fs) == ["cuda-kernel-hygiene"]
    assert "falls back to the plain version" in fs[0].message


def test_device_dispatch_in_kernel_module_fires():
    bad = """
    import torch

    def fixture(x, w):
        if x.device.type == "cuda":
            return fixture_cuda(x, w)
        y = fixture_cuda(x, w) if x.is_cuda else fixture_plain(x, w)
        if torch.cuda.is_available():
            y = y.cuda()
        return y
    """
    fs = run(bad, rel=KERNEL_REL, only="cuda-kernel-hygiene")
    assert rules_of(fs) == ["cuda-kernel-hygiene"] * 3
    assert all("dispatch by device" in f.message for f in fs)


def test_wrapper_clean_twin():
    # the W4A4 idiom: an `if ...: raise` on operands before the launch, a
    # device test that raises, and a try that cleans up and re-raises
    clean = """
    import torch
    from . import _build

    def fixture_cuda(a, w):
        if not (a.is_cuda and w.device == a.device):
            raise ValueError("fixture_cuda: one CUDA device")
        if a.dtype != torch.int8 or not a.is_contiguous():
            raise TypeError("fixture_cuda: int8, contiguous")
        lib = _build.load("fixture", _bind)
        try:
            code = lib.fixture_launch(_build.ptr(a), _build.ptr(w))
        except OSError:
            lib.reset()
            raise
        _build.check(lib, code, "fixture")
    """
    assert run(clean, rel=KERNEL_REL, only="cuda-kernel-hygiene") == []


def test_device_dispatch_exempt_in_ops_build_autotune():
    src = """
    import torch
    def pick(t):
        if t.device.type == "cuda":
            return True
        return torch.cuda.is_available()
    """
    fs = run(src, rel=KERNEL_REL, only="cuda-kernel-hygiene")
    assert any("dispatch by device" in f.message for f in fs)
    for exempt in ("ops.py", "_build.py", "autotune.py"):
        assert run(src, rel=f"src/repro_torch/kernels/{exempt}",
                   only="cuda-kernel-hygiene") == []
    # outside kernels/ a device test is the module's own business (the
    # engine captures its steps on cuda)
    assert run(src, rel="src/repro_torch/serving/engine.py",
               only="cuda-kernel-hygiene") == []


# ---------------------------------------------- tolerance-claim-mismatch ----
TEST_REL = "tests/test_fixture.py"


def test_tolerance_claim_allclose_fires():
    bad = """
    import numpy as np
    def test_checkpoint_roundtrip():
        '''save/restore round-trips bit-identically.'''
        a, b = save_restore()
        np.testing.assert_allclose(a, b)
    """
    fs = run(bad, rel=TEST_REL, only="tolerance-claim-mismatch")
    assert rules_of(fs) == ["tolerance-claim-mismatch"]


def test_tolerance_claim_array_equal_clean():
    clean = """
    import numpy as np
    import torch
    def test_checkpoint_roundtrip():
        '''save/restore round-trips bit-identically.'''
        a, b = save_restore()
        np.testing.assert_array_equal(a, b)
        assert torch.equal(a, b)
    """
    assert run(clean, rel=TEST_REL, only="tolerance-claim-mismatch") == []


def test_tolerance_no_exactness_claim_clean():
    clean = """
    import numpy as np
    import torch
    def test_quant_error_small():
        '''quantized output stays close to float reference.'''
        a, b = compute()
        np.testing.assert_allclose(a, b, rtol=1e-5)
        torch.testing.assert_close(a, b)
        assert torch.allclose(a, b)
    """
    assert run(clean, rel=TEST_REL, only="tolerance-claim-mismatch") == []


def test_tolerance_rule_ignores_non_test_files():
    src = """
    import torch
    def check_roundtrip_identical(a, b):
        torch.testing.assert_close(a, b)
    """
    assert run(src, rel="src/repro_torch/core/check.py",
               only="tolerance-claim-mismatch") == []


@pytest.mark.parametrize("call,fires", [
    ("torch.allclose(a, b)", True),
    ("torch.testing.assert_close(a, b)", True),
    ("torch.testing.assert_close(a, b, rtol=0, atol=1e-6)", True),
    ("assert_close(a, b, rtol=0)", True),
    ("torch.testing.assert_close(a, b, rtol=0, atol=0)", False),
    ("torch.equal(a, b)", False),
])
def test_tolerance_claim_torch_forms(call, fires):
    src = f"""
    import torch
    from torch.testing import assert_close
    def test_kernel_bit_exact_vs_plain():
        a, b = run_both()
        assert {call} or True
    """
    fs = run(src, rel=TEST_REL, only="tolerance-claim-mismatch")
    assert rules_of(fs) == (["tolerance-claim-mismatch"] if fires else [])


# ------------------------------------------------- metrics-label-hygiene ----
def test_metrics_open_label_value_fires():
    bad = """
    def record(m, rid):
        m.counter("requests_total", "reqs", rid=f"req-{rid}").inc()
    """
    fs = run(bad, only="metrics-label-hygiene")
    assert rules_of(fs) == ["metrics-label-hygiene"]
    assert "built at call time" in fs[0].message


def test_metrics_outcome_typo_fires():
    bad = """
    def record(m):
        m.counter("requests_total", "reqs", outcome="canceled").inc()
    """
    fs = run(bad, only="metrics-label-hygiene")
    assert rules_of(fs) == ["metrics-label-hygiene"]
    assert "'canceled'" in fs[0].message


def test_metrics_computed_name_fires():
    bad = """
    def record(m, op):
        m.counter(f"{op}_total", "per-op").inc()
    """
    fs = run(bad, only="metrics-label-hygiene")
    assert rules_of(fs) == ["metrics-label-hygiene"]
    assert "string literal" in fs[0].message


def test_metrics_splat_labels_fire():
    bad = """
    def record(m, labels):
        m.counter("requests_total", "reqs", **labels).inc()
    """
    fs = run(bad, only="metrics-label-hygiene")
    assert rules_of(fs) == ["metrics-label-hygiene"]


def test_metrics_closed_labels_clean():
    # the port's registry calls: autotune's rejection counter, the
    # engine's outcome counter, a histogram with buckets
    clean = """
    def record(m, outcome, op):
        m.counter("requests_total", "reqs", outcome=outcome).inc()
        m.counter("requests_total", "reqs", outcome="timeout").inc()
        m.counter("autotune_tiles_rejected_total", "skipped", op=op).inc()
        m.histogram("ttft_us", "ttft", buckets=[1000, 10000]).observe(5)
    """
    assert run(clean, only="metrics-label-hygiene") == []


def test_metrics_non_registry_counter_not_matched():
    # collections.Counter-ish .counter()/.histogram() calls don't have the
    # (name, help, **labels) two-leading-string shape: out of scope
    clean = """
    def tally(counts, key):
        counts.counter(key)
        counts.histogram(key, 5)
    """
    assert run(clean, only="metrics-label-hygiene") == []


# ----------------------------------------------------------- suppressions ----
def test_suppression_same_line():
    src = """
    class Engine:
        def _decode_batch(self, nxt):
            nxt = nxt.cpu()  # repro: ignore[host-sync-in-hot-path]
            return nxt
    """
    assert run(src, only="host-sync-in-hot-path") == []


def test_suppression_preceding_comment_line():
    src = """
    class Engine:
        def _decode_batch(self, nxt):
            # repro: ignore[host-sync-in-hot-path] sanctioned readback
            nxt = nxt.cpu()
            return nxt
    """
    assert run(src, only="host-sync-in-hot-path") == []


def test_suppression_bare_marker_suppresses_all_rules():
    src = """
    class Engine:
        def _decode_batch(self, nxt):
            nxt = nxt.cpu()  # repro: ignore
            return nxt
    """
    assert run(src, only="host-sync-in-hot-path") == []


def test_suppression_wrong_rule_does_not_suppress():
    src = """
    class Engine:
        def _decode_batch(self, nxt):
            nxt = nxt.cpu()  # repro: ignore[capture-hazard]
            return nxt
    """
    fs = run(src, only="host-sync-in-hot-path")
    assert rules_of(fs) == ["host-sync-in-hot-path"]


def test_suppression_marker_in_string_does_not_suppress():
    # the marker is parsed from COMMENT tokens, not raw text
    src = '''
    class Engine:
        def _decode_batch(self, nxt):
            nxt = nxt.cpu(); note = "# repro: ignore"
            return nxt, note
    '''
    fs = run(src, only="host-sync-in-hot-path")
    assert rules_of(fs) == ["host-sync-in-hot-path"]


def test_engine_sanctioned_readbacks_suppressed_for_both_analyzers():
    """The port engine's three token readbacks carry the one marker; both
    analyzers see them suppressed, and without the marker this one sees
    each of them."""
    from repro.analysis import all_rules as ref_rules, analyze_source as ref

    rel = "src/repro_torch/serving/engine.py"
    text = (ROOT / rel).read_text()
    for analyze, rules in ((analyze_source, all_rules()),
                           (ref, ref_rules())):
        only = {"host-sync-in-hot-path": rules["host-sync-in-hot-path"]}
        assert analyze(text, rel, only) == []
    marked = [line for line in text.splitlines()
              if "repro: ignore[host-sync-in-hot-path]" in line]
    assert len(marked) == 3
    bare = text.replace("  # repro: ignore[host-sync-in-hot-path]", "")
    fs = analyze_source(bare, rel, {"host-sync-in-hot-path":
                                    all_rules()["host-sync-in-hot-path"]})
    assert sorted(f.text for f in fs) == sorted(
        line.split("  # repro")[0].strip() for line in marked)


# ------------------------------------------------- baseline + fingerprints ----
BAD_MODULE = textwrap.dedent("""
    import torch
    def f(fn, x):
        return torch.compile(fn)(x)
""")


def _write_tree(tmp_path, body=BAD_MODULE):
    pkg = tmp_path / "scratch"
    pkg.mkdir(exist_ok=True)
    (pkg / "mod.py").write_text(body)
    return pkg


def test_baseline_roundtrip_add_then_fix(tmp_path):
    pkg = _write_tree(tmp_path)
    bl_path = str(tmp_path / "baseline.json")

    findings = analyze_paths([str(pkg)], root=str(tmp_path))
    assert rules_of(findings) == ["capture-hazard"]

    # accept into baseline -> gate reports nothing new
    write_baseline(bl_path, findings)
    baseline = load_baseline(bl_path)
    new, known, stale = gate(findings, baseline)
    assert new == [] and len(known) == 1 and stale == []
    assert baseline[findings[0].fingerprint]["justification"] \
        == "TODO: justify or fix"

    # fix the violation -> entry goes stale; rewrite prunes it
    _write_tree(tmp_path, "def f(x):\n    return x\n")
    findings2 = analyze_paths([str(pkg)], root=str(tmp_path))
    new, known, stale = gate(findings2, load_baseline(bl_path))
    assert findings2 == [] and new == [] and stale != []
    write_baseline(bl_path, findings2, old=baseline)
    assert load_baseline(bl_path) == {}


def test_baseline_new_violation_still_fails(tmp_path):
    pkg = _write_tree(tmp_path)
    bl_path = str(tmp_path / "baseline.json")
    write_baseline(bl_path, analyze_paths([str(pkg)], root=str(tmp_path)))

    # a second, different hazard appears: baseline must not mask it
    (pkg / "mod.py").write_text(BAD_MODULE + textwrap.dedent("""
        def g(fns, x):
            for fn in fns:
                x = torch.compile(fn)(x)
            return x
    """))
    findings = analyze_paths([str(pkg)], root=str(tmp_path))
    new, known, stale = gate(findings, load_baseline(bl_path))
    assert len(known) == 1 and len(new) >= 1 and stale == []


def test_baseline_preserves_justification_on_rewrite(tmp_path):
    pkg = _write_tree(tmp_path)
    bl_path = str(tmp_path / "baseline.json")
    findings = analyze_paths([str(pkg)], root=str(tmp_path))
    write_baseline(bl_path, findings)
    baseline = load_baseline(bl_path)
    fp = findings[0].fingerprint
    baseline[fp]["justification"] = "profiling probe, captured once at boot"
    write_baseline(bl_path, findings, old=baseline)
    assert load_baseline(bl_path)[fp]["justification"] \
        == "profiling probe, captured once at boot"


def test_fingerprints_stable_under_line_drift(tmp_path):
    pkg = _write_tree(tmp_path)
    fp1 = analyze_paths([str(pkg)], root=str(tmp_path))[0].fingerprint
    # unrelated lines above shift the finding down: fingerprint unchanged
    _write_tree(tmp_path, "import os\n\nX = 1\n" + BAD_MODULE)
    fp2 = analyze_paths([str(pkg)], root=str(tmp_path))[0].fingerprint
    assert fp1 == fp2


def test_fingerprints_disambiguate_identical_lines(tmp_path):
    body = BAD_MODULE + textwrap.dedent("""
        def g(fn, x):
            return torch.compile(fn)(x)
    """)
    pkg = _write_tree(tmp_path, body)
    fs = analyze_paths([str(pkg)], root=str(tmp_path))
    assert len(fs) == 2
    assert fs[0].fingerprint != fs[1].fingerprint
    assert fs[0].fingerprint.endswith("|0") and fs[1].fingerprint.endswith("|1")


def test_syntax_error_reported_as_finding(tmp_path):
    pkg = _write_tree(tmp_path, "def broken(:\n")
    fs = analyze_paths([str(pkg)], root=str(tmp_path))
    assert rules_of(fs) == ["syntax-error"]


# ---------------------------------------------------------------- CLI ----
def test_cli_exit_codes_and_json(tmp_path, capsys):
    pkg = _write_tree(tmp_path)
    bl_path = str(tmp_path / "baseline.json")

    # unbaselined violation -> exit 1, json report carries it
    rc = cli_main([str(pkg), "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert report["counts"]["new"] == 1
    assert report["findings"][0]["rule"] == "capture-hazard"

    # accept, then gate passes -> exit 0
    assert cli_main([str(pkg), "--baseline", bl_path,
                     "--write-baseline"]) == 0
    capsys.readouterr()
    rc = cli_main([str(pkg), "--baseline", bl_path, "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["counts"]["new"] == 0 and report["counts"]["baselined"] == 1
    # --write-baseline without --baseline is a usage error
    assert cli_main([str(pkg), "--write-baseline"]) == 2


def test_cli_rules_filter_and_unknown_rule(tmp_path, capsys):
    pkg = _write_tree(tmp_path)
    rc = cli_main([str(pkg), "--rules", "metrics-label-hygiene"])
    capsys.readouterr()
    assert rc == 0                      # hazard rule filtered out
    with pytest.raises(SystemExit, match="no-such-rule"):
        cli_main([str(pkg), "--rules", "no-such-rule"])
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(f"{name}:" in listed for name in all_rules())


# ------------------------------------------------- against the reference ----
def test_repo_gates_clean_against_committed_baseline(capsys):
    """The port's gate (run by chip_smoke.py too): its default paths vs
    analysis_baseline_torch.json, with no stale entry, and every accepted
    finding justified."""
    assert DEFAULT_PATHS[0] == "src/repro_torch"
    assert all((ROOT / p).exists() for p in DEFAULT_PATHS)
    old = os.getcwd()
    os.chdir(ROOT)
    try:
        rc = cli_main(["--baseline", "analysis_baseline_torch.json",
                       "--format", "json"])
        report = json.loads(capsys.readouterr().out)
    finally:
        os.chdir(old)
    assert rc == 0, report["new"]
    assert report["counts"]["stale_baseline"] == 0
    entries = load_baseline(str(ROOT / "analysis_baseline_torch.json"))
    assert all("TODO" not in e["justification"] for e in entries.values())


def test_neutral_rules_match_the_reference_finding_for_finding():
    """Over src and tests, the port's tolerance and metrics rules give the
    JAX package's analyzer's findings: rule, path, line, fingerprint."""
    from repro.analysis import all_rules as ref_rules
    from repro.analysis import analyze_paths as ref_paths

    def key(fs):
        return [(f.rule, f.path, f.line, f.fingerprint) for f in fs]

    mine = {n: all_rules()[n] for n in NEUTRAL_RULES}
    theirs = {n: ref_rules()[n] for n in NEUTRAL_RULES}
    old = os.getcwd()
    os.chdir(ROOT)
    try:
        got = analyze_paths(["src", "tests"], rules=mine)
        want = ref_paths(["src", "tests"], rules=theirs)
    finally:
        os.chdir(old)
    assert key(got) == key(want)


def test_each_analyzer_reads_the_others_baseline(tmp_path):
    from repro.analysis import load_baseline as ref_load
    from repro.analysis import write_baseline as ref_write

    for name in ("analysis_baseline.json", "analysis_baseline_torch.json"):
        path = str(ROOT / name)
        assert load_baseline(path) == ref_load(path) != {}
    # written by either, read by the other to the same entries
    pkg = _write_tree(tmp_path)
    findings = analyze_paths([str(pkg)], root=str(tmp_path))
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    write_baseline(a, findings)
    ref_write(b, findings)
    assert Path(a).read_text() == Path(b).read_text()
    assert load_baseline(b) == ref_load(a)


def test_analyzer_does_not_import_torch_jax_or_repro(tmp_path):
    """The lint pass must run on a box with nothing installed: a seeded
    capture hazard is flagged from the AST alone, and importing/running
    the analyzer never pulls torch, jax or the JAX package into the
    process."""
    bad = tmp_path / "scratch_fixture.py"
    bad.write_text(BAD_MODULE)
    probe = (
        "import sys, json\n"
        "from repro_torch.analysis import analyze_paths\n"
        "fs = analyze_paths([sys.argv[1]])\n"
        "leaked = [m for m in ('torch', 'jax', 'repro', 'numpy')\n"
        "          if m in sys.modules]\n"
        "assert not leaked, f'analyzer imported {leaked}'\n"
        "print(json.dumps([f.rule for f in fs]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    out = subprocess.run([sys.executable, "-c", probe, str(bad)],
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == ["capture-hazard"]
