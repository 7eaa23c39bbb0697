"""Contract-aware static analysis for the PyTorch port.

``python -m repro_torch.analysis [paths] [--baseline analysis_baseline_torch.json]``

The port's guarantees are written in its docstrings: a serving step is
captured once per shape and replayed, a step reads exactly one value back
to the host, a kernel wrapper refuses what its kernel cannot take, and
dispatch follows the tensor's device and nothing else.  This package
checks them on the AST, with no torch import and no device, as
``repro.analysis`` checks the JAX package's (it imports nothing of that
package: ``core.py`` is a copy, so the suppression marker, fingerprints and
baseline format are the same).

Enforced contracts (one rule each — ``--list-rules`` for the live list):

``capture-hazard``
    On ``cuda`` the engine's steps are ``launch/steps.py::CapturedStep``s:
    one CUDA graph per step shape, then replays.  A ``CapturedStep``,
    ``torch.cuda.CUDAGraph`` or ``torch.compile`` built inside a loop, or
    built and called in one expression, captures (or compiles) on every
    pass; a Python scalar or a shape-derived value passed into a step
    attribute (``_prefill``, ``_prefill_tail``, ``_decode``, ``_ragged``)
    is a value the graphs cannot key on or hold.  The static twin of the
    capture sentinel (``observability/jit_watch.py``), the port's
    ``recompile-hazard``.

``captured-output-reuse``
    A replay returns the graph's static output, which the shape's next
    replay overwrites in place.  Reading a name bound from a step's result
    after a second call of the same step, with no copy (``.clone()``,
    ``.cpu()``, ``np.asarray``) in between, is flagged.  The port's
    ``donation-use-after-transfer``.

``host-sync-in-hot-path``
    A steady-state engine step budgets exactly ONE device->host transfer:
    the int32-per-row token readback.  ``.cpu()``, ``.numpy()``,
    ``.item()``, ``.tolist()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
    and ``np.asarray`` / ``int()`` / ``float()`` / ``bool()`` of a device
    value anywhere else inside the per-step functions (``_step_*``,
    ``_ragged_exec``, ``_decode_batch``, ``_prefill_request``,
    ``_warm_ragged``) are flagged; the sanctioned readbacks carry inline
    suppressions so the budget is visible in the diff.

``cuda-kernel-hygiene``
    A function that launches a kernel (``_build.load``, then a call on the
    library) checks its operands first: a ``check_*`` call or an
    ``if ...: raise`` on shape, dtype, device or contiguity.  Dispatch by
    device (an ``if`` on ``.device.type``, ``.is_cuda`` or
    ``torch.cuda.is_available()`` that does not raise) belongs to
    ``kernels/ops.py::_on_cuda`` only.  A ``try`` around a launch whose
    handler runs a plain version is flagged: a kernel raises, it never
    falls back.

``tolerance-claim-mismatch``
    A test whose name/docstring claims bit-identity / exact round-trips
    must assert exactly: ``np.testing.assert_array_equal``,
    ``torch.equal`` or ``assert_close(..., rtol=0, atol=0)``, not
    ``assert_allclose``, ``torch.allclose`` or a tolerant ``assert_close``.

``metrics-label-hygiene``
    ``MetricsRegistry`` label values must come from closed enums/literals;
    call-time-formatted values (f-strings, ``str(x)``) mint unbounded time
    series.  Literal ``outcome=`` labels must be in the typed
    ``ok|cancelled|timeout|shed|error`` taxonomy.

Suppressing a finding
---------------------
Append ``# repro: ignore[rule-name]  -- why this line is sanctioned`` to
the flagged line (or put it on a comment-only line directly above).  The
marker is the JAX package's, so one marker holds for both analyzers.
``# repro: ignore`` with no bracket suppresses every rule on that line.

Baseline workflow
-----------------
``analysis_baseline_torch.json`` (repo root) holds the port's accepted
findings keyed by a fingerprint of (rule, path, source line), each with its
justification.  The gate (a tier-1 test and a phase of ``chip_smoke.py``)::

    python -m repro_torch.analysis --baseline analysis_baseline_torch.json

fails only on findings NOT in the baseline.  After fixing a baselined
violation (or accepting a new one — rare, justify it), re-baseline with::

    python -m repro_torch.analysis --baseline analysis_baseline_torch.json --write-baseline

which prunes stale entries, keeps existing justifications, and stamps new
entries with a TODO justification a reviewer is expected to replace.
"""

from repro_torch.analysis.core import (
    Finding,
    Rule,
    SourceFile,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    gate,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.cli import main

__all__ = [
    "Finding",
    "Rule",
    "SourceFile",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "gate",
    "load_baseline",
    "main",
    "write_baseline",
]
