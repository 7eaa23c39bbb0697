"""Rules for test-claim honesty and metrics-label cardinality.

``tolerance-claim-mismatch``: the repo's twin contract is *bit-identity* —
the integer GEMM kernels equal their plain versions bit for bit,
checkpoint restores round-trip exactly, and the serving compare modes
assert token identity.  A test whose name/docstring claims exactness but
asserts a tolerance is quietly weaker than the contract it documents: a
twin that drifts by 1 ulp would still pass.  Such tests must assert
exactly (or justify the tolerance inline).  Inexact: numpy's
``assert_allclose``, ``torch.allclose`` and ``torch.testing.assert_close``
with its default or a non-zero tolerance.  Exact: numpy's
``assert_array_equal``, ``torch.equal`` and ``assert_close(...,
rtol=0, atol=0)``.

``metrics-label-hygiene``: every label on the ``MetricsRegistry`` keys a
new time series.  The outcome taxonomy (``ok|cancelled|timeout|shed|
error``) and the dispatch labels stay useful only while their cardinality
is closed — a label value built from an f-string or ``str(x)`` can mint
unbounded series (one per rid, one per shape...) and silently blow up the
registry and every dashboard on it.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional

from repro_torch.analysis.core import Finding, SourceFile, dotted_name, rule

# --------------------------------------------- tolerance-claim-mismatch ----
#: exactness language in a test's name/docstring that makes assert_allclose
#: a contract violation
EXACT_CLAIM_RE = re.compile(
    r"bit[\s_-]?ident|bit[\s_-]?exact|bitwise|bit[\s_-]?for[\s_-]?bit"
    r"|identical|round[\s_-]?trip|restore",
    re.IGNORECASE)


def _is_test_file(sf: SourceFile) -> bool:
    parts = sf.rel.split("/")
    return "tests" in parts[:-1] or parts[-1].startswith("test_")


def _inexact_assert(call: ast.Call) -> Optional[str]:
    """The name of an assert that admits a tolerance, else None: numpy's
    ``assert_allclose``, ``torch.allclose``, and ``assert_close`` unless
    both ``rtol`` and ``atol`` are the literal 0."""
    name = dotted_name(call.func)
    if name.endswith("assert_allclose") or name == "torch.allclose":
        return name
    if name.endswith("assert_close"):
        tol = {kw.arg: kw.value for kw in call.keywords
               if kw.arg in ("rtol", "atol")}
        if len(tol) == 2 and all(isinstance(v, ast.Constant)
                                 and v.value == 0 for v in tol.values()):
            return None
        return name
    return None


@rule("tolerance-claim-mismatch",
      "a tolerance assert (assert_allclose, torch.allclose, assert_close) "
      "in a test whose name/docstring claims bit-identity / exact "
      "round-trips — the twin contract is exact, assert it exactly")
def check_tolerance_claims(sf: SourceFile) -> Iterable[Finding]:
    if not _is_test_file(sf):
        return
    tree = sf.tree
    assert tree is not None
    yield from _visit_scope(sf, tree, context="")


def _visit_scope(sf: SourceFile, scope: ast.AST,
                 context: str) -> Iterable[Finding]:
    for node in getattr(scope, "body", []):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            ctx = f"{node.name} {ast.get_docstring(node) or ''}"
            yield from _visit_scope(sf, node, ctx)
        else:
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                name = _inexact_assert(call)
                if name is None:
                    continue
                if EXACT_CLAIM_RE.search(context):
                    yield Finding(
                        rule="tolerance-claim-mismatch", path=sf.rel,
                        line=call.lineno, col=call.col_offset,
                        message="test claims exactness (name/docstring "
                                "says bit-identical/round-trip/restore) "
                                f"but asserts {name.split('.')[-1]}: use "
                                "np.testing.assert_array_equal / "
                                "torch.equal, or justify the tolerance "
                                "with an inline suppression")


# ------------------------------------------------- metrics-label-hygiene ----
_REGISTRY_METHODS = {"counter", "gauge", "histogram"}
#: kwargs of the registry methods that are not labels
_NON_LABEL_KWARGS = {"buckets"}
#: the typed request-outcome taxonomy (serving/scheduler.py, the same in
#: both packages); 'preempted' is a trace-span outcome, not a metrics label
OUTCOME_VALUES = {"ok", "cancelled", "timeout", "shed", "error"}


def _closed_value(node: ast.AST) -> bool:
    """Literal, named constant, or attribute chain (enum member / field
    constrained elsewhere): closed cardinality.  Anything constructed at
    call time (f-string, concat, str(), %-format, subscript) is open."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Name, ast.Attribute)):
        return True
    if isinstance(node, ast.IfExp):
        return _closed_value(node.body) and _closed_value(node.orelse)
    return False


@rule("metrics-label-hygiene",
      "MetricsRegistry label values must come from closed enums — "
      "dynamically formatted labels mint unbounded time series")
def check_metric_labels(sf: SourceFile) -> Iterable[Finding]:
    tree = sf.tree
    assert tree is not None
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _REGISTRY_METHODS:
            continue
        # shape filter: registry methods take (name, help, **labels) with a
        # literal metric name — a non-registry .counter() (e.g. a dict of
        # collections.Counter) won't match the two-leading-string shape
        if len(node.args) < 2:
            continue
        if not all(isinstance(a, ast.Constant) and isinstance(a.value, str)
                   for a in node.args[:2]):
            # computed name + literal help string: still clearly the
            # registry shape, so the computed name itself is the bug.
            # Anything else (e.g. collections.Counter-ish .counter(key, 5))
            # is not a registry call — out of scope.
            if not isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                yield Finding(
                    rule="metrics-label-hygiene", path=sf.rel,
                    line=node.args[0].lineno, col=node.args[0].col_offset,
                    message="metric name must be a string literal: a "
                            "computed name is an unbounded metric "
                            "namespace")
            continue
        for kw in node.keywords:
            if kw.arg is None:
                yield Finding(
                    rule="metrics-label-hygiene", path=sf.rel,
                    line=node.lineno, col=node.col_offset,
                    message="**splat labels on a registry metric cannot "
                            "be cardinality-checked — pass labels "
                            "explicitly from closed enums")
                continue
            if kw.arg in _NON_LABEL_KWARGS:
                continue
            if not _closed_value(kw.value):
                yield Finding(
                    rule="metrics-label-hygiene", path=sf.rel,
                    line=kw.value.lineno, col=kw.value.col_offset,
                    message=f"label '{kw.arg}' is built at call time "
                            f"(f-string/format/str()): label values must "
                            f"come from closed enums or literals — every "
                            f"distinct value is a new time series")
            elif kw.arg == "outcome" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value not in OUTCOME_VALUES:
                yield Finding(
                    rule="metrics-label-hygiene", path=sf.rel,
                    line=kw.value.lineno, col=kw.value.col_offset,
                    message=f"outcome label {kw.value.value!r} is not in "
                            f"the typed taxonomy "
                            f"{sorted(OUTCOME_VALUES)} — extend the "
                            f"taxonomy deliberately or fix the typo")
