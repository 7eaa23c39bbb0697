"""Rules for the captured-step contracts: capture hazards and the reuse of a
replay's output.

The serving engine's steps are built by ``launch/steps.py`` and stored on
attributes; on ``cuda`` each is a ``CapturedStep``, which captures one CUDA
graph per step shape and replays it.  That is a cross-module fact the AST
cannot see, so the engine contract is declared here: ``STEP_ATTRS`` names
the attributes that hold those steps.  Names bound in the analyzed module
from ``CapturedStep(...)`` count too.

Two facts of ``CapturedStep`` the rules lean on (``launch/steps.py``):

  * graphs are keyed on the shapes and dtypes of the tensors a step is
    given, and a graph holds tensors only: a Python scalar passed in is
    either refused or frozen into the graph at its first value;
  * a replay's result is the graph's static output, which the shape's next
    replay overwrites in place: a caller copies it (``.clone()``,
    ``.cpu()``, ``np.asarray``) before it calls the step again.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Set

from repro_torch.analysis.core import (
    Finding,
    SourceFile,
    assigned_names,
    dotted_name,
    expr_key,
    rule,
    stmt_scan_roots,
    walk_statements,
)

#: engine attributes that hold the steps built by launch/steps.py: on cuda
#: each is a CapturedStep (one graph per step shape)
STEP_ATTRS = ("_prefill", "_prefill_tail", "_decode", "_ragged")

#: what builds a new capture (and so a new set of graphs): the classes by
#: their own name, however imported, and torch.compile
_CAPTURE_CLASSES = ("CapturedStep", "CUDAGraph")


def _builds_capture(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name == "torch.compile" \
        or name.split(".")[-1] in _CAPTURE_CLASSES


def _collect_local_steps(tree: ast.AST) -> Set[str]:
    """Names assigned from a ``CapturedStep(...)`` call anywhere in the
    module."""
    steps: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and dotted_name(node.value.func).split(".")[-1] \
                == "CapturedStep":
            steps.update(k for t in node.targets for k in (expr_key(t),)
                         if k)
    return steps


def _step_key(call: ast.Call, local_steps: Set[str]) -> str:
    """The step a call runs (its attribute or local name), else ''."""
    key = expr_key(call.func)
    if key and key in local_steps:
        return key
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in STEP_ATTRS:
        return key or call.func.attr
    return ""


# -------------------------------------------------------- capture-hazard ----
_SCALAR_BUILTINS = {"len", "int", "float", "bool", "round", "min", "max",
                    "sum"}


def _is_host_scalar_expr(node: ast.AST) -> bool:
    """Python scalars and shape-derived host values: what a captured step
    cannot take (it keys graphs on tensors and holds tensors only)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, bool))
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in _SCALAR_BUILTINS
    if isinstance(node, ast.Attribute) and node.attr in ("shape", "ndim"):
        return True
    if isinstance(node, ast.Subscript):
        return _is_host_scalar_expr(node.value)
    if isinstance(node, ast.BinOp):
        return _is_host_scalar_expr(node.left) \
            or _is_host_scalar_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_host_scalar_expr(node.operand)
    return False


@rule("capture-hazard",
      "CapturedStep / CUDAGraph / torch.compile built per iteration or per "
      "call, and Python scalars or shape-derived values passed into a "
      "captured step — the static twin of the capture sentinel")
def check_capture_hazard(sf: SourceFile) -> Iterable[Finding]:
    tree = sf.tree
    assert tree is not None
    local_steps = _collect_local_steps(tree)

    loop_builds: Set[ast.Call] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            for stmt in node.body + node.orelse:
                for sub in ast.walk(stmt):
                    if _builds_capture(sub):
                        loop_builds.add(sub)

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _builds_capture(node.func):
            yield Finding(
                rule="capture-hazard", path=sf.rel,
                line=node.lineno, col=node.col_offset,
                message=f"{dotted_name(node.func.func)}(...) built and "
                        f"called in one expression: every execution "
                        f"captures (or compiles) anew; build it once and "
                        f"keep it")
        if node in loop_builds:
            yield Finding(
                rule="capture-hazard", path=sf.rel,
                line=node.lineno, col=node.col_offset,
                message=f"{dotted_name(node.func)}(...) built inside a "
                        f"loop: each iteration starts with no graphs and "
                        f"captures again; build it out of the loop")
        step = _step_key(node, local_steps)
        if not step:
            continue
        args = [(f"arg {i}", a) for i, a in enumerate(node.args)] \
            + [(f"kwarg '{kw.arg}'", kw.value) for kw in node.keywords
               if kw.arg is not None]
        for what, arg in args:
            if _is_host_scalar_expr(arg):
                yield Finding(
                    rule="capture-hazard", path=sf.rel,
                    line=arg.lineno, col=arg.col_offset,
                    message=f"Python scalar/shape-derived value passed into "
                            f"captured step '{step}' ({what}): its graphs "
                            f"are keyed on tensor shapes and hold tensors "
                            f"only — pass a device tensor")


# --------------------------------------------------- captured-output-reuse ----
@rule("captured-output-reuse",
      "a captured step's result read after the same step ran again — a "
      "replay's output is the graph's static buffer, overwritten by the "
      "next replay")
def check_captured_output_reuse(sf: SourceFile) -> Iterable[Finding]:
    tree = sf.tree
    assert tree is not None
    local_steps = _collect_local_steps(tree)
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from _check_function(sf, fn, local_steps)


def _output_targets(stmt: ast.stmt) -> Set[str]:
    """The names a step call's output is bound to: the first element of a
    tuple target (the second is the caches, the caller's own storage), or
    the whole target."""
    if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
        return set()
    t = stmt.targets[0]
    if isinstance(t, (ast.Tuple, ast.List)):
        t = t.elts[0] if t.elts else None
    key = expr_key(t) if t is not None else ""
    return {key} if key else set()


def _check_function(sf: SourceFile, fn: ast.AST,
                    local_steps: Set[str]) -> Iterable[Finding]:
    #: name -> step whose replay output it holds
    bound: Dict[str, str] = {}
    #: name -> line of the call that overwrote its buffer
    stale: Dict[str, int] = {}
    for stmt in walk_statements(getattr(fn, "body", [])):
        roots = stmt_scan_roots(stmt)
        # 1) reads of outputs that a later call of their step overwrote
        if stale:
            for root in roots:
                for node in ast.walk(root):
                    if not isinstance(node, (ast.Name, ast.Attribute)) \
                            or not isinstance(getattr(node, "ctx", None),
                                              ast.Load):
                        continue
                    key = expr_key(node)
                    if key in stale:
                        yield Finding(
                            rule="captured-output-reuse", path=sf.rel,
                            line=node.lineno, col=node.col_offset,
                            message=f"'{key}' holds the output of "
                                    f"'{bound[key]}', which ran again at "
                                    f"line {stale[key]}: a replay "
                                    f"overwrites its static output — copy "
                                    f"it (.clone(), .cpu()) before the "
                                    f"next call")
                        del stale[key]          # one finding per binding
                        del bound[key]
        # 2) a call of a step overwrites the outputs of its earlier calls
        for root in roots:
            for node in ast.walk(root):
                if isinstance(node, ast.Call):
                    step = _step_key(node, local_steps)
                    if step:
                        for name, s in bound.items():
                            if s == step and name not in stale:
                                stale[name] = node.lineno
        # 3) stores rebind; a step call's output binds its target
        for key in assigned_names(stmt):
            bound.pop(key, None)
            stale.pop(key, None)
        value = getattr(stmt, "value", None)
        if isinstance(value, ast.Call) and _step_key(value, local_steps):
            for key in _output_targets(stmt):
                bound[key] = _step_key(value, local_steps)
