"""Analyzer framework: source model, rule registry, suppressions, baseline.

A copy of ``repro/analysis/core.py`` (the port imports nothing of the JAX
package): the same ``Finding``, ``SourceFile``, ``# repro: ignore[rule]``
marker, fingerprints and baseline format, so either analyzer reads the
other's baseline file to the same entries.  Zero-dependency (stdlib
``ast`` + ``tokenize`` only) so the lint job can run before torch is even
importable.  The moving parts:

  * ``SourceFile``   -- one parsed module: text, AST, and the per-line
                        suppression table parsed from ``# repro: ignore[...]``
                        comments (comments found via ``tokenize``, so the
                        marker inside a string literal does not suppress).
  * ``@rule(name)``  -- registers a check function ``(SourceFile) ->
                        Iterable[Finding]`` in the global registry.
  * ``analyze_paths``-- walk files, run rules, drop suppressed findings,
                        assign stable fingerprints.
  * baseline helpers -- load/gate/write the committed ``analysis_baseline
                        .json`` so only *new* violations fail CI.

Fingerprints are ``rule|path|<stripped source line>|<occurrence>`` — stable
under unrelated edits that shift line numbers, invalidated exactly when the
flagged line itself changes (which is when a human should re-look anyway).
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: suppression marker: ``# repro: ignore`` (all rules) or
#: ``# repro: ignore[rule-a,rule-b] optional justification``
SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")

BASELINE_VERSION = 1


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative, posix separators
    line: int          # 1-based
    col: int           # 0-based
    message: str
    text: str = ""     # stripped source line (fingerprint ingredient)
    fingerprint: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "fingerprint": self.fingerprint}


class SourceFile:
    """One parsed python module plus its suppression table."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines: List[str] = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:        # surfaced as a finding by the runner
            self.parse_error = e
        #: line -> None (all rules) | set of rule names
        self.suppressions: Dict[int, Optional[Set[str]]] = {}
        self._comment_only: Set[int] = set()
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                lineno = tok.start[0]
                if tok.line.strip().startswith("#"):
                    self._comment_only.add(lineno)
                m = SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                if m.group(1) is None:
                    self.suppressions[lineno] = None
                else:
                    names = {r.strip() for r in m.group(1).split(",")
                             if r.strip()}
                    prev = self.suppressions.get(lineno)
                    if prev is None and lineno in self.suppressions:
                        continue                      # already suppress-all
                    self.suppressions[lineno] = (names if prev is None
                                                 else prev | names)
        except (tokenize.TokenError, IndentationError):
            pass                                      # parse error reported

    def _line_suppresses(self, lineno: int, rule_name: str) -> bool:
        if lineno not in self.suppressions:
            return False
        names = self.suppressions[lineno]
        return names is None or rule_name in names

    def suppressed(self, lineno: int, rule_name: str) -> bool:
        """A finding on ``lineno`` is suppressed by a marker on the same
        line, or on a directly preceding comment-only line (for statements
        too long to carry the marker inline)."""
        if self._line_suppresses(lineno, rule_name):
            return True
        prev = lineno - 1
        return prev in self._comment_only and self._line_suppresses(
            prev, rule_name)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


# ------------------------------------------------------------- registry ----
CheckFn = Callable[[SourceFile], Iterable[Finding]]


@dataclass
class Rule:
    name: str
    summary: str
    check: CheckFn


RULES: Dict[str, Rule] = {}


def rule(name: str, summary: str) -> Callable[[CheckFn], CheckFn]:
    def deco(fn: CheckFn) -> CheckFn:
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name=name, summary=summary, check=fn)
        return fn
    return deco


def all_rules() -> Dict[str, Rule]:
    # import for side effect: rule modules self-register on first use
    from repro_torch.analysis import rules_capture  # noqa: F401
    from repro_torch.analysis import rules_hotpath  # noqa: F401
    from repro_torch.analysis import rules_quality  # noqa: F401
    return dict(RULES)


# ---------------------------------------------------------- AST helpers ----
def dotted_name(node: ast.AST) -> str:
    """``torch.compile`` / ``np.testing.assert_allclose`` / ``self.metrics.counter``
    as a dotted string; '' when the expression is not a plain name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def expr_key(node: ast.AST) -> str:
    """Stable key for the simple lvalue-ish expressions the capture rules
    track: a bare name or a short attribute chain (``self.caches``)."""
    name = dotted_name(node)
    return name if name and name.count(".") <= 2 else ""


def walk_statements(body: Sequence[ast.stmt]) -> Iterable[ast.stmt]:
    """Yield statements in source order, recursing through compound
    statements (a linear approximation of control flow that matches how the
    serving code is written: straight-line step bodies with shallow
    branches).  Nested function/class bodies are NOT entered — they execute
    on their own schedule and get their own pass."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, attr, None)
            if inner:
                yield from walk_statements(inner)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from walk_statements(handler.body)


def stmt_scan_roots(stmt: ast.stmt) -> List[ast.AST]:
    """The expression nodes a linear walk should scan for *this* statement:
    the whole node for simple statements, only the header expressions for
    compound ones (their bodies are yielded separately by
    ``walk_statements``, so scanning the full subtree would double-count)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def assigned_names(stmt: ast.stmt) -> Set[str]:
    """expr_key for every target this statement stores to."""
    out: Set[str] = set()

    def add_target(t: ast.AST) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add_target(e)
        elif isinstance(t, ast.Starred):
            add_target(t.value)
        else:
            key = expr_key(t)
            if key:
                out.add(key)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            add_target(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        add_target(stmt.target)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        add_target(stmt.target)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                add_target(item.optional_vars)
    return out


def int_constants(node: ast.AST) -> Tuple[int, ...]:
    """Integer literals inside a (possibly tuple/list) constant expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[int] = []
        for e in node.elts:
            out.extend(int_constants(e))
        return tuple(out)
    return ()


def str_constants(node: ast.AST) -> Tuple[str, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in node.elts:
            out.extend(str_constants(e))
        return tuple(out)
    return ()


# --------------------------------------------------------------- runner ----
def iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".") and d != "__pycache__")
            for n in sorted(names):
                if n.endswith(".py"):
                    files.append(os.path.join(root, n))
    return sorted(set(files))


def analyze_file(path: str, rel: Optional[str] = None,
                 rules: Optional[Dict[str, Rule]] = None) -> List[Finding]:
    rules = rules if rules is not None else all_rules()
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return analyze_source(text, rel if rel is not None else path, rules)


def analyze_source(text: str, rel: str,
                   rules: Optional[Dict[str, Rule]] = None) -> List[Finding]:
    rules = rules if rules is not None else all_rules()
    sf = SourceFile(rel, rel, text)
    if sf.parse_error is not None:
        e = sf.parse_error
        return [Finding(rule="syntax-error", path=sf.rel,
                        line=e.lineno or 1, col=(e.offset or 1) - 1,
                        message=f"file does not parse: {e.msg}")]
    out: List[Finding] = []
    for r in rules.values():
        for finding in r.check(sf):
            if not sf.suppressed(finding.line, finding.rule):
                finding.text = sf.line_text(finding.line)
                out.append(finding)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Dict[str, Rule]] = None,
                  root: Optional[str] = None) -> List[Finding]:
    rules = rules if rules is not None else all_rules()
    root = root or os.getcwd()
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        rel = os.path.relpath(path, root)
        findings.extend(analyze_file(path, rel=rel, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    assign_fingerprints(findings)
    return findings


def assign_fingerprints(findings: Sequence[Finding]) -> None:
    seen: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        key = (f.rule, f.path, f.text)
        n = seen.get(key, 0)
        seen[key] = n + 1
        f.fingerprint = f"{f.rule}|{f.path}|{f.text}|{n}"


# ------------------------------------------------------------- baseline ----
def load_baseline(path: str) -> Dict[str, Dict[str, str]]:
    """Baseline entries keyed by fingerprint.  Missing file = empty baseline
    (first run bootstraps with --write-baseline)."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict):
        return {}
    entries = data.get("entries", {})
    return entries if isinstance(entries, dict) else {}


def gate(findings: Sequence[Finding],
         baseline: Dict[str, Dict[str, str]]
         ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (new, known-baselined); also return the stale
    baseline fingerprints whose violations no longer exist (fixed — prune
    them with --write-baseline so they cannot mask future regressions)."""
    new: List[Finding] = []
    known: List[Finding] = []
    live = {f.fingerprint for f in findings}
    for f in findings:
        (known if f.fingerprint in baseline else new).append(f)
    stale = sorted(fp for fp in baseline if fp not in live)
    return new, known, stale


def write_baseline(path: str, findings: Sequence[Finding],
                   old: Optional[Dict[str, Dict[str, str]]] = None) -> None:
    """Persist current findings as the accepted baseline.  Justifications
    from surviving old entries are preserved; new entries get a placeholder
    a reviewer is expected to fill in."""
    old = old or {}
    entries: Dict[str, Dict[str, str]] = {}
    for f in sorted(findings, key=lambda f: f.fingerprint):
        prev = old.get(f.fingerprint, {})
        entries[f.fingerprint] = {
            "rule": f.rule,
            "path": f.path,
            "message": f.message,
            "justification": prev.get("justification",
                                      "TODO: justify or fix"),
        }
    payload = {"version": BASELINE_VERSION, "entries": entries}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
