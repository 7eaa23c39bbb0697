"""Recompile sentinel: count step-shape captures per step function (a copy
of ``repro/observability/jit_watch.py``; stdlib only).

In the JAX package every bucket shape of a serving step compiles once
(ideally during warmup) and every later step replays the cached
executable.  In the port a "compile" is a CUDA-graph capture of a step
shape (``launch.steps.CapturedStep``): the first call of a shape runs the
step eagerly and captures it, every later call replays the graph.  A silent
re-capture -- a shape key that drifts between calls of the same bucket --
costs an eager step plus a capture and still produces correct tokens, so
nothing catches it unless captures are counted.

Mechanism: each registered step exposes ``_cache_size()`` (the number of
captured graphs, as a jit exposes its cached executables).
``after_call(name, shape)`` takes the delta since the previous poll and
attributes it to the shape key of the call that just ran:

  * delta > 0, shape never seen       -> a *new-bucket compile* (expected:
    warmup, or a mid-run bucket first hit).  Counted in
    ``jit_compiles_total{fn=...}``.
  * delta > 0, shape seen before      -> a *steady-state recompile* -- the
    loud failure mode.  Counted in
    ``jit_recompiles_steady_state_total{fn=...}`` and, under
    ``strict=True`` (tests), raised as ``RecompileError`` on the spot with
    the triggering fn/shape/step.

Fallback: when the callable doesn't expose ``_cache_size`` (the eager
steps on the CPU, a stub), shape-key novelty approximates the delta -- new
shapes count as compiles, and steady-state detection degrades to
never-fires rather than false-fires.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .metrics import NULL_REGISTRY

#: events kept verbatim in snapshots (full history stays in self.events)
_SNAPSHOT_EVENTS = 32


class RecompileError(RuntimeError):
    """A registered step function recompiled for an already-seen shape."""


class JitWatch:
    def __init__(self, registry=None, strict: bool = False):
        self.registry = registry if registry is not None else NULL_REGISTRY
        self.strict = strict
        self._fns: Dict[str, object] = {}
        self._last: Dict[str, int] = {}
        self._seen: Dict[str, set] = {}
        self.by_fn: Dict[str, int] = {}
        self.events: List[Dict] = []
        self.total = 0
        self.steady_state = 0

    @property
    def enabled(self) -> bool:
        return True

    # ---------------------------------------------------------- plumbing --
    def _size(self, name: str) -> Optional[int]:
        try:
            return int(self._fns[name]._cache_size())
        except (AttributeError, TypeError):
            return None

    def register(self, name: str, fn) -> None:
        """Start watching a step callable.  Safe to call with fn=None (a
        step a configuration does not have is just skipped)."""
        if fn is None:
            return
        self._fns[name] = fn
        self._last[name] = self._size(name) or 0
        self._seen[name] = set()
        self.by_fn.setdefault(name, 0)

    def absorb(self, name: Optional[str] = None) -> None:
        """Re-baseline cache sizes without counting -- for calls the engine
        makes outside the serving loop, whose captures must not masquerade
        as the next real step's recompile."""
        for n in ([name] if name else list(self._fns)):
            self._last[n] = self._size(n) or self._last[n]

    # ------------------------------------------------------------- polling --
    def after_call(self, name: str, shape, step: Optional[int] = None) -> int:
        """Attribute any cache growth since the last poll to the call that
        just ran (`shape` is its bucket signature).  Returns the delta."""
        if name not in self._fns:
            return 0
        shape = tuple(int(s) for s in shape)
        seen = self._seen[name]
        first = shape not in seen
        seen.add(shape)
        size = self._size(name)
        if size is None:                       # no cache API: novelty proxy
            delta = 1 if first else 0
        else:
            delta = size - self._last[name]
            self._last[name] = size
        if delta <= 0:
            return 0
        self.total += delta
        self.by_fn[name] = self.by_fn.get(name, 0) + delta
        self.registry.counter(
            "jit_compiles_total",
            "step-shape captures per step function", fn=name).inc(delta)
        event = {"fn": name, "shape": list(shape), "step": step,
                 "steady_state": not first}
        self.events.append(event)
        if not first:
            self.steady_state += delta
            self.registry.counter(
                "jit_recompiles_steady_state_total",
                "recaptures for already-seen bucket shapes (should be 0)",
                fn=name).inc(delta)
            if self.strict:
                raise RecompileError(
                    f"steady-state recompile: {name} recompiled for "
                    f"already-seen shape {shape} at step {step} "
                    f"(+{delta} cache entries)")
        return delta

    # ------------------------------------------------------------- export --
    def snapshot(self) -> Dict:
        return {
            "total": self.total,
            "steady_state": self.steady_state,
            "by_fn": dict(self.by_fn),
            "events": self.events[-_SNAPSHOT_EVENTS:],
        }


class NullJitWatch:
    """Telemetry-off sentinel: records nothing, never raises."""

    enabled = False
    strict = False
    total = 0
    steady_state = 0

    def register(self, name, fn):
        pass

    def absorb(self, name=None):
        pass

    def after_call(self, name, shape, step=None):
        return 0

    def snapshot(self):
        return {"total": 0, "steady_state": 0, "by_fn": {}, "events": []}


NULL_JIT_WATCH = NullJitWatch()
