"""Structured trace recorder: ring-buffered span events, Perfetto export.

Records the serving run as Chrome ``trace_event`` JSON — open the saved
file at https://ui.perfetto.dev (or chrome://tracing) and the run renders
as a timeline: one lane ("thread") per request slot showing request
residency segments with their admission prefills, plus an engine lane with
one span per ``step()`` carrying the step's batch composition in its args.

Design constraints, in order:

  * **Near-zero overhead when disabled.**  The disabled path is the
    ``NULL_TRACE`` singleton: every method is a constant-return no-op and
    ``span()`` hands back a reusable null context — no allocation, no
    branching at call sites.
  * **Bounded memory.**  Events land in a fixed-capacity ring; overflow
    overwrites the oldest event and bumps ``dropped`` (exported in the
    trace metadata so a truncated timeline says so).
  * **Monotonic timestamps.**  ``now()`` is microseconds since recorder
    creation from ``time.perf_counter`` — immune to wall-clock steps, and
    the natural unit of the ``ts``/``dur`` fields in the trace_event spec.

Event vocabulary (all standard trace_event phases):

  ``X`` complete span   -- ``complete(name, tid, t0)`` / ``span(...)`` ctx
  ``i`` instant         -- ``instant(name, tid)`` (scope "t")
  ``M`` metadata        -- lane names registered via ``lane(tid, name)``
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional


class TraceRecorder:
    """Fixed-capacity ring of trace_event dicts."""

    def __init__(self, capacity: int = 1 << 16, clock=time.perf_counter):
        assert capacity > 0
        self.capacity = capacity
        self._clock = clock
        self._t0 = clock()
        self._ev: List[Dict] = []
        self._head = 0                      # next overwrite slot when full
        self.dropped = 0
        self._lanes: Dict[tuple, str] = {}  # (pid, tid) -> lane name

    @property
    def enabled(self) -> bool:
        return True

    def now(self) -> float:
        """Microseconds since recorder creation (monotonic)."""
        return (self._clock() - self._t0) * 1e6

    def lane(self, tid: int, name: str, pid: int = 0) -> None:
        """Name a timeline lane (rendered as a thread name in Perfetto)."""
        self._lanes[(pid, tid)] = name

    # ------------------------------------------------------------- record --
    def _push(self, ev: Dict) -> None:
        if len(self._ev) < self.capacity:
            self._ev.append(ev)
        else:
            self._ev[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            self.dropped += 1

    def complete(self, name: str, tid: int, t0: float,
                 t1: Optional[float] = None, pid: int = 0, **args) -> None:
        """A span from t0 to t1 (default: now) on lane `tid`."""
        if t1 is None:
            t1 = self.now()
        ev = {"name": name, "ph": "X", "ts": t0, "dur": max(t1 - t0, 0.0),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, tid: int, pid: int = 0, **args) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "ts": self.now(),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    @contextlib.contextmanager
    def span(self, name: str, tid: int, pid: int = 0, **args):
        t0 = self.now()
        try:
            yield
        finally:
            self.complete(name, tid, t0, pid=pid, **args)

    # ------------------------------------------------------------- export --
    def events(self) -> List[Dict]:
        """Recorded events, oldest first (ring unrolled)."""
        return self._ev[self._head:] + self._ev[:self._head]

    def to_chrome(self) -> Dict:
        """The full Chrome/Perfetto ``trace_event`` JSON object."""
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": name}}
                for (pid, tid), name in sorted(self._lanes.items())]
        meta += [{"name": "thread_sort_index", "ph": "M", "pid": pid,
                  "tid": tid, "args": {"sort_index": tid}}
                 for (pid, tid) in sorted(self._lanes)]
        return {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "capacity": self.capacity},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class NullTrace:
    """Disabled recorder: no-op twin of TraceRecorder (the default — span
    call sites in the engine hot loop cost one attribute lookup and a
    null-context enter/exit)."""

    enabled = False
    dropped = 0
    _NULL_CTX = contextlib.nullcontext()

    def now(self) -> float:
        return 0.0

    def lane(self, tid, name, pid=0):
        pass

    def complete(self, name, tid, t0, t1=None, pid=0, **args):
        pass

    def instant(self, name, tid, pid=0, **args):
        pass

    def span(self, name, tid, pid=0, **args):
        return self._NULL_CTX

    def events(self):
        return []

    def to_chrome(self):
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"dropped_events": 0, "capacity": 0}}

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


NULL_TRACE = NullTrace()
