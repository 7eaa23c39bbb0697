"""Reading the profiler's trace of the traced part of a run.

The harness marks its own host ranges with ``record_function``: each engine
step ("decode-only step" or "step with prefill"), each `submit` and
`collect`, and inside a step each call of the engine's step functions
("prefill call", "decode call").  Every step ends in a token readback that
waits for the device, so every device operation a step launched runs inside
that step's range, and inside it after the start of the call that launched
it: an operation belongs to the last call that began before it.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

STEP_RANGES = ("decode-only step", "step with prefill")
CALL_RANGES = ("prefill call", "decode call")
HOST_RANGES = STEP_RANGES + CALL_RANGES + ("submit", "collect")


@dataclasses.dataclass
class Op:
    name: str
    kind: str                # "kernel", "gpu_memcpy" or "gpu_memset"
    start: int               # ns, the profiler's clock
    end: int
    step: Optional[int]      # index into Trace.steps, None outside any
    call: Optional[int]      # index into Trace.steps[step].calls


@dataclasses.dataclass
class StepRange:
    label: str
    start: int
    end: int
    calls: List[Tuple[str, int, int]]   # (label, start, end)
    record: Optional[object] = None     # the harness's step record


@dataclasses.dataclass
class Trace:
    start: int
    end: int
    ops: List[Op]
    steps: List[StepRange]
    host: List[Tuple[str, int, int]]    # every harness range

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            if out and op.start <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], op.end))
            else:
                out.append((op.start, op.end))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """Every stretch with no device operation: (start ns, end ns)."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def host_at(self, t: int) -> str:
        """The innermost harness range open at `t` ("harness loop" where
        none is): a call inside a step, else the step, else a submit or
        collect."""
        for kinds in (CALL_RANGES, STEP_RANGES, ("submit", "collect")):
            rs = [r for r in self.host if r[0] in kinds]
            i = bisect.bisect_right([r[1] for r in rs], t) - 1
            if i >= 0 and t < rs[i][2]:
                return rs[i][0]
        return "harness loop"


def activities(prof) -> List:
    return list(prof.profiler.kineto_results.events())


def _span(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        a = e.start_ns()
        return a, a + e.duration_ns()
    a = int(e.start_us() * 1000)
    return a, a + int(e.duration_us() * 1000)


def _on_device(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"


def read(events, step_records: List) -> Optional[Trace]:
    """The trace of the traced steps: `step_records` are the harness's
    records of the steps it ran while the profiler ran, in order, which the
    step ranges found in the trace are matched to one by one.  Host ranges
    are the host's events under the harness's names; device operations are
    the device's other events (a kernel, or a copy or fill by its name)."""
    host, dev = [], []
    for e in events:
        name = e.name()
        if not _on_device(e):
            if name in HOST_RANGES:
                host.append((name, *_span(e)))
        elif name not in HOST_RANGES:
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            dev.append((name, kind, *_span(e)))
    host.sort(key=lambda r: r[1])
    steps = [StepRange(n, a, b, []) for n, a, b in host if n in STEP_RANGES]
    if not steps or len(steps) != len(step_records):
        return None
    starts = [s.start for s in steps]
    for n, a, b in host:
        if n in CALL_RANGES:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < steps[i].end:
                steps[i].calls.append((n, a, b))
    for s, rec in zip(steps, step_records):
        s.record = rec
    t0, t1 = steps[0].start, steps[-1].end
    ops = []
    for name, kind, a, b in dev:
        if b <= t0 or a >= t1:
            continue
        i = bisect.bisect_right(starts, a) - 1
        step = i if i >= 0 and a < steps[i].end else None
        call = None
        if step is not None:
            for j, (_, ca, _) in enumerate(steps[step].calls):
                if ca <= a:
                    call = j
        ops.append(Op(name, kind, max(a, t0), min(b, t1), step, call))
    return Trace(t0, t1, ops, steps, host)


#: a device operation's name is cut to this many characters in the
#: breakdown (a kernel's template arguments run to pages)
NAME_CHARS = 160


def top_ops(trace: Trace, n: int = 10) -> List[List]:
    by: Dict[str, float] = {}
    for op in trace.ops:
        key = op.name[:NAME_CHARS]
        by[key] = by.get(key, 0.0) + (op.end - op.start) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def top_gaps(trace: Trace, n: int = 10) -> List[List]:
    """The n longest idle stretches, each named by what the host was
    doing when it began."""
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
    return [[trace.host_at(a), (b - a) / 1e9] for a, b in gaps]
