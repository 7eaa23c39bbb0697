"""Metrics registry: counters, gauges, bounded-bucket histograms (a copy of
``repro/observability/metrics.py``; stdlib only).

A registry renders two ways:

  * ``render_text()``  -- Prometheus text exposition
  * ``snapshot()``     -- a JSON-able dict merged into engine ``stats()``

Histograms are bounded: a fixed bucket ladder plus exact
count/sum/min/max; percentiles interpolate inside the bucket holding the
target rank and clamp to the observed [min, max].  Metrics never touch the
model's math: every update is a host-side float or int.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

#: default histogram ladder: 10us .. ~84s, x2 per bucket (latency-shaped)
TIME_BUCKETS_US: Tuple[float, ...] = tuple(
    float(10 * (1 << i)) for i in range(24))

#: small-count ladder (batch sizes, page counts): 1 .. 512, x2 per bucket
COUNT_BUCKETS: Tuple[float, ...] = tuple(float(1 << i) for i in range(10))

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        assert n >= 0, f"counters only go up (inc({n}))"
        self.value += n


class Gauge:
    """A value that can go anywhere."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)

    def inc(self, n=1) -> None:
        self.value += n


class Histogram:
    """Bounded-bucket histogram with interpolated percentiles.

    ``bounds[i]`` is the inclusive upper edge of bucket ``i``; the final
    (overflow) bucket is open-ended.  ``percentile(q)`` walks the cumulative
    counts to the bucket holding rank ``q/100 * count``, interpolates
    linearly inside it, and clamps to the exact observed [min, max] — so
    degenerate distributions (one value, all-equal values) come back exact
    and tails never extrapolate past data that was actually seen.
    """

    __slots__ = ("bounds", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, buckets: Tuple[float, ...] = TIME_BUCKETS_US):
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in buckets))
        assert self.bounds, "histogram needs at least one bucket bound"
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1

    def percentile(self, q: float) -> Optional[float]:
        if not self.n:
            return None
        target = (q / 100.0) * self.n            # fractional rank
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                val = lo + (hi - lo) * max(target - cum, 0.0) / c
                return float(min(max(val, self.vmin), self.vmax))
            cum += c
        return float(self.vmax)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.n if self.n else None

    def summary(self) -> Dict:
        return {
            "count": self.n,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named metric store: get-or-create accessors, text + JSON export.

    Metrics are keyed on (name, sorted label items); repeated lookups of
    the same key return the same object, so call sites can either hold a
    reference or re-resolve per event — both hit the same cell.  A lock
    guards the registry dicts only (creation); individual updates are
    plain attribute stores, safe under CPython for the single-writer
    engine loop this instruments.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, _LabelKey], Histogram] = {}
        self._help: Dict[str, str] = {}

    @property
    def enabled(self) -> bool:
        return True

    def _get(self, store, name, factory, help_, labels):
        key = (name, _label_key(labels))
        metric = store.get(key)
        if metric is None:
            with self._lock:
                metric = store.setdefault(key, factory())
                if help_:
                    self._help.setdefault(name, help_)
        return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(self._counters, name, Counter, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(self._gauges, name, Gauge, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = TIME_BUCKETS_US,
                  **labels) -> Histogram:
        return self._get(self._histograms, name,
                         lambda: Histogram(buckets), help, labels)

    # ------------------------------------------------------------- export --
    def snapshot(self) -> Dict:
        """JSON-able view.  Unlabelled metrics key on their bare name;
        labelled ones on ``name{k="v"}`` — so report consumers index the
        common case directly (``snapshot()["histograms"]["ttft_us"]``)."""
        def flat(store, value):
            return {name + _label_str(lk): value(m)
                    for (name, lk), m in sorted(store.items())}

        return {
            "counters": flat(self._counters, lambda m: m.value),
            "gauges": flat(self._gauges, lambda m: m.value),
            "histograms": flat(self._histograms, lambda m: m.summary()),
        }

    def render_text(self) -> str:
        """Prometheus text exposition (counters, gauges, cumulative
        histogram buckets + _sum/_count)."""
        lines: List[str] = []

        def head(name, kind):
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} {kind}")

        seen = set()
        for (name, lk), c in sorted(self._counters.items()):
            if name not in seen:
                head(name, "counter")
                seen.add(name)
            lines.append(f"{name}{_label_str(lk)} {c.value}")
        for (name, lk), g in sorted(self._gauges.items()):
            if name not in seen:
                head(name, "gauge")
                seen.add(name)
            lines.append(f"{name}{_label_str(lk)} {g.value}")
        for (name, lk), h in sorted(self._histograms.items()):
            if name not in seen:
                head(name, "histogram")
                seen.add(name)
            cum = 0
            for bound, c in zip(h.bounds, h.counts):
                cum += c
                le = dict(lk)
                le["le"] = f"{bound:g}"
                lines.append(f"{name}_bucket{_label_str(_label_key(le))} "
                             f"{cum}")
            le = dict(lk)
            le["le"] = "+Inf"
            lines.append(f"{name}_bucket{_label_str(_label_key(le))} {h.n}")
            lines.append(f"{name}_sum{_label_str(lk)} {h.total}")
            lines.append(f"{name}_count{_label_str(lk)} {h.n}")
        return "\n".join(lines) + ("\n" if lines else "")


class _NullMetric:
    """Shared no-op stand-in for counter/gauge/histogram."""

    __slots__ = ()
    value = 0
    n = 0
    total = 0.0
    mean = None

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def percentile(self, q):
        return None

    def summary(self):
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "mean": None, "p50": None, "p95": None, "p99": None}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Telemetry-off registry: every accessor returns the shared no-op
    metric, exports are empty.  Call sites never branch on enablement."""

    enabled = False

    def counter(self, name, help="", **labels):
        return _NULL_METRIC

    def gauge(self, name, help="", **labels):
        return _NULL_METRIC

    def histogram(self, name, help="", buckets=TIME_BUCKETS_US, **labels):
        return _NULL_METRIC

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def render_text(self):
        return ""


NULL_REGISTRY = NullRegistry()

#: process-wide registry for module-level instrumentation that has no
#: engine to hang off (kernels.ops per-backend dispatch counters).  Engine
#: metrics live in per-engine registries so e.g. serve.py's compare-mode
#: engines don't pollute each other.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
