"""Host-side serving telemetry (stdlib only): the metrics registry
(``metrics``), the ring-buffered span recorder exporting Chrome/Perfetto
``trace_event`` JSON (``trace``) and the recompile sentinel
(``jit_watch``), bundled per engine by `Telemetry`."""

from .jit_watch import NULL_JIT_WATCH, JitWatch
from .metrics import NULL_REGISTRY, MetricsRegistry
from .trace import NULL_TRACE, NullTrace, TraceRecorder  # noqa: F401


class Telemetry:
    """The per-engine telemetry bundle: a metrics registry, a trace
    recorder and a recompile sentinel, each enabled on its own.

    Metrics on by default; the trace off (``trace=True``, or the CLI's
    ``--trace-out``); the sentinel counts but does not raise unless
    ``strict_recompiles=True`` (the tests' mode), which turns a
    steady-state recompile into an exception.  `registry` hands the bundle
    an existing registry in place of a new one."""

    def __init__(self, metrics: bool = True, trace: bool = False,
                 trace_capacity: int = 1 << 16,
                 strict_recompiles: bool = False, registry=None):
        if registry is None:
            registry = MetricsRegistry() if metrics else NULL_REGISTRY
        self.registry = registry
        self.trace = TraceRecorder(trace_capacity) if trace else NULL_TRACE
        self.jit_watch = (JitWatch(registry, strict=strict_recompiles)
                          if metrics else NULL_JIT_WATCH)

    @property
    def enabled(self) -> bool:
        return self.registry.enabled or self.trace.enabled

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(metrics=False, trace=False)
