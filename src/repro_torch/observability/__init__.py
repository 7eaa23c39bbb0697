"""Host-side serving telemetry (stdlib only): the metrics registry
(``metrics``) and the recompile sentinel (``jit_watch``), bundled per
engine by `Telemetry`."""

from .jit_watch import NULL_JIT_WATCH, JitWatch
from .metrics import NULL_REGISTRY, MetricsRegistry


class Telemetry:
    """The per-engine telemetry bundle: a metrics registry and a recompile
    sentinel (the JAX package's bundle without its trace recorder).

    Metrics on by default; the sentinel counts but does not raise unless
    ``strict_recompiles=True`` (the tests' mode), which turns a
    steady-state recompile into an exception."""

    def __init__(self, metrics: bool = True, strict_recompiles: bool = False,
                 registry=None):
        if registry is None:
            registry = MetricsRegistry() if metrics else NULL_REGISTRY
        self.registry = registry
        self.jit_watch = (JitWatch(registry, strict=strict_recompiles)
                          if metrics else NULL_JIT_WATCH)

    @property
    def enabled(self) -> bool:
        return self.registry.enabled

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(metrics=False)
