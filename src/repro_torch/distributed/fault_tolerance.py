"""Fault-tolerance runtime (a copy of ``repro/distributed/
fault_tolerance.py``; stdlib and threading only): the step watchdog
(straggler/hang detection), bounded retry, and the EWMA step timer.

  * **Heartbeat watchdog** -- a watched step arms a timer; if it exceeds
    `deadline_s` (a hung device call, a straggler), the watchdog fires a
    callback.  It cannot interrupt the step: the serving engine reads
    ``fired`` after the step returns and counts the overrun, or raises
    `StepDeadlineExceeded` in strict mode.
  * **Straggler mitigation** -- slow-host detection uses per-step wall-time
    EWMA vs the cluster median (`StepTimer.is_straggler`).
  * **Retryable steps** -- transient failures are retried up to
    `max_retries` times before surfacing (`run_with_retries`; the chaos
    harness drives every serving step through it).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.ft")


class StepDeadlineExceeded(RuntimeError):
    """A watched step (training or serving) overran its watchdog deadline.
    Raised by callers that run the Watchdog in strict mode — e.g. the
    serving engine with ``ServingConfig.step_deadline_strict`` — after the
    step returns; the watchdog itself cannot interrupt a hung device call,
    it can only make the overrun loud."""


class Watchdog:
    """Arms a deadline around each step; fires `on_timeout` if exceeded.
    Re-armable: ``arm()`` clears a previous firing, so one instance can
    guard every step of a long-running loop (the serving engine arms it
    once per ``step()``)."""

    def __init__(self, deadline_s: float, on_timeout: Optional[Callable] = None):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout or (lambda: None)
        self._timer: Optional[threading.Timer] = None
        self.fired = threading.Event()

    def arm(self):
        self.disarm()
        self.fired.clear()
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def _fire(self):
        self.fired.set()
        log.error("watchdog: step exceeded %.1fs deadline", self.deadline_s)
        self.on_timeout()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self):
        self.arm()
        return self

    def __exit__(self, *exc):
        self.disarm()
        return False


class StepTimer:
    """EWMA step timing; flags stragglers vs a reference (median) time."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> float:
        dt = time.monotonic() - self._t0
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt

    def is_straggler(self, cluster_median_s: float, factor: float = 1.5) -> bool:
        return self.ewma is not None and self.ewma > factor * cluster_median_s


def run_with_retries(step_fn: Callable, *, max_retries: int = 3,
                     on_failure: Optional[Callable[[int, Exception], None]] = None):
    """Run `step_fn()`, retrying transient runtime failures."""
    for attempt in range(max_retries + 1):
        try:
            return step_fn()
        except Exception as e:  # noqa: BLE001 -- deliberate catch-all boundary
            if attempt >= max_retries:
                raise
            log.warning("step failed (attempt %d): %s -- retrying", attempt, e)
            if on_failure is not None:
                on_failure(attempt, e)
