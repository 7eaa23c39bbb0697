"""The serving front end and synthetic traffic (PyTorch port of
``repro/serving/api.py``): the `ServingAPI` facade, ``poisson_trace``,
``shared_prefix_trace``, ``mixed_trace``, ``bursty_trace`` and
``run_trace``.

`ServingAPI` is the submit / cancel / step / collect surface a network
front end would wrap, with the engine's stats, trace recorder and
Prometheus text.  The traces are reproducible open-loop request streams
with arrivals in decode-step units (so scheduling replays identically
across engines): `poisson_trace` draws exponential interarrival times,
`shared_prefix_trace` gives every prompt one of a few fixed system
prefixes (the prefix cache's workload), `mixed_trace` has one arrival per
step with lengths cycling (the batch's mix of prefill chunks and decode
tokens changes every step: the ragged step's workload), and `bursty_trace`
sends groups of simultaneous arrivals.  The draws are numpy's, so the JAX
package and this port get the same trace from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import Request, ShedError


@dataclasses.dataclass(frozen=True)
class TraceItem:
    arrival_step: int          # engine step at which the request arrives
    prompt: np.ndarray         # int32 [L]
    max_new: int


class ServingAPI:
    """submit / cancel / step / collect facade over an engine (the unit a
    network front end would wrap; requests are visible at once)."""

    def __init__(self, engine):
        self.engine = engine

    def submit(self, prompt, max_new: int, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; ``deadline_s`` is a time to live from now
        (outcome timeout once it passes).  Raises ShedError when the
        bounded admission queue is full."""
        return self.engine.submit(prompt, max_new, eos_id=eos_id,
                                  deadline_s=deadline_s)

    def cancel(self, rid: int) -> bool:
        """Cancel a queued, prefilling or decoding request (outcome
        cancelled, surfaced by collect()); False when rid is unknown or
        already retired."""
        return self.engine.cancel(rid)

    def step(self) -> int:
        return self.engine.step()

    def collect(self) -> List[Request]:
        return self.engine.collect()

    def stats(self) -> Dict:
        return self.engine.stats()

    @property
    def trace(self):
        """The engine's trace recorder (save() / to_chrome() for
        Perfetto)."""
        return self.engine.trace

    def metrics_text(self) -> str:
        """Prometheus text exposition of the engine's registry (the body
        of a /metrics endpoint)."""
        return self.engine.metrics.render_text()


def poisson_trace(n_requests: int, rate_per_step: float,
                  prompt_lens: Sequence[int], gen_lens: Sequence[int],
                  vocab: int, seed: int = 0) -> List[TraceItem]:
    """Open-loop Poisson arrivals: interarrival ~ Exp(rate) in decode-step
    units; prompt/gen lengths drawn uniformly from the given choices."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / max(rate_per_step, 1e-9))
        L = int(rng.choice(list(prompt_lens)))
        out.append(TraceItem(
            arrival_step=int(t),
            prompt=rng.integers(0, vocab, size=L, dtype=np.int32),
            max_new=int(rng.choice(list(gen_lens))),
        ))
    return out


def shared_prefix_trace(n_requests: int, rate_per_step: float,
                        sys_len: int, user_lens: Sequence[int],
                        gen_lens: Sequence[int], vocab: int, seed: int = 0,
                        n_system_prompts: int = 1) -> List[TraceItem]:
    """Shared-system-prompt traffic: every prompt is one of
    `n_system_prompts` fixed system prefixes (`sys_len` tokens) followed by
    a unique user suffix, with `poisson_trace`'s arrivals.  The prefix
    cache serves the system prompt's pages to every request after the
    first."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, vocab, size=sys_len, dtype=np.int32)
               for _ in range(max(1, n_system_prompts))]
    t, out = 0.0, []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / max(rate_per_step, 1e-9))
        sys_p = systems[int(rng.integers(0, len(systems)))]
        user = rng.integers(0, vocab, size=int(rng.choice(list(user_lens))),
                            dtype=np.int32)
        out.append(TraceItem(
            arrival_step=int(t),
            prompt=np.concatenate([sys_p, user]),
            max_new=int(rng.choice(list(gen_lens))),
        ))
    return out


def mixed_trace(n_requests: int, prompt_lens: Sequence[int],
                gen_lens: Sequence[int], vocab: int,
                seed: int = 0) -> List[TraceItem]:
    """One arrival per decode step with prompt/gen lengths cycling through
    their cross product, so every step's running set mixes prefill chunks
    and decode tokens differently."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        L = int(prompt_lens[i % len(prompt_lens)])
        g = int(gen_lens[(i // len(prompt_lens)) % len(gen_lens)])
        prompt = rng.integers(0, vocab, size=L, dtype=np.int32)
        out.append(TraceItem(arrival_step=i, prompt=prompt, max_new=g))
    return out


def bursty_trace(n_requests: int, burst: int, period: int,
                 prompt_lens: Sequence[int], gen_lens: Sequence[int],
                 vocab: int, seed: int = 0) -> List[TraceItem]:
    """Groups of `burst` simultaneous requests every `period` decode steps,
    prompt lengths alternating between bursts: admission spikes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        group = i // burst
        L = int(prompt_lens[(group + i) % len(prompt_lens)])
        g = int(gen_lens[i % len(gen_lens)])
        prompt = rng.integers(0, vocab, size=L, dtype=np.int32)
        out.append(TraceItem(arrival_step=group * period, prompt=prompt,
                             max_new=g))
    return out


def run_trace(engine, trace: List[TraceItem],
              max_steps: int = 100_000) -> Tuple[Dict, List[Request]]:
    """Submit each request at its arrival step and step until every request
    retired.  Returns (stats, retired requests sorted by rid)."""
    pending = sorted(trace, key=lambda it: it.arrival_step)
    finished: List[Request] = []
    i, step_idx = 0, 0
    while len(finished) < len(trace):
        if step_idx >= max_steps:
            raise RuntimeError(f"trace incomplete after {max_steps} steps")
        while i < len(pending) and pending[i].arrival_step <= step_idx:
            try:
                engine.submit(pending[i].prompt, pending[i].max_new)
            except ShedError:
                pass     # shed requests still retire through collect()
            i += 1
        engine.step()
        finished.extend(engine.collect())
        step_idx += 1
    return engine.stats(), sorted(finished, key=lambda r: r.rid)
