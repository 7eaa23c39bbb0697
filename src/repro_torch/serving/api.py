"""Synthetic traffic and the trace driver (PyTorch port of
``repro/serving/api.py``: ``poisson_trace``, ``mixed_trace``,
``bursty_trace`` and ``run_trace``).

The traces are reproducible open-loop request streams with arrivals in
decode-step units (so scheduling replays identically across engines):
`poisson_trace` draws exponential interarrival times, `mixed_trace` has one
arrival per step with lengths cycling (the batch's mix of prefill chunks
and decode tokens changes every step: the ragged step's workload), and
`bursty_trace` sends groups of simultaneous arrivals.  The draws are
numpy's, so the JAX package and this port get the same trace from the same
seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .scheduler import Request, ShedError


@dataclasses.dataclass(frozen=True)
class TraceItem:
    arrival_step: int          # engine step at which the request arrives
    prompt: np.ndarray         # int32 [L]
    max_new: int


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
