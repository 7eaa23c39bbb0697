"""Synthetic traffic and the trace driver (PyTorch port of
``repro/serving/api.py::poisson_trace`` / ``run_trace``).

`poisson_trace` draws a reproducible open-loop request trace: exponential
interarrival times in decode-step units (so scheduling replays identically
across engines) with prompt/generation lengths drawn from the given
choices.  The draws are numpy's, so the JAX package and this port get the
same trace from the same seed.
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
