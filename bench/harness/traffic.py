"""The one traffic generator: a mix's parameters (``bench/traffic/*.json``)
and the run's seed give the requests, each with the second at which it is
due, counted from the window's start.

Keys of a mix:

- ``loop``: ``"closed"`` (every request queued at once; ``requests`` of
  them) or ``"open"`` (a Poisson process at ``rate_per_s`` requests a
  second: one realization, drawn from ``arrivals_seed``, turned by the
  run's seed);
- ``prompt_tokens``, ``output_tokens``: ``{"min", "max"}``, log-uniform;
- ``stratum`` (closed): each consecutive run of this many requests holds
  the same sizes, the law's quantiles, in an order drawn from the seed: a
  seed changes which request is long, never how much there is to do.  An
  open loop's stratum is the span below: every span holds the same sizes;
- ``admit_in_setup`` (closed): the first engine step, which admits and
  prefills the first batch, runs in set-up;
- ``check_requests``: how many finished requests the comparison samples.

Open-loop arrivals: every span of the run's length, from the window's
start on, holds ``round(rate_per_s * seconds)`` arrivals, at independent
uniform times within it.  That is a Poisson process of that rate
conditioned on its count in each span: the gaps and bursts are the
process's, and the rate in the window is the stated one.  The times are
drawn once, from the mix's ``arrivals_seed``; the run's seed turns each
span's times by one offset, modulo the span.  So every seed gets the same
arrivals, the same gaps and bursts, in another order: a seed changes when a
burst comes, never how many there are (a process on a circle turned by a
uniform offset is again such a process).  The arrivals cover the window
and the spans after it (`AFTER_S`), through which the harness waits for
the window's first tokens and then taps the next steps.

Keys the generator does not read (``source``, ``taken``, ``assumed``,
``cut``) say where the sizes come from.  Token ids are uniform over the
vocabulary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

#: seconds of open-loop arrivals after the window: the harness's two
#: waits after it (each up to a minute: first tokens, then the taps) find
#: arrivals still to come, however slow the host
AFTER_S = 120.0


@dataclasses.dataclass
class Item:
    due_s: float            # seconds after the window opens (closed: 0)
    prompt: np.ndarray      # int32 [L]
    max_new: int


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of `seed` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


def log_uniform_sizes(lo: int, hi: int, n: int) -> np.ndarray:
    """The n stratified quantiles of the log-uniform law on [lo, hi],
    rounded to whole tokens (midpoints of n equal strata)."""
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
                   ).astype(np.int64)


def per_span(mix: Dict, seconds: float) -> int:
    """Open-loop arrivals in each span of `seconds`."""
    return max(1, int(round(float(mix["rate_per_s"]) * seconds)))


def spans(seconds: float) -> int:
    """Spans of the run's length that open-loop arrivals cover: the window
    and `AFTER_S` after it."""
    return 1 + math.ceil(AFTER_S / seconds)


def count(mix: Dict, seconds: float) -> int:
    """How many requests a run of `seconds` draws."""
    if mix["loop"] == "closed":
        return int(mix["requests"])
    return spans(seconds) * per_span(mix, seconds)


def poisson_arrivals(mix: Dict, seed: int, seconds: float) -> np.ndarray:
    """Sorted due seconds: in each span [s * seconds, (s + 1) * seconds),
    `per_span` independent uniform times drawn from ``arrivals_seed``,
    turned by an offset drawn from `seed`."""
    m = per_span(mix, seconds)
    times = rng(int(mix["arrivals_seed"]), 3)
    offset = rng(seed, 3).uniform(0.0, seconds)
    return np.concatenate([
        s * seconds + np.sort((times.uniform(0.0, seconds, m) + offset)
                              % seconds)
        for s in range(spans(seconds))])


def generate(mix: Dict, seed: int, vocab: int, seconds: float) -> List[Item]:
    n = count(mix, seconds)
    k = (per_span(mix, seconds) if mix["loop"] == "open"
         else int(mix.get("stratum", 1)))
    order = rng(seed, 0)

    def strata(lo: int, hi: int) -> np.ndarray:
        base = log_uniform_sizes(lo, hi, k)
        return np.concatenate([order.permutation(base)
                               for _ in range(-(-n // k))])[:n]

    prompts = strata(mix["prompt_tokens"]["min"], mix["prompt_tokens"]["max"])
    outputs = strata(mix["output_tokens"]["min"], mix["output_tokens"]["max"])
    due = (poisson_arrivals(mix, seed, seconds) if mix["loop"] == "open"
           else np.zeros(n))
    toks = rng(seed, 1)
    return [Item(float(due[i]),
                 toks.integers(0, vocab, int(prompts[i]), dtype=np.int32),
                 int(outputs[i]))
            for i in range(n)]


def prompt_lengths(items: List[Item]) -> List[int]:
    return sorted({len(it.prompt) for it in items})
