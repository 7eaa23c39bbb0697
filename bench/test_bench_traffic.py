"""The traffic generator: seeded, the same sizes and arrivals under every
seed, Poisson arrivals in wall-clock seconds at the stated rate."""

import math

import numpy as np
import pytest

from harness import manifest, traffic

OPEN = {"loop": "open", "rate_per_s": 5.0, "arrivals_seed": 0,
        "prompt_tokens": {"min": 256, "max": 2048},
        "output_tokens": {"min": 16, "max": 128}, "check_requests": 8}
CLOSED = {"loop": "closed", "requests": 512, "admit_in_setup": True,
          "prompt_tokens": {"min": 64, "max": 256},
          "output_tokens": {"min": 512, "max": 2048}, "stratum": 64,
          "check_requests": 2}


def sizes(items, k):
    return [sorted((len(it.prompt), it.max_new) for it in items[i:i + k])
            for i in range(0, len(items), k)]


@pytest.mark.parametrize("mix", [OPEN, CLOSED])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_same_seed_same_requests(mix, seed):
    a = traffic.generate(mix, seed, 1000, 20.0)
    b = traffic.generate(mix, seed, 1000, 20.0)
    assert len(a) == len(b) == traffic.count(mix, 20.0)
    for x, y in zip(a, b):
        assert x.due_s == y.due_s and x.max_new == y.max_new
        assert np.array_equal(x.prompt, y.prompt)
        assert x.prompt.dtype == np.int32
        assert 0 <= x.prompt.min() and x.prompt.max() < 1000


@pytest.mark.parametrize("mix", [OPEN, CLOSED])
def test_every_seed_gets_the_same_work(mix):
    k = (traffic.per_span(mix, 20.0) if mix["loop"] == "open"
         else mix["stratum"])
    a = traffic.generate(mix, 1, 1000, 20.0)
    b = traffic.generate(mix, 2, 1000, 20.0)
    # each stratum holds the same prompt and output sizes, in another order
    pa = [sorted(len(it.prompt) for it in a[i:i + k])
          for i in range(0, len(a), k)]
    pb = [sorted(len(it.prompt) for it in b[i:i + k])
          for i in range(0, len(b), k)]
    assert pa == pb
    assert [len(it.prompt) for it in a] != [len(it.prompt) for it in b]
    oa = sorted(it.max_new for it in a)
    assert oa == sorted(it.max_new for it in b)
    lo, hi = mix["prompt_tokens"]["min"], mix["prompt_tokens"]["max"]
    assert all(lo <= len(it.prompt) <= hi for it in a)


def test_open_arrivals_are_wall_clock_seconds():
    items = traffic.generate(OPEN, 5, 1000, 30.0)
    due = np.array([it.due_s for it in items])
    assert np.all(np.diff(due) >= 0) and due[0] >= 0
    # the window and the spans after it: the stated rate in each, exactly
    m = round(OPEN["rate_per_s"] * 30.0)
    n = traffic.spans(30.0)
    assert n * 30.0 >= 30.0 + traffic.AFTER_S and len(items) == n * m
    assert np.sum(due < 30.0) == m and np.all(due < n * 30.0)
    assert all(np.sum((due >= 30.0 * s) & (due < 30.0 * (s + 1))) == m
               for s in range(n))
    b = traffic.generate(OPEN, 6, 1000, 30.0)
    assert not np.allclose(due, [it.due_s for it in b])


def test_open_arrivals_are_poisson():
    # the gaps of a Poisson process are exponential: mean 1 / rate, and a
    # standard deviation as large as the mean (bursts and lulls), over
    # many realizations, each turned by a seed of its own
    gaps = []
    for seed in range(40):
        mix = dict(OPEN, arrivals_seed=seed)
        due = np.array([it.due_s for it in
                        traffic.generate(mix, 2 ** 35 + seed, 1000, 30.0)])
        gaps.append(np.diff(due[due < 30.0]))
    g = np.concatenate(gaps)
    assert abs(g.mean() * OPEN["rate_per_s"] - 1) < 0.05
    assert abs(g.std() / g.mean() - 1) < 0.08
    # a tenth of the gaps shorter than a tenth of the mean (exp: 9.5%)
    assert 0.07 < np.mean(g < 0.1 / OPEN["rate_per_s"]) < 0.12


def circular_gaps(due, lo, seconds):
    t = np.sort(due[(due >= lo) & (due < lo + seconds)]) - lo
    return np.sort(np.diff(np.concatenate([t, [t[0] + seconds]])))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 2 ** 40 + 3])
def test_every_seed_gets_the_same_arrivals_in_another_order(seed):
    # one realization, turned: the same gaps around each span, at other
    # times; another arrivals_seed is another realization
    a = np.array([it.due_s for it in traffic.generate(OPEN, 0, 1000, 30.0)])
    b = np.array([it.due_s for it in
                  traffic.generate(OPEN, seed, 1000, 30.0)])
    assert not np.allclose(a, b)
    for s in range(traffic.spans(30.0)):
        assert np.allclose(circular_gaps(a, 30.0 * s, 30.0),
                           circular_gaps(b, 30.0 * s, 30.0), atol=1e-9)
    c = np.array([it.due_s for it in traffic.generate(
        dict(OPEN, arrivals_seed=1), seed, 1000, 30.0)])
    assert not np.allclose(circular_gaps(c, 0.0, 30.0),
                           circular_gaps(b, 0.0, 30.0))


@pytest.mark.parametrize("seconds", [10.0, 45.0, 51.0])
def test_every_seed_gets_the_stated_rate(seconds):
    counts = {sum(1 for it in traffic.generate(OPEN, seed, 1000, seconds)
                  if it.due_s < seconds) for seed in (1, 2, 2 ** 33 + 5)}
    assert counts == {round(OPEN["rate_per_s"] * seconds)}


def test_closed_requests_are_due_at_once():
    items = traffic.generate(CLOSED, 3, 1000, 45.0)
    assert len(items) == 512 and all(it.due_s == 0.0 for it in items)


def test_log_uniform_quantiles():
    q = traffic.log_uniform_sizes(64, 256, 64)
    assert q[0] >= 64 and q[-1] <= 256 and np.all(np.diff(q) >= 0)
    # the median stratum sits at the geometric mean
    assert abs(math.log(q[32]) - math.log(128)) < 0.05


@pytest.mark.parametrize("name", ["reasoning_batch", "code_completion"])
def test_the_benchmark_mixes_load(name):
    mix = manifest.traffic(name)
    assert mix["loop"] in ("open", "closed")
    items = traffic.generate(mix, 1, 50000, 45.0)
    assert items and mix["check_requests"] >= 1
    # where the sizes come from is written beside them
    assert mix["source"] and mix["assumed"]
