"""Percentiles, rates and inter-token gaps over every request."""

import math

import numpy as np
import pytest

from harness import stats


@pytest.mark.parametrize("n", [1, 2, 7, 100, 101])
@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys(n, q):
    xs = np.random.default_rng(n).exponential(size=n).tolist()
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_missing_samples_rank_last():
    xs = [1.0] * 9 + [math.inf]
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 100) == math.inf
    assert stats.percentile([], 90) is None


def test_gaps_and_tokens_in_the_window():
    stamps = [0.5, 1.0, 1.0, 2.0, 3.5]
    # the gap counts where its later token falls in (t0, t1]
    assert stats.gaps_in(stamps, 0.9, 2.0) == [0.5, 0.0, 1.0]
    assert stats.tokens_in(stamps, 0.9, 2.0) == 3
    assert stats.gaps_in(stamps[:1], 0.0, 9.0) == []
