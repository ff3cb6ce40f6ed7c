import random
import statistics

import pytest

from ljbench.stats import merged, merged_length, percentile


@pytest.mark.parametrize("q", [5, 25, 50, 75, 95])
def test_percentile_matches_statistics_inclusive(q):
    rng = random.Random(q)
    xs = [rng.uniform(0.0, 10.0) for _ in range(137)]
    want = statistics.quantiles(xs, n=100, method="inclusive")[q - 1]
    assert percentile(xs, q) == pytest.approx(want, rel=1e-12)


def test_percentile_small_inputs():
    assert percentile([3.0], 95) == 3.0
    assert percentile([1.0, 2.0], 50) == 1.5
    with pytest.raises(ValueError):
        percentile([], 50)


def test_interval_merge():
    ivs = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (3.0, 4.0), (6.0, 6.5), (10.0, 11.0)]
    assert merged(ivs) == [(0.0, 4.0), (5.0, 7.0), (10.0, 11.0)]
    assert merged_length(ivs) == pytest.approx(7.0)
    assert merged_length([]) == 0.0


def test_interval_merge_against_a_grid():
    rng = random.Random(3)
    ivs = []
    for _ in range(50):
        a = rng.randrange(0, 200)
        ivs.append((float(a), float(a + rng.randrange(1, 15))))
    covered = {t for a, b in ivs for t in range(int(a), int(b))}
    assert merged_length(ivs) == pytest.approx(len(covered))
