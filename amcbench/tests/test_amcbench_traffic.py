"""The arrival process and the frame pool are deterministic in the seed,
and every seed offers the same work."""
import numpy as np
import pytest

from amcbench.frames import make_pool
from amcbench.traffic import arrivals_poisson


def test_poisson_deterministic_and_same_set():
    a = arrivals_poisson.offsets(4000.0, 3.0, 2**31 + 5)
    b = arrivals_poisson.offsets(4000.0, 3.0, 2**31 + 5)
    c = arrivals_poisson.offsets(4000.0, 3.0, 17)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len(a) == len(c) == 12000
    # the same set of gaps, another order (the last of each order ends
    # the span, so one gap of each set is not between two arrivals)
    common = np.intersect1d(np.round(np.diff(a), 12), np.round(np.diff(c), 12))
    assert len(common) >= len(a) - 10
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 3.0


def test_poisson_gaps_exponential():
    gaps = np.diff(arrivals_poisson.offsets(2000.0, 10.0, 3))
    assert gaps.mean() == pytest.approx(1 / 2000.0, rel=0.01)
    assert gaps.std() == pytest.approx(1 / 2000.0, rel=0.05)


def test_pool_deterministic():
    a, la, sa = make_pool(2**31 + 9, 300, range(-20, 20, 2))
    b, lb, sb = make_pool(2**31 + 9, 300, range(-20, 20, 2))
    c, lc, sc = make_pool(4, 300, range(-20, 20, 2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # every seed: the same modulations and SNRs
    assert np.array_equal(la, lc) and np.array_equal(sa, sc)
    assert a.shape == (300, 2, 128) and a.dtype == np.float32
    assert np.all(np.isfinite(a)) and not np.any((a == 0).all(axis=(1, 2)))
    # unit-energy frames, as RadioML's
    assert np.allclose(np.sqrt((a.astype(np.float64) ** 2).mean(axis=(1, 2)) * 2),
                       1.0, atol=1e-4)
