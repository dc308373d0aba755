"""The arrival process and the frame pool are deterministic in the seed,
and every seed offers the same work; the default pool is the one the
generator made before its length and modulation set became arguments."""
import hashlib
import time

import numpy as np
import pytest

from amcbench.frames import FRAME_SETS, make_pool
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


# SHA-256 of (iq, labels, snrs) of the default pool, 8,192 frames on the
# traffic's grid, as the generator made it with the frame length fixed at
# 128 and the 2016.10A set alone
POOL_DIGESTS = {
    0: ("8b75f98b7742a36e38be79a7f78f3ba099f51de2870b37fef00411f36f2b4562",
        "d082fd47b97cb0e884adbcb6ac959e237de044fe0d8e15a84175c110d159aa28",
        "67c9f13043be7eb64b9349ec88e671f042c16ce9def29a18dce6a9cb06e85dff"),
    1: ("4ba88deb1330f7c70cdd1e80c79a2db84c1a703fffcd87f27d105ef1d9ae3f30",
        "d082fd47b97cb0e884adbcb6ac959e237de044fe0d8e15a84175c110d159aa28",
        "67c9f13043be7eb64b9349ec88e671f042c16ce9def29a18dce6a9cb06e85dff"),
    2**31 + 101: (
        "1918602c0af18f34b251a452d51b8c7b437fd19ed4c71e6e3076e49c78b74116",
        "d082fd47b97cb0e884adbcb6ac959e237de044fe0d8e15a84175c110d159aa28",
        "67c9f13043be7eb64b9349ec88e671f042c16ce9def29a18dce6a9cb06e85dff"),
}


@pytest.mark.parametrize("seed", sorted(POOL_DIGESTS))
def test_default_pool_bit_identical(seed):
    pool = make_pool(seed, 8192, range(-20, 20, 2))
    got = tuple(hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
                for a in pool)
    assert got == POOL_DIGESTS[seed]
    assert got == tuple(hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
                        for a in make_pool(seed, 8192, range(-20, 20, 2), 128,
                                           "radioml2016.10a"))


def test_2018_pool_at_1024_samples():
    t = time.perf_counter()
    a, la, sa = make_pool(2**31 + 9, 8192, range(-20, 32, 2), 1024, "radioml2018.01a")
    took = time.perf_counter() - t
    print(f"8,192 frames of 1,024 samples, 2018.01A: {took:.2f} s")
    assert took < 10.0
    assert a.shape == (8192, 2, 1024) and a.dtype == np.float32
    assert np.array_equal(la, np.arange(8192) % 24)
    assert len(FRAME_SETS["radioml2018.01a"]) == 24
    assert set(sa) == set(range(-20, 32, 2))
    assert np.all(np.isfinite(a)) and not np.any((a == 0).all(axis=(1, 2)))
    assert np.allclose(np.sqrt((a.astype(np.float64) ** 2).mean(axis=(1, 2)) * 2),
                       1.0, atol=1e-4)
    b, lb, sb = make_pool(2**31 + 9, 8192, range(-20, 32, 2), 1024, "radioml2018.01a")
    c, lc, sc = make_pool(4, 8192, range(-20, 32, 2), 1024, "radioml2018.01a")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(la, lc) and np.array_equal(sa, sc)


def test_unknown_frame_set_refused():
    with pytest.raises(ValueError, match="unknown frame set"):
        make_pool(1, 8, range(-20, 20, 2), 128, "radioml2099")
