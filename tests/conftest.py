import numpy as np
import pytest

try:
    from hypothesis import settings
except ModuleNotFoundError:
    # Minimal environments run without hypothesis: property tests skip via
    # the tests/_hyp.py shim and the profile setup below is a no-op.
    settings = None

if settings is not None:
    # Keep hypothesis fast and deterministic on CI-class CPU containers.
    settings.register_profile("ci", max_examples=25, deadline=None, derandomize=True)
    settings.load_profile("ci")


@pytest.fixture(autouse=True, scope="session")
def _isolated_plan_cache():
    """Run the whole suite against a memory-only plan cache.

    The default cache's disk tier (~/.cache/repro/plans) must never leak
    into tests: stale pickled artifacts under an unchanged content hash
    would mask regressions in the artifact builders (the golden-counter
    tests are fully deterministic), and test runs must not write into the
    user's real cache directory.
    """
    from repro.plan import PlanCache, default_cache, set_default_cache

    old = default_cache()
    set_default_cache(PlanCache(disk_dir=""))
    yield
    set_default_cache(old)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
