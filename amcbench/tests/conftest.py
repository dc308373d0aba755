"""The benchmark's own tests (CPU; a test marked ``cuda`` skips without a
card).  Run from the repository root: ``python -m pytest -q amcbench/tests``.
Nothing here imports JAX or the JAX package."""
import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# no plan cache on disk from the tests
os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = ""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
