"""The port's paper scripts (``repro_torch.bench``) against the live
reference scripts (``benchmarks/``, loaded by file path), on the CPU.

Tables I, II and IV-V depend on no random weights and must be equal
exactly.  Table III and the accuracy sweep depend on the init, which is
a jax key in the reference and a numpy seed in the port, so they are
held to the reference on identical weights: one reference ``init_snn``
call, handed to both scripts.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import jax

from _torch_parity import PAPER, PAPER_REF, masks_to_numpy, params_to_numpy
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.api import init_snn as ref_init_snn
from repro.train.pruning import make_mask_pytree as ref_masks
from repro_torch.bench import (
    accuracy_sweep,
    table1_goap_vs_sw,
    table2_coo_overhead,
    table3_accum_ratio,
    table45_perf_model,
)
from repro_torch.convert import masks_from_numpy, params_from_numpy

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"


def _reference(name: str):
    """A reference script module, loaded from ``benchmarks/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  BENCH / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref_params():
    return ref_init_snn(jax.random.PRNGKey(0), PAPER_REF)


@pytest.mark.parametrize("port", [table1_goap_vs_sw, table2_coo_overhead,
                                  table45_perf_model],
                         ids=lambda m: m.NAME)
def test_weight_free_tables_equal_the_reference(port):
    ref = _reference(port.NAME)
    assert port.NAME == ref.NAME
    got, want = port.run(), ref.run()
    assert got == want
    assert port.format_table(got) == ref.format_table(want)


def test_tables_1_and_2_match_the_paper():
    assert table1_goap_vs_sw.run()["exact"]["match"]
    assert all(r["match"] for r in table2_coo_overhead.run()["rows"])


def test_table3_equals_the_reference_on_identical_weights(monkeypatch,
                                                          ref_params):
    ref = _reference(table3_accum_ratio.NAME)
    monkeypatch.setattr(ref, "init_snn", lambda key, cfg: ref_params)
    monkeypatch.setattr(table3_accum_ratio, "init_snn", lambda seed, cfg:
                        params_from_numpy(params_to_numpy(ref_params)))
    want = ref.run(n_samples=2)
    got = table3_accum_ratio.run(n_samples=2, device="cpu")
    assert got["n_frames"] == want["n_frames"] == 2 * PAPER.timesteps
    for g, w in zip(got["rows"], want["rows"]):
        assert g["sparsity"] == w["sparsity"]
        assert g["ratios_pct"] == w["ratios_pct"]
        assert g["max_err_vs_linear"] == w["max_err_vs_linear"]
    assert table3_accum_ratio.format_table(got) == ref.format_table(want)


@pytest.mark.parametrize("density,quant", [(1.0, False), (1.0, True),
                                           (0.25, False), (0.25, True)])
def test_accuracy_eval_predictions_equal_the_reference(ref_params, density,
                                                       quant):
    ref = _reference(accuracy_sweep.NAME)
    masks = None if density >= 1.0 else ref_masks(ref_params, density)
    want, want_labels = ref._eval(ref_params, PAPER_REF, masks=masks,
                                  quant=quant, n=32)
    got, labels = accuracy_sweep._eval(
        params_from_numpy(params_to_numpy(ref_params)), PAPER,
        masks=None if masks is None else masks_from_numpy(masks_to_numpy(masks)),
        quant=quant, n=32, device="cpu")
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_accuracy_sweep_returns_the_reference_keys():
    want = _reference(accuracy_sweep.NAME).run(steps=2, batch=4)
    got = accuracy_sweep.run(steps=2, batch=4, device="cpu")
    assert set(got) == set(want) and got["steps"] == 2
    for key in ("snr", "density"):
        assert [sorted(r) for r in got[key]] == [sorted(r) for r in want[key]]
        first = next(iter(got[key][0]))
        assert [r[first] for r in got[key]] == [r[first] for r in want[key]]
    assert all(0.0 <= r["accuracy"] <= 1.0 for r in got["snr"])
    assert np.isfinite(got["final_train_loss"])
    assert accuracy_sweep.format_table(got).splitlines()[0].startswith(
        "Fig. 8 / Table V accuracy (trained 2 steps")
