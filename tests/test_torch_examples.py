"""The five SNN examples of the port (``repro_torch.examples``) run on the
CPU with tiny budgets, and their reported numbers held to the reference's
functions on the same weights.

Quickstart: the stream schedule's counters and totals, and the layer-1
SW / GOAP event counts, equal to ``repro``'s ``stream`` backend and cost
model on the example's weights and frames.  ``amc_serve``: the served
requests' exact accumulations and fetched bits equal to the reference's
``count_batch_activity`` on the trained weights and the same frames, and
the Table V power line equal to the reference's ``PowerModel`` on those
rates.  ``amc_train``, ``amc_deploy`` and ``snn_pipeline`` exit 0 with
their report lines (the pipeline's logits are held to the reference in
``tests/test_torch_distributed.py``).
"""
import argparse

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_parity import PAPER_REF
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.api import compile_snn as ref_compile_snn
from repro.api import stream_totals as ref_stream_totals
from repro.core import cost_model as ref_cost
from repro.core.lif import LIFParams as RefLIF
from repro.core.saocds import pad_same as ref_pad_same
from repro.core.sparse_format import coo_from_dense as ref_coo_from_dense
from repro.data.pipeline import sigma_delta_encode_np as ref_encode
from repro.models.snn import sparsify_params as ref_sparsify
from repro.serve import ServeStats as RefStats
from repro.serve.engine import count_batch_activity as ref_count
from repro_torch.core.cost_model import bits_fetched
from repro_torch.examples import (amc_deploy, amc_serve, amc_train, quickstart,
                                  snn_pipeline)


def _ref_params(params):
    """Port params -> the reference's pytree (jax arrays)."""
    def layer(lp):
        lif = lp["lif"]
        return {"w": jnp.asarray(lp["w"].numpy()),
                "lif": RefLIF(jnp.asarray(lif.alpha_logit.numpy()),
                              jnp.asarray(lif.theta.numpy()),
                              jnp.asarray(lif.v_th.numpy()))}
    return {g: [layer(lp) for lp in params[g]] for g in ("conv", "fc")}


def _ref_masks(masks):
    return {g: [jnp.asarray(m.numpy()) for m in masks[g]]
            for g in ("conv", "fc")}


def test_quickstart_counts_equal_the_reference_on_its_weights(capsys):
    out = quickstart.run(argparse.Namespace(device="cpu"))
    text = capsys.readouterr().out
    assert "stream schedule:" in text and "layer-1 events" in text
    assert out["goap_err"] < 1e-3
    params, masks = _ref_params(out["params"]), _ref_masks(out["masks"])
    frames = out["frames"]
    _, counters = ref_compile_snn(PAPER_REF).apply(
        params, jnp.asarray(frames[0]), "stream", masks=masks,
        return_counters=True)
    want = ref_stream_totals(counters)
    assert out["stream_totals"] == {k: float(v) for k, v in want.items()}
    kw, ic, oc = PAPER_REF.conv_specs[0]
    coo = ref_coo_from_dense(np.asarray(params["conv"][0]["w"]
                                        * masks["conv"][0]))
    f0 = np.asarray(ref_pad_same(jnp.asarray(frames[0]), coo.kw))
    sw, gp = ref_cost.sw_conv_counts(f0, (kw, ic, oc)), \
        ref_cost.goap_conv_counts(f0, coo)
    assert (out["sw"].accumulations, out["goap"].accumulations) == \
        (sw.accumulations, gp.accumulations)
    assert (ref_cost.bits_fetched(sw), ref_cost.bits_fetched(gp)) == \
        (bits_fetched(out["sw"]), bits_fetched(out["goap"]))


def test_amc_serve_power_lines_equal_the_reference_on_its_weights(capsys):
    out = amc_serve.run(argparse.Namespace(
        device="cpu", requests=8, train_steps=2, density=0.5,
        backend="goap", max_batch=8, max_delay_ms=5.0))
    text = capsys.readouterr().out
    assert "activity-model dynamic power" in text and "paper Table V" in text
    assert len(out["predictions"]) == 8
    stats = RefStats()
    ref_count(stats, ref_sparsify(_ref_params(out["params"]),
                                  _ref_masks(out["masks"])),
              ref_encode(out["iq"], PAPER_REF.timesteps), PAPER_REF)
    assert (out["accumulations"], out["fetched_bits"]) == \
        (stats.accumulations, stats.fetched_bits)
    pm = ref_cost.PowerModel(**amc_serve.POWER_MODEL)
    wall = max(out["wall_s"], 1e-9)
    assert out["watts"] == pytest.approx(
        pm.predict(stats.accumulations / wall, stats.fetched_bits / wall, 0.5),
        rel=1e-12)
    assert out["paper_watts"] == ref_cost.PAPER_TABLE5[0.5][0]


@pytest.mark.parametrize("module,argv,line", [
    (amc_train, ["--steps", "2", "--batch", "8"], "checkpoint resume at step 2"),
    (amc_deploy, ["--train-steps", "10", "--requests", "32"], "[5/5]"),
    (snn_pipeline, [], "4-stage pipeline vs single-device forward"),
], ids=["amc_train", "amc_deploy", "snn_pipeline"])
def test_example_runs_on_the_cpu(module, argv, line, capsys):
    assert module.main(argv + ["--device", "cpu"]) == 0
    assert line in capsys.readouterr().out
