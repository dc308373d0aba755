"""The port's robustness evaluation and scenario hooks held to the live
reference (CPU).

The two packages draw their channel variates from different generators,
so in these tests the port's channel step is monkeypatched to return the
reference's impaired frames (``repro.channel.apply_scenario_np`` on the
same seed); given those, ``evaluate_robustness`` must give the
reference's report exactly (accuracies, confusion matrices, the accuracy
surface, the clean section), with only the wall times and the float of
the largest cross-backend logit difference allowed to differ in the last
bits.  The three scenario hooks (trainer augmentation, trainer
evaluation, pipeline stage) are held to the reference the same way, and
``launch.eval`` runs end to end on the CPU.
"""
import json

import numpy as np
import pytest
import torch

from _torch_parity import port_trainer, ref_trainer, setup
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.channel import apply_scenario_np as ref_apply_scenario_np
from repro.data.pipeline import SpikeBatchPipeline as RefPipeline
from repro.eval import RobustnessConfig as RefRobustnessConfig
from repro.eval import evaluate_robustness as ref_evaluate_robustness
from repro.models.snn import SNNConfig as RefConfig
from repro_torch.data import pipeline
from repro_torch.eval import (
    RobustnessConfig,
    evaluate_robustness,
    format_report,
    robustness,
)
from repro_torch.launch import eval as launch_eval
from repro_torch.models.snn import SNNConfig
from repro_torch.train import trainer as trainer_mod

# the reduced config of .claude/skills/verify/SKILL.md
SPEC = dict(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
            fc_specs=((32, 16), (16, 5)), input_width=16, timesteps=3,
            n_classes=5)
CFG_REF = RefConfig(**SPEC)
CFG = SNNConfig(**SPEC)


def _reference_channel(sc, iq, snrs, seed, *args, **kwargs):
    """The reference's impaired frames for the port's channel step."""
    name = sc if isinstance(sc, str) else sc.name
    return ref_apply_scenario_np(name, iq, snrs, seed)


@pytest.fixture(scope="module")
def weights():
    return setup(CFG_REF, 0, 0.5)


def _without_walls(report):
    report = json.loads(json.dumps(report))
    report.pop("wall_s_by_backend")
    ag = report.get("agreement")
    diff = ag.pop("max_abs_logit_diff") if ag else None
    return report, diff


@pytest.mark.parametrize("suite,snrs", [("quick", (-10.0, 0.5, 0.9, 10.0)),
                                        ("all", (0.0, 18.0))])
def test_report_equals_the_references_on_its_impaired_frames(
        weights, monkeypatch, suite, snrs):
    params, masks, tparams, tmasks = weights
    kw = dict(suite=suite, snr_grid=snrs, frames_per_cell=16,
              backends=("dense", "goap", "stream", "fixed"), seed=3)
    want = ref_evaluate_robustness(params, CFG_REF, RefRobustnessConfig(**kw),
                                   masks=masks)
    monkeypatch.setattr(robustness, "_impair", _reference_channel)
    got = evaluate_robustness(tparams, CFG, RobustnessConfig(**kw),
                              masks=tmasks, device="cpu")
    (g, g_diff), (w, w_diff) = _without_walls(got), _without_walls(want)
    assert g == w
    assert g_diff == pytest.approx(w_diff, abs=1e-5)
    assert set(got["wall_s_by_backend"]) == set(kw["backends"])
    assert format_report(got).splitlines()[:-1] == \
        format_report(want).splitlines()[:-1]


def test_report_structure_and_determinism(weights):
    _, _, tparams, tmasks = weights
    ecfg = RobustnessConfig(suite="quick", snr_grid=(0.0, 10.0),
                            frames_per_cell=8, backends=("dense", "goap"),
                            seed=3)
    rep = evaluate_robustness(tparams, CFG, ecfg, masks=tmasks, device="cpu")
    assert list(rep["scenarios"]) == ["static_awgn", "doppler_drift"]
    for s in rep["scenarios"].values():
        assert set(s["per_snr"]) == {"+0.0", "+10.0"}
        for cell in s["per_snr"].values():
            cm = np.asarray(cell["confusion"])
            assert cm.shape == (CFG.n_classes, CFG.n_classes)
            assert cm.sum() == 8 == cell["n_frames"]
            assert set(cell["accuracy"]) == {"dense", "goap"}
    assert np.asarray(rep["surface"]["accuracy"]).shape == (2, 2)
    assert rep["agreement"]["agrees"]
    assert "clean" in rep and set(rep["clean"]) == {"+0.0", "+10.0"}
    again = evaluate_robustness(tparams, CFG, ecfg, masks=tmasks,
                                device="cpu")
    assert _without_walls(again) == _without_walls(rep)
    # scenario objects override the suite
    one = evaluate_robustness(
        tparams, CFG, RobustnessConfig(snr_grid=(0.0,), frames_per_cell=4,
                                       include_clean=False),
        masks=tmasks, scenarios=["iq_impaired"], device="cpu")
    assert list(one["scenarios"]) == ["iq_impaired"] and "clean" not in one
    assert "agreement" not in one


def test_evaluation_needs_a_card_unless_asked(weights, monkeypatch):
    _, _, tparams, tmasks = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_robustness(tparams, CFG, masks=tmasks)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_eval.main(["--reduced", "--suite", "quick", "--frames", "2"])


def test_launch_eval_writes_a_report_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = launch_eval.main(["--reduced", "--suite", "quick", "--device", "cpu",
                           "--frames", "8", "--snr", "0,10",
                           "--backend", "goap,dense", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "accuracy surface [goap]" in text and "OK" in text
    report = json.loads(out.read_text())
    assert report["config"]["model"]["input_width"] == 32
    assert report["config"]["scenarios"] == ["static_awgn", "doppler_drift"]
    assert report["agreement"]["agrees"]


def test_launch_eval_exits_1_when_backends_disagree(tmp_path, capsys):
    """The integer tier's logits differ from the float backends' by its
    quantization, far beyond the 1e-5 agreement tolerance."""
    rc = launch_eval.main(["--reduced", "--suite", "static_awgn",
                           "--device", "cpu", "--frames", "4", "--snr", "10",
                           "--backend", "goap,fixed", "--no-clean",
                           "--out", str(tmp_path / "r.json")])
    assert rc == 1 and "FAIL: backends disagree" in capsys.readouterr().out


def test_launch_eval_from_a_registry(tmp_path, capsys):
    from repro_torch.deploy import ModelRegistry
    from repro_torch.models.snn import init_snn
    from repro_torch.train.lsq import init_lsq_scales
    from repro_torch.train.pruning import make_mask_pytree

    cfg = SNNConfig(**launch_eval.REDUCED_SMOKE_CFG)
    params = init_snn(4, cfg)
    reg = ModelRegistry(str(tmp_path / "reg"), device="cpu")
    reg.publish("amc", params, cfg, masks=make_mask_pytree(params, 0.5),
                lsq_scales=init_lsq_scales(params, 8), quant_bits=8,
                alias="production")
    rc = launch_eval.main(["--registry", str(tmp_path / "reg"),
                           "--model", "amc@production", "--device", "cpu",
                           "--suite", "static_awgn", "--frames", "4",
                           "--snr", "10", "--out", str(tmp_path / "r.json")])
    assert rc == 0 and "registry: evaluating amc@1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the three scenario hooks, on the reference's impaired frames
# ---------------------------------------------------------------------------

def test_trainer_augmentation_matches_reference(monkeypatch):
    ref = ref_trainer(augment_scenario="urban_fading", final_density=0.5,
                      prune_every=2)
    tr = port_trainer(ref.params, augment_scenario="urban_fading",
                      final_density=0.5, prune_every=2)
    monkeypatch.setattr(trainer_mod, "apply_scenario_np", _reference_channel)
    r_hist = ref.run(steps=4, log_every=1)
    p_hist = tr.run(steps=4, log_every=1)
    np.testing.assert_allclose(p_hist["loss"], r_hist["loss"], rtol=0,
                               atol=1e-4)
    assert len(set(np.round(r_hist["loss"], 4))) > 1


def test_trainer_scenario_evaluation_matches_reference(monkeypatch):
    ref = ref_trainer()
    tr = port_trainer(ref.params)
    monkeypatch.setattr(trainer_mod, "apply_scenario_np", _reference_channel)
    for scenario in ("doppler_drift", "adjacent_interferer"):
        assert tr.evaluate(n_batches=2, snr_db=0.0, scenario=scenario) == \
            ref.evaluate(n_batches=2, snr_db=0.0, scenario=scenario)


def test_pipeline_scenario_stage_matches_reference(monkeypatch):
    monkeypatch.setattr(pipeline, "apply_scenario_np", _reference_channel)
    pipe = pipeline.SpikeBatchPipeline(batch_size=4, osr=3, seed=2,
                                       prefetch=2, device="cpu",
                                       scenario="iq_impaired")
    ref = RefPipeline(batch_size=4, osr=3, seed=2, prefetch=2,
                      scenario="iq_impaired")
    try:
        for _ in range(2):
            frames, labels, snrs = next(pipe)
            r_frames, r_labels, r_snrs = next(ref)
            np.testing.assert_array_equal(frames.numpy(), np.asarray(r_frames))
            np.testing.assert_array_equal(labels.numpy(), np.asarray(r_labels))
            np.testing.assert_array_equal(snrs, np.asarray(r_snrs))
    finally:
        pipe.close()
        ref.close()
