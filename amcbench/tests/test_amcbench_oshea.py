"""The O'Shea-2018 cell's pieces: its configuration states a chained
stack at the published widths, its mix draws RadioML 2018.01A-style
frames of the configuration's 1,024 samples, and ``fused_waves`` reads the
span log's batch records (nothing where there is nothing to read)."""
import json
import math
import pathlib
import types

import numpy as np
import pytest

from amcbench import spec
from amcbench.frames import make_pool
from amcbench.metrics import fused_waves
from repro_torch.obs import trace
from repro_torch.obs.trace import FLUSH_KINDS, SpanLog

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "oshea2018-snn-f32-fused.rml2018-half"
CONFIG = "oshea2018-snn-f32-fused"


def _config():
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    return entry, json.loads((ROOT / entry["file"]).read_text())


def test_the_config_is_the_published_cnn_as_a_chained_snn():
    entry, cfg = _config()
    assert entry["source"].startswith("https://arxiv.org/abs/1712.04578")
    assert entry["reduced"] == cfg["reduced"] == []
    model = cfg["model"]
    convs, fcs = model["conv_specs"], model["fc_specs"]
    assert convs == [[3, 2, 64]] + [[3, 64, 64]] * 6
    assert fcs == [[512, 128], [128, 128], [128, 24]]
    assert (model["input_width"], model["pool"], model["timesteps"],
            model["n_classes"], model["readout"]) == (1024, 2, 8, 24, "current_sum")
    # the check test_configs_state_their_model holds every config to
    assert [ic for _, ic, _ in convs] == [2] + [oc for _, _, oc in convs[:-1]]
    assert fcs[0][0] == convs[-1][2] * model["input_width"] // model["pool"] ** len(convs)
    assert [i for i, _ in fcs[1:]] == [o for _, o in fcs[:-1]]
    assert set(cfg["densities"]) == ({f"conv{i + 1}" for i in range(7)}
                                     | {"fc1", "fc2", "fc3"})
    assert set(cfg["densities"].values()) == {0.2}
    assert (cfg["dtype"], cfg["backend"], cfg["max_batch"]) == ("float32", "cuda_fused", 64)
    assert cfg["limits"] == {"rows_off": 0.01, "answers_off": 0.01}


def test_the_cell_resolves_with_the_2018_frames():
    cell = spec.resolve(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic["frames"] == "radioml2018.01a"
    assert cell.traffic["snr_db"] == [-20, 32, 2] and cell.traffic["rate_fps"] > 0
    assert {m.name for m in cell.end_to_end} == {"latency_p50_ms", "setup_s"}
    assert "fused_waves.latency" in {m.name for m in cell.per_layer}
    # the rate is the one the cell's why states
    why = next(w["why"] for w in BENCH["workloads"] if w["name"] == CELL)
    assert f"{cell.traffic['rate_fps']:,}" in why
    pool, labels, snrs = make_pool(2**31 + 3, 48, range(*cell.traffic["snr_db"]),
                                   length=cell.config["model"]["input_width"],
                                   frames=cell.traffic["frames"])
    assert pool.shape == (48, 2, 1024) and labels.max() < 24
    assert snrs.min() >= -20 and snrs.max() <= 30


def _run(t0=100.0, t1=101.0, device_events=5):
    return types.SimpleNamespace(sub0={"t": t0}, sub1={"t": t1},
                                 trace={"device_events": device_events})


@pytest.fixture
def log(monkeypatch):
    fresh = SpanLog(capacity=64)
    monkeypatch.setattr(trace, "_SPANS", fresh)
    return fresh


def _batch(log, batch, t0, waves):
    c = log.batches.cols
    i = log.batches.reserve()
    c["batch"][i], c["n_real"][i], c["bucket"][i] = batch, 16, 16
    c["kind"][i], c["late_s"][i], c["t0"][i] = FLUSH_KINDS.index("size"), math.nan, t0
    c["waves"][i] = waves
    s = log.spans
    j = s.reserve()
    s.cols["batch"][j], s.cols["t0"][j], s.cols["t1"][j] = batch, t0, t0 + 1e-3


def test_fused_waves_is_the_mean_over_the_windows_batches(log):
    _batch(log, 0, 99.5, 9)          # before the window: never read
    for k, waves in enumerate([4, 4, 1], 1):
        _batch(log, k, 100.0 + 0.1 * k, waves)
    _batch(log, 9, 101.0, 9)         # at the window's end: never read
    assert fused_waves.read(_run(), "fused_waves.latency") == pytest.approx(3.0)


def test_fused_waves_reads_nothing_where_there_is_nothing(log):
    _batch(log, 1, 100.5, 4)
    assert fused_waves.read(_run(102.0, 103.0), "fused_waves.latency") is None
    assert fused_waves.read(_run(device_events=0), "fused_waves.latency") is None
    untraced = types.SimpleNamespace(sub0=None, sub1=None, trace=None)
    assert fused_waves.read(untraced, "fused_waves.latency") is None


def test_fused_waves_reads_nothing_without_a_span_log_or_its_waves(monkeypatch):
    monkeypatch.setattr(trace, "_SPANS", None)
    assert fused_waves.read(_run(), "fused_waves.latency") is None
    # a program whose batch records carry no waves
    monkeypatch.setattr(trace, "span_window", lambda a, b: types.SimpleNamespace(
        batches={"batch": np.arange(3)}))
    assert fused_waves.read(_run(), "fused_waves.latency") is None
