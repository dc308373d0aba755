"""BENCHMARK.json against the contract's shape, and every name resolving
to its files."""
import json
import math
import pathlib
import re

import pytest

from amcbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["amcbench"]
    assert BENCH["command"] == ["python3", "amcbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.resolve(ROOT, cell)
    assert c.config["backend"] and c.traffic["loop"] == "open"
    assert spec.arrivals(c.traffic["arrivals"]).offsets
    assert isinstance(c.traffic["rate_fps"], (int, float))
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        if m.name != "setup_s":
            assert callable(spec.reader(m).read), m.name
        if m.name.endswith("_roofline"):
            w = spec.work(m.name[:-len("_roofline")])
            assert w.KERNEL and callable(w.ops_and_bytes)
        # a per-layer metric is reported where its end-to-end metric is
        if m.moves is not None:
            assert m.moves in names


PAPER = "https://arxiv.org/abs/2601.02613"


def test_configs_state_their_model():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        model = cfg["model"]
        if c["source"].startswith(PAPER):
            assert cfg["reduced"] == []
            assert model["conv_specs"] == [[11, 2, 16], [11, 16, 32], [5, 32, 64]]
            assert model["fc_specs"] == [[1024, 128], [128, 11]]
        # any stack: convs chained from the two I/Q channels, the first FC
        # fed by the last conv's pooled output, the last FC the classes
        convs, fcs = model["conv_specs"], model["fc_specs"]
        assert [ic for _, ic, _ in convs] == [2] + [oc for _, _, oc in convs[:-1]]
        width = model["input_width"] // model["pool"] ** len(convs)
        assert fcs[0][0] == convs[-1][2] * width
        assert [i for i, _ in fcs[1:]] == [o for _, o in fcs[:-1]]
        assert fcs[-1][1] == model["n_classes"]
        assert set(cfg["densities"]) == (
            {f"conv{i + 1}" for i in range(len(convs))}
            | {f"fc{i + 1}" for i in range(len(fcs))})
        assert cfg["limits"] and all(math.isfinite(v) for v in cfg["limits"].values())


def _root(tmp_path, frames):
    """A root holding only a BENCHMARK.json, a config and a traffic file."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "amcbench" / "traffic").mkdir(parents=True)
    (tmp_path / "configs" / "c.json").write_text(
        (ROOT / "amcbench" / "configs" / "snn-f32-fused.json").read_text())
    traffic = {"loop": "open", "arrivals": "poisson", "rate_fps": 10,
               "pool_frames": 24, "snr_db": [-20, 32, 2], "warm_s": 0.5}
    if frames is not None:
        traffic["frames"] = frames
    (tmp_path / "amcbench" / "traffic" / "t.json").write_text(json.dumps(traffic))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "c", "file": "configs/c.json"}],
        "workloads": [{"name": "c.t", "config": "c", "traffic": "t", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}))
    return tmp_path


@pytest.mark.parametrize("frames", [None, "radioml2016.10a", "radioml2018.01a"])
def test_traffic_read_under_the_given_root(tmp_path, frames):
    cell = spec.resolve(_root(tmp_path, frames), "c.t")
    assert cell.traffic["pool_frames"] == 24
    assert cell.traffic.get("frames") == frames


def test_unknown_frame_set_refused(tmp_path):
    with pytest.raises(ValueError, match="frame set 'radioml2099'"):
        spec.resolve(_root(tmp_path, "radioml2099"), "c.t")
