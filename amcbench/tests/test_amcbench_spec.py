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


def test_configs_state_their_model():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["model"]["conv_specs"] == [[11, 2, 16], [11, 16, 32], [5, 32, 64]]
        assert cfg["model"]["fc_specs"] == [[1024, 128], [128, 11]]
        assert cfg["limits"] and all(math.isfinite(v) for v in cfg["limits"].values())
