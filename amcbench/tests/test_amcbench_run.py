"""A whole run on the CPU at a small size: the last line's schema, the
check catching each fault a served cell can have and the control, a
configuration with frames of its own added as files alone, and the entry
refusing to run without a card."""
import ast
import json
import pathlib
import subprocess
import sys
import time

import pytest

from amcbench import faults
from amcbench.harness import run_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
# a small pool and a low offered rate: the CPU runs the kernels' plain
# versions, a batch in tens to hundreds of milliseconds
LIGHT = dict(pool_frames=96, rate_fps=40.0)


def small_run(cell, seconds=2.0, trace=False, **kwargs):
    return run_cell(ROOT, cell, 2**31 + 101, seconds, trace,
                    time.perf_counter(), "cpu", **{**LIGHT, **kwargs})


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(trace):
    out = small_run("snn-bf16-layered.light", trace=trace)
    line = json.loads(json.dumps(out["line"]))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    want = ({"batch_fill.latency", "worker_busy.latency", "step_ms.latency", "step_mfu"}
            if trace
            else {"latency_p50_ms", "setup_s"})
    # on the CPU there is no device trace: its metrics are left out
    assert set(line["metrics"]) == want
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    # the timeout flushes' lateness past their own hold, from the span
    # log's batch records, which only the traced window has
    late = out["info"].get("flush_late_ms")
    if trace:
        assert late["batches"] > 0 and late["p50"] >= 0 and late["p99"] >= late["p50"]
        assert 0 < late["hold_p50"] <= 5.0
    else:
        assert late is None


# the O'Shea-Roy-Clancy RadioML 2018.01A stack (seven k3 convs, each pooled
# by 2, FC to 128, 128 and 24) at 4 channels a conv and 16 FC units
SNN_2018 = {
    "model": {"conv_specs": [[3, 2, 4]] + [[3, 4, 4]] * 6, "pool": 2,
              "fc_specs": [[32, 16], [16, 16], [16, 24]], "input_width": 1024,
              "timesteps": 8, "n_classes": 24, "readout": "current_sum",
              "lif_alpha": 0.9, "lif_theta": 1.0, "lif_v_th": 1.0},
    "dtype": "float32",
    "densities": {**{f"conv{i}": 0.5 for i in range(1, 8)},
                  "fc1": 0.5, "fc2": 0.5, "fc3": 0.5},
    "backend": "cuda", "max_batch": 16, "max_delay_ms": 5.0, "reduced": [],
    "limits": {"rows_off": 0.01, "answers_off": 0.01},
}


def root_with_new_files(tmp_path):
    """A root holding nothing but a BENCHMARK.json, the config and a
    2018.01A traffic file: a configuration added as files alone."""
    (tmp_path / "amcbench" / "configs").mkdir(parents=True)
    (tmp_path / "amcbench" / "traffic").mkdir()
    (tmp_path / "amcbench" / "configs" / "snn-2018-small.json").write_text(
        json.dumps(SNN_2018))
    (tmp_path / "amcbench" / "traffic" / "light2018.json").write_text(json.dumps(
        {"loop": "open", "arrivals": "poisson", "rate_fps": 20, "pool_frames": 48,
         "snr_db": [-20, 32, 2], "warm_s": 0.5, "frames": "radioml2018.01a"}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "snn-2018-small",
                     "file": "amcbench/configs/snn-2018-small.json"}],
        "workloads": [{"name": "snn-2018-small.light2018", "config": "snn-2018-small",
                       "traffic": "light2018", "chips": 1}],
        "end_to_end": [{"name": "latency_p50_ms", "unit": "ms"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "batch_fill.latency", "unit": "frac",
                       "moves": "latency_p50_ms"}]}))
    return tmp_path


def test_a_config_with_its_own_frames_added_as_files(tmp_path):
    root = root_with_new_files(tmp_path)
    runs = {name: run_cell(root, "snn-2018-small.light2018", 2**31 + 101, 1.5,
                           False, time.perf_counter(), "cpu", override=override)
            for name, override in (("served", None), ("altered", faults.altered))}
    assert runs["served"]["run"].pool.shape == (48, 2, 1024)
    assert runs["served"]["line"]["correct"] is True, runs["served"]["info"]["numbers"]
    assert set(runs["served"]["line"]["metrics"]) == {"latency_p50_ms", "setup_s"}
    assert runs["altered"]["line"]["correct"] is False, runs["altered"]["info"]["numbers"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault):
    out = small_run("snn-bf16-layered.light", override=faults.FAULTS[fault])
    assert out["line"]["correct"] is False, out["info"]["numbers"]


def test_fault_is_not_correct_in_full_batches():
    # offered faster than the CPU serves: a backlog, so every batch is full
    out = small_run("snn-f32-fused.steady", seconds=0.5, override=faults.altered,
                    pool_frames=128, rate_fps=1000.0)
    assert out["info"]["window"]["padded"] == 0
    assert out["line"]["correct"] is False, out["info"]["numbers"]


@pytest.mark.parametrize("cell", ["snn-f32-fused.steady", "snn-bf16-layered.light"])
def test_control_is_not_correct(cell):
    out = small_run(cell, override=faults.control)
    assert out["line"]["correct"] is False, out["info"]["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["snn-f32-fused.steady", "snn-bf16-layered.light"])
def test_control_is_not_correct_on_the_card(card, cell):
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        out = run_cell(ROOT, cell, seed, 5.0, False, time.perf_counter(), "cuda",
                       override=faults.control)
        assert out["line"]["correct"] is False, out["info"]["numbers"]


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "amcbench" / "run.py"),
                        "--workload", "snn-f32-fused.steady", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_module_walk_no_jax():
    files = sorted((ROOT / "amcbench").rglob("*.py"))
    assert files
    for f in files:
        tops = set(imported_tops(f))
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
        assert "benchmarks" not in tops, f


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "amcbench" / "reference").rglob("*.py"):
        assert "repro_torch" not in set(imported_tops(f)), f


def test_whole_name_compare():
    sys.path.insert(0, str(ROOT / "amcbench"))
    try:
        import run as entry
    finally:
        sys.path.remove(str(ROOT / "amcbench"))
    import repro_torch  # noqa: F401  the port's name begins with "repro"

    assert "repro" not in entry.forbidden_modules()
