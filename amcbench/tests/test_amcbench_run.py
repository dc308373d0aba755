"""A whole run on the CPU at a small size: the last line's schema, the
check catching each fault a served cell can have and the control, and the
entry refusing to run without a card."""
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
