"""The port stands alone: no jax and nothing of the reference package.

The import check runs in a subprocess, because this test process already
holds jax (``tests/conftest.py`` imports ``repro.plan``).
"""
import json
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
print(json.dumps({"imported": names, "forbidden": loaded}))
"""


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == []
    want = {m.name for m in pkgutil.walk_packages([str(PKG)], "repro_torch.")}
    assert want <= set(result["imported"])
    assert "repro_torch.kernels.stream_fused" in result["imported"]


# the modules of the measurement plane, the integer tier, the training
# path, the paper's table scripts, the backend race, the plan cache's disk
# tier, the channel scenarios, the robustness evaluation, the model
# lifecycle, the fleet, the obs analysis plane, the served step's capture,
# the serving CLI, the trainer's captured step, the SNN's distributed
# pieces, the examples, the language-model zoo and its production cells
# (sharding rules, meshes, steps, roofline, dry-runs), each imported alone in
# a fresh interpreter
_ALONE = ["repro_torch.fixed", "repro_torch.obs.activity",
          "repro_torch.obs.metrics", "repro_torch.core.cost_model",
          "repro_torch.train.lsq", "repro_torch.data.radioml",
          "repro_torch.data.pipeline", "repro_torch.channel.impairments",
          "repro_torch.train.optimizer", "repro_torch.train.checkpoint",
          "repro_torch.train.trainer", "repro_torch.configs.saocds_amc",
          "repro_torch.launch.train", "repro_torch.tree",
          "repro_torch.bench.table1_goap_vs_sw",
          "repro_torch.bench.table2_coo_overhead",
          "repro_torch.bench.table3_accum_ratio",
          "repro_torch.bench.table45_perf_model",
          "repro_torch.bench.accuracy_sweep", "repro_torch.serve.autotune",
          "repro_torch.plan.cache", "repro_torch.channel",
          "repro_torch.channel.scenario", "repro_torch.eval",
          "repro_torch.eval.robustness", "repro_torch.launch.eval",
          "repro_torch.deploy", "repro_torch.deploy.registry",
          "repro_torch.deploy.router", "repro_torch.deploy.swap",
          "repro_torch.deploy.monitor", "repro_torch.fleet",
          "repro_torch.fleet.router", "repro_torch.fleet.autoscaler",
          "repro_torch.obs", "repro_torch.obs.timeseries",
          "repro_torch.obs.slo", "repro_torch.obs.anomaly",
          "repro_torch.obs.export", "repro_torch.obs.http",
          "repro_torch.serve.capture", "repro_torch.kernels.launches",
          "repro_torch.launch.serve", "repro_torch.train.capture",
          "repro_torch.distributed", "repro_torch.distributed.sharding",
          "repro_torch.distributed.pipeline",
          "repro_torch.distributed.compression", "repro_torch.examples",
          "repro_torch.examples.quickstart", "repro_torch.examples.amc_train",
          "repro_torch.examples.amc_serve", "repro_torch.examples.amc_deploy",
          "repro_torch.examples.snn_pipeline",
          "repro_torch.models.config", "repro_torch.models.layers",
          "repro_torch.models.lm", "repro_torch.models.whisper",
          "repro_torch.configs", "repro_torch.configs.registry",
          "repro_torch.distributed.ctx", "repro_torch.convert",
          "repro_torch.examples.lm_pretrain", "repro_torch.launch.mesh",
          "repro_torch.launch.steps", "repro_torch.launch.roofline",
          "repro_torch.launch.dryrun", "repro_torch.launch.pp_dryrun"]


@pytest.mark.parametrize("module", _ALONE)
def test_importing_a_measurement_module_alone_loads_no_jax(module):
    probe = ("import importlib, json, sys; importlib.import_module(%r); "
             "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
             "or m.startswith('jax.') or m == 'repro' "
             "or m.startswith('repro.'))))" % module)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                        r"|from\s+repro(\.|\s)(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    [p for p in PKG.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_never_import_jax_or_reference(path):
    assert path.exists(), path
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports jax or the reference: {hits}"
