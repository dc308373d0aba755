"""The port's package facades export what the reference's export.

For ``repro/api.py`` and every reference package ``__init__`` with an
``__all__``, the names are read with ``ast`` (nothing of the reference is
imported), each traced to the reference module that defines it.  A name
whose defining module has a port counterpart (``repro.x.y`` ->
``repro_torch.x.y``) that defines it must import from the port's matching
package, and stand in that package's ``__all__`` in the reference's
order.  The names whose modules are not ported yet are listed below; the
test fails when one of them turns out to be ported, so the list shrinks
as the port grows.
"""
import ast
import importlib
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF_EXPORTS = sorted([SRC / "repro" / "api.py"]
                     + [p for p in (SRC / "repro").glob("*/__init__.py")
                        if "__all__" in p.read_text()])

# exporting reference module -> the names it exports whose defining
# modules are not ported yet (ROADMAP Queue 1: channel scenarios and
# eval/, item 4; deploy/, fleet/ and model versions, item 5; the obs
# analysis plane, item 6; distributed/, item 7)
_CHANNEL = ["ChannelScenario", "SCENARIOS", "apply_scenario",
            "make_frame_source"]
_OBS_PLANE = [
    "MetricsServer", "alert_health_check", "engine_health_check",
    "engine_ready_probe", "Series", "TimeSeriesRecorder",
    "get_default_recorder", "set_default_recorder", "SLO", "SLOStatus",
    "BurnWindow", "BurnRateEngine", "DEFAULT_BURN_WINDOWS", "scaled_windows",
    "parse_slo_spec", "default_serve_slos", "EwmaDetector", "Alert",
    "AlertManager", "WatchSpec", "default_drift_watches", "SeriesWatcher",
    "BurnRateWatcher", "autoscaler_sink", "canary_shadow_sink",
    "log_file_sink", "set_default_alert_manager", "get_default_alert_manager",
    "to_perfetto", "write_perfetto", "validate_perfetto"]
WAITING = {
    "repro.api": _CHANNEL + ["RobustnessConfig", "evaluate_robustness"],
    "repro.channel": _CHANNEL + [
        "SUITES", "get_scenario", "suite_scenarios", "apply_scenario_np",
        "scenario_fn", "stable_seed", "to_complex", "to_iq", "avg_power",
        "normalize_power", "awgn", "carrier_offset", "phase_noise",
        "timing_offset", "iq_imbalance", "multipath_fading",
        "interferer_tones"],
    "repro.deploy": [
        "ModelRegistry", "ModelVersion", "LoadedModel",
        "publish_from_checkpoint", "publish_from_trainer", "SwapReport",
        "hot_swap", "hot_swap_async", "hot_swap_from_registry",
        "WeightedRouter", "canary_router", "CanaryMonitor", "MonitorConfig",
        "WindowResult"],
    "repro.distributed": [
        "activation_constraints", "constrain_acts", "constrain_logits",
        "act_pspec", "decode_state_specs", "dp_axes", "logits_pspec",
        "named_tree", "partition_params", "train_batch_spec"],
    "repro.eval": ["RobustnessConfig", "evaluate_robustness", "format_report",
                   "stable_cell_seed"],
    "repro.fleet": ["FleetRouter", "Replica", "ShedError", "engine_factory",
                    "merge_stats", "Autoscaler", "AutoscaleTick"],
    "repro.obs": _OBS_PLANE,
    "repro.serve": ["BoundVersion"],
}


def _exports(path: pathlib.Path):
    """(module name, __all__, {name: defining module}) of one reference file."""
    module = ".".join(path.relative_to(SRC).with_suffix("").parts)
    module = module.removesuffix(".__init__")
    package = module if path.name == "__init__.py" else module.rsplit(".", 1)[0]
    names, origin = None, {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names = ast.literal_eval(node.value)
        elif isinstance(node, ast.ImportFrom):
            source = node.module or ""
            if node.level:   # relative import inside the package
                base = package.split(".")[: len(package.split(".")) - node.level + 1]
                source = ".".join(base + ([source] if source else []))
            for alias in node.names:
                origin[alias.asname or alias.name] = source
    return module, names, origin


def _port(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def _port_defines(module: str, name: str) -> bool:
    try:
        return hasattr(importlib.import_module(_port(module)), name)
    except ImportError:
        return False


@pytest.mark.parametrize("path", REF_EXPORTS,
                         ids=lambda p: str(p.relative_to(SRC)))
def test_port_package_exports_every_ported_reference_name(path):
    module, names, origin = _exports(path)
    ported = [n for n in names if _port_defines(origin.get(n, module), n)]
    waiting = [n for n in names if n not in ported]
    assert sorted(waiting) == sorted(WAITING.get(module, [])), (
        "a waiting name is ported (take it off WAITING and export it), or a "
        "ported name lost its definition")
    if not ported:
        return
    package = importlib.import_module(_port(module))
    missing = [n for n in ported if not hasattr(package, n)]
    assert not missing, f"{_port(module)} does not export {missing}"
    in_all = [n for n in package.__all__ if n in ported]
    assert in_all == ported, f"{_port(module)}.__all__ lacks or reorders names"


def test_every_reference_facade_is_checked():
    modules = {_exports(p)[0] for p in REF_EXPORTS}
    assert {"repro.api", "repro.obs", "repro.serve", "repro.plan"} <= modules
    assert set(WAITING) <= modules
