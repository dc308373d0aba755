"""Port backend race: the autotuner contracts of tests/test_serve.py and
tests/test_plan.py on port engines (CPU), and the plan's cost priors
against the live reference's on the same weights."""
import numpy as np
import pytest
import torch

from _torch_parity import PAPER, PAPER_REF, SMALL, SMALL_REF, setup
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.api import compile_plan as ref_compile_plan
from repro.api import compile_snn as ref_compile_snn
from repro.plan import PlanCache as RefPlanCache
from repro_torch.api import compile_snn, register_backend
from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.models import graph
from repro_torch.plan import PlanCache, compile_plan
from repro_torch.serve import (
    AsyncAMCServeEngine,
    autotune_backend,
    autotune_per_layer,
    default_candidates,
)
from repro_torch.serve.autotune import _disqualify

ATOL = 1e-5
WEIGHTED = {"conv1", "conv2", "fc1", "fc2"}
# the reference's backend names -> the port's
PORT_NAME = {"dense": "dense", "goap": "goap", "stream": "stream",
             "pallas": "cuda"}


@pytest.fixture(scope="module")
def weights():
    return setup(SMALL_REF, 0, 0.5)


@pytest.fixture
def boom_backend():
    """A backend whose every factory raises, registered for one test."""
    def _boom(spec, layer_params, **kw):
        raise RuntimeError("no such accelerator")

    snapshot = dict(graph._REGISTRY)
    register_backend("boom", "conv_lif", _boom)
    register_backend("boom", "fc_lif", _boom)
    yield "boom"
    graph._REGISTRY.clear()
    graph._REGISTRY.update(snapshot)


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 2, SMALL.input_width)).astype(np.float32)


def _goap_preds(tparams, tmasks, iq):
    frames = torch.from_numpy(sigma_delta_encode_np(iq, SMALL.timesteps))
    return compile_snn(SMALL).apply_batch(tparams, frames, "goap", masks=tmasks,
                                          device="cpu").argmax(-1).numpy()


# ---------------------------------------------------------------------------
# whole-network race (tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_autotuner_picks_a_winner(weights):
    _, _, tparams, tmasks = weights
    report = autotune_backend(
        compile_snn(SMALL), tparams, (4, SMALL.timesteps, 2, SMALL.input_width),
        masks=tmasks, candidates=("dense", "goap"), reps=1, device="cpu")
    assert report.choice in ("dense", "goap")
    assert set(report.timings_ms) == {"dense", "goap"}
    assert not report.errors and not report.fell_back
    assert report.summary()["batch_shape"] == [4, SMALL.timesteps, 2,
                                               SMALL.input_width]


def test_autotuner_falls_back_to_goap_when_backend_raises(weights, boom_backend):
    _, _, tparams, tmasks = weights
    shape = (4, SMALL.timesteps, 2, SMALL.input_width)
    report = autotune_backend(compile_snn(SMALL), tparams, shape, masks=tmasks,
                              candidates=(boom_backend,), device="cpu")
    assert report.choice == "goap" and report.fell_back
    assert "RuntimeError" in report.errors[boom_backend]
    # a raising candidate is excluded, not fatal, when others survive
    report = autotune_backend(compile_snn(SMALL), tparams, shape, masks=tmasks,
                              candidates=(boom_backend, "dense"), reps=1,
                              device="cpu")
    assert report.choice == "dense" and not report.fell_back
    assert boom_backend in report.errors


def test_async_engine_auto_backend(weights):
    _, _, tparams, tmasks = weights
    iq = _iq(5)
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu",
                             max_batch=4, max_delay_ms=5.0,
                             warmup=False) as engine:   # backend="auto"
        assert engine.autotune is not None
        assert set(engine.autotune.timings_ms) == {"dense", "goap"}
        assert engine.backend == engine.autotune.choice
        assert engine.plan.assignment == {n: engine.backend for n in WEIGHTED}
        assert engine.autotune.batch_shape == (4, 2, SMALL.input_width)
        preds = engine.classify(iq)
        st = engine.stats
    np.testing.assert_array_equal(preds, _goap_preds(tparams, tmasks, iq))
    assert st.backend_batch_counts() == {engine.backend: st.batches}


def test_async_engine_auto_races_fixed_with_lsq_state(weights):
    from repro_torch.train.lsq import init_lsq_scales

    _, _, tparams, tmasks = weights
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu",
                             max_batch=4, warmup=False,
                             lsq_scales=init_lsq_scales(tparams)) as engine:
        assert set(engine.autotune.timings_ms) == {"dense", "goap", "fixed"}
        assert not engine.autotune.errors
        assert engine.classify(_iq(3)).shape == (3,)


def test_default_candidates_follow_the_device(monkeypatch):
    assert default_candidates(device="cpu") == ("dense", "goap")
    assert default_candidates(quantized=True, device="cpu") == (
        "dense", "goap", "fixed")
    card = ("dense", "goap", "cuda", "cuda_fused")
    assert default_candidates(device="cuda") == card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_candidates() == card
    assert default_candidates(quantized=True) == card + ("fixed",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_candidates() == ("dense", "goap")


@pytest.mark.parametrize("name,device,propagates", [
    ("cuda", "cuda", True), ("cuda_fused", "cuda", True),
    ("boom", "cuda", False), ("dense", "cuda", False),
    ("cuda", "cpu", False), ("cuda_fused", "cpu", False)])
def test_race_excludes_a_raising_candidate_unless_a_kernel_on_the_card(
        name, device, propagates):
    """A raising candidate is recorded and excluded, except a hand-written
    kernel on the card: that failure fails the race instead of serving
    plain PyTorch around it."""
    errors = {}
    err = RuntimeError("kernel did not launch")
    if propagates:
        with pytest.raises(RuntimeError, match="kernel did not launch"):
            _disqualify(errors, name, err, torch.device(device))
        assert not errors
    else:
        _disqualify(errors, name, err, torch.device(device))
        assert errors == {name: "RuntimeError: kernel did not launch"}


# ---------------------------------------------------------------------------
# per-layer race (tests/test_plan.py)
# ---------------------------------------------------------------------------

def test_autotune_per_layer_produces_full_assignment(weights):
    _, _, tparams, tmasks = weights
    program = compile_snn(SMALL)
    report = autotune_per_layer(program, tparams, 4, masks=tmasks,
                                candidates=("dense", "goap"), reps=1,
                                cache=PlanCache(disk_dir=""), device="cpu")
    assert set(report.assignment) == WEIGHTED
    assert all(b in ("dense", "goap") for b in report.assignment.values())
    assert set(report.timings_ms) == WEIGHTED and not report.fell_back
    assert report.summary()["batch"] == 4
    for name in WEIGHTED:
        assert set(report.priors[name]) <= {"dense", "goap"}
    frames = torch.zeros(SMALL.timesteps, 2, SMALL.input_width)
    frames[::2, :, ::3] = 1.0
    plan = compile_plan(program, tparams, masks=tmasks,
                        assignment=report.assignment,
                        cache=PlanCache(disk_dir=""), device="cpu")
    ref = program.apply(tparams, frames, "dense", masks=tmasks, device="cpu")
    np.testing.assert_allclose(plan.run_streaming(frames)[0].numpy(),
                               ref.numpy(), atol=ATOL)


def test_autotune_per_layer_falls_back_when_all_candidates_fail(
        weights, boom_backend):
    _, _, tparams, tmasks = weights
    program = compile_snn(SMALL)
    report = autotune_per_layer(program, tparams, 2, masks=tmasks,
                                candidates=(boom_backend,), reps=1,
                                fallback="goap", cache=PlanCache(disk_dir=""),
                                device="cpu")
    assert all(b == "goap" for b in report.assignment.values())
    assert set(report.fell_back) == set(report.assignment) == WEIGHTED
    assert all(boom_backend in e for e in report.errors.values())
    plan = compile_plan(program, tparams, masks=tmasks,
                        assignment=report.assignment,
                        cache=PlanCache(disk_dir=""), device="cpu")
    frames = torch.ones(SMALL.timesteps, 2, SMALL.input_width)
    ref = program.apply(tparams, frames, "dense", masks=tmasks, device="cpu")
    np.testing.assert_allclose(plan.run_streaming(frames)[0].numpy(),
                               ref.numpy(), atol=ATOL)


def test_async_engine_per_layer_backend(weights):
    _, _, tparams, tmasks = weights
    iq = _iq(6, seed=3)
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, backend="per-layer",
                             candidates=("dense", "goap"), max_batch=4,
                             max_delay_ms=5.0, warmup=False, autotune_reps=1,
                             device="cpu") as engine:
        assert engine.backend == "per-layer"
        assert engine.perlayer is not None and engine.plan is not None
        assert set(engine.assignment) == WEIGHTED
        assert engine.plan.assignment == engine.assignment
        preds = engine.classify(iq)
        st = engine.stats
    np.testing.assert_array_equal(preds, _goap_preds(tparams, tmasks, iq))
    assert st.backend == "per-layer"
    assert st.backend_batch_counts().get("per-layer", 0) == st.batches


def test_per_layer_kernel_win_serves_through_the_fused_launch(weights):
    """cuda and cuda_fused time one cell per layer: whichever is faster,
    the layer is assigned cuda_fused, so the all-kernel assignment binds
    the whole-network kernel (its plain version on the CPU)."""
    _, _, tparams, tmasks = weights
    iq = _iq(6, seed=5)
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, backend="per-layer",
                             candidates=("cuda", "cuda_fused"), max_batch=4,
                             max_delay_ms=5.0, warmup=False, autotune_reps=1,
                             device="cpu") as engine:
        report = engine.perlayer
        preds = engine.classify(iq)
    for name in WEIGHTED:
        assert set(report.timings_ms[name]) == {"cuda", "cuda_fused"}
    assert set(report.assignment.values()) == {"cuda_fused"}
    assert engine.plan.fused_stack() is not None
    assert engine.plan.preferred_batch() == engine.plan.batch
    np.testing.assert_array_equal(preds, _goap_preds(tparams, tmasks, iq))


# ---------------------------------------------------------------------------
# cost priors against the reference's (pallas -> cuda)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfgs,ref_backend", [
    ((SMALL_REF, SMALL), "dense"), ((SMALL_REF, SMALL), "goap"),
    ((SMALL_REF, SMALL), "stream"), ((SMALL_REF, SMALL), "pallas"),
    ((PAPER_REF, PAPER), "goap")], ids=lambda v: getattr(v, "input_width", v))
def test_cost_priors_and_summary_equal_the_reference(cfgs, ref_backend):
    ref_cfg, cfg = cfgs
    params, masks, tparams, tmasks = setup(ref_cfg, 3, 0.5)
    ref = ref_compile_plan(ref_compile_snn(ref_cfg), params, masks=masks,
                           assignment=ref_backend,
                           cache=RefPlanCache(disk_dir=""))
    port = compile_plan(compile_snn(cfg), tparams, masks=tmasks,
                        assignment=PORT_NAME[ref_backend],
                        cache=PlanCache(disk_dir=""), device="cpu")
    want = {layer: {PORT_NAME[b]: v for b, v in priors.items()}
            for layer, priors in ref.cost_priors().items()}
    assert port.cost_priors() == want
    assert set(want) == WEIGHTED if cfg is SMALL else len(want) == 5
    got, ref_summary = port.summary(), ref.summary()
    assert set(got) == set(ref_summary) == {"digest", "assignment", "costs"}
    assert got["costs"] == ref_summary["costs"]
    assert got["assignment"] == {k: PORT_NAME[v] for k, v in
                                 ref_summary["assignment"].items()}
