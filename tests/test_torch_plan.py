"""Port plan cache and plan hooks: the build-once contracts of
tests/test_plan.py on port plans (CPU), the disk tier's round trip, and
the offline per-layer step profiler."""
import numpy as np
import pytest
import torch

from _torch_parity import SMALL, SMALL_REF, setup, spike_frames
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro_torch.api import compile_snn, make_mask_pytree
from repro_torch.models.graph import artifact_build_count
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.plan import (
    PlanCache,
    compile_plan,
    default_cache,
    init_stream_states,
    set_default_cache,
)
from repro_torch.plan.cache import default_store_root
from repro_torch.plan.streaming import profile_layer_steps
from repro_torch.serve import AMCServeEngine

ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    return setup(SMALL_REF, 0, 0.5)


@pytest.fixture
def fresh_default_cache():
    """Swap the process-default plan cache for an isolated memory one."""
    old = default_cache()
    set_default_cache(PlanCache(disk_dir=""))
    yield
    set_default_cache(old)


def _frames(seed=0):
    return torch.from_numpy(spike_frames(
        seed, (SMALL.timesteps, SMALL.conv_specs[0][1], SMALL.input_width)))


def _compile(weights, backend, cache, masks=None):
    _, _, tparams, tmasks = weights
    return compile_plan(compile_snn(SMALL), tparams,
                        masks=tmasks if masks is None else masks,
                        assignment=backend, cache=cache, device="cpu")


def test_plan_cache_disk_roundtrip(tmp_path, weights):
    frames = _frames()
    cold = PlanCache(str(tmp_path))
    plan1 = _compile(weights, "stream", cold)
    built = artifact_build_count()
    logits1, counters1 = plan1.run_streaming(frames)
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".pkl", ".pkl"]
    # a fresh cache over the same directory = a process restart
    warm = PlanCache(str(tmp_path))
    plan2 = _compile(weights, "stream", warm)
    assert artifact_build_count() == built      # loaded, not rebuilt
    assert warm.stats["layer_disk_hits"] == 2   # both convs
    assert plan2 is not plan1 and plan2.digest == plan1.digest
    logits2, counters2 = plan2.run_streaming(frames)
    np.testing.assert_array_equal(logits1.numpy(), logits2.numpy())
    for name in counters1:
        assert (int(counters1[name]["accumulations"])
                == int(counters2[name]["accumulations"]))


def test_disk_tier_stores_numpy_and_port_classes_only(tmp_path, weights):
    import pickle

    _compile(weights, "cuda_fused", PlanCache(str(tmp_path)))
    for path in tmp_path.glob("*.pkl"):
        with open(path, "rb") as f:
            artifacts = pickle.load(f)
        assert set(artifacts) == {"coo", "block_sparse", "schedule"}
        for art in artifacts.values():
            assert type(art).__module__.startswith("repro_torch.")
            for v in vars(art).values():
                assert not isinstance(v, torch.Tensor)


def test_mask_change_invalidates_plan(tmp_path, weights):
    _, _, tparams, tmasks = weights
    cache = PlanCache(str(tmp_path))
    plan1 = _compile(weights, "goap", cache)
    built = artifact_build_count()
    masks2 = make_mask_pytree(tparams, 0.25)
    plan2 = _compile(weights, "goap", cache, masks=masks2)
    assert plan2.digest != plan1.digest
    assert artifact_build_count() > built       # re-derived for the new mask
    frames = _frames()
    ref = compile_snn(SMALL).apply(tparams, frames, "dense", masks=masks2,
                                   device="cpu")
    np.testing.assert_allclose(plan2.run_streaming(frames)[0].numpy(),
                               ref.numpy(), atol=ATOL)


def test_corrupt_disk_entry_is_rebuilt(tmp_path, weights):
    _compile(weights, "goap", PlanCache(str(tmp_path)))
    for path in tmp_path.glob("*.pkl"):
        path.write_bytes(b"not a pickle")
    cache = PlanCache(str(tmp_path))
    built = artifact_build_count()
    _compile(weights, "goap", cache)
    assert cache.stats["layer_disk_errors"] == 2
    assert artifact_build_count() > built
    cache.clear(memory_only=True)
    assert len(list(tmp_path.glob("*.pkl"))) == 2
    cache.clear()
    assert not list(tmp_path.glob("*.pkl"))


def test_disk_tier_directory_follows_its_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    assert PlanCache().disk_dir == tmp_path / "plans"
    assert default_store_root() == tmp_path
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", "")
    assert PlanCache().disk_dir is None
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE_DIR")
    assert PlanCache().disk_dir.parts[-3:] == (".cache", "repro_torch", "plans")


def test_sync_engine_restart_reuses_plan(fresh_default_cache, weights):
    _, _, tparams, tmasks = weights
    rng = np.random.default_rng(0)
    iq = rng.normal(size=(4, 2, SMALL.input_width)).astype(np.float32)
    e1 = AMCServeEngine(tparams, SMALL, tmasks, batch_size=4, backend="goap",
                        device="cpu")
    preds1 = e1.classify(iq)
    built = artifact_build_count()
    e2 = AMCServeEngine(tparams, SMALL, tmasks, batch_size=4, backend="goap",
                        device="cpu")
    assert artifact_build_count() == built      # restart: nothing rebuilt
    assert e2.plan is e1.plan
    np.testing.assert_array_equal(e2.classify(iq), preds1)


def test_init_stream_states_chain_through_the_graph(weights):
    plan = _compile(weights, "stream", PlanCache(disk_dir=""))
    x0 = torch.zeros(3, SMALL.conv_specs[0][1], SMALL.input_width)
    states = init_stream_states([lp.cell for lp in plan.layers], x0)
    by_name = dict(zip((lp.spec.name for lp in plan.layers), states))
    assert by_name["conv1"][0].shape == (3, 4, SMALL.input_width)
    assert by_name["conv2"][0].shape == (3, 8, SMALL.input_width // 2)
    assert by_name["fc1"].shape == (3, 16) and by_name["fc2"].shape == (3, 5)
    assert by_name["readout"].shape == (3, 5)


@pytest.mark.parametrize("batched", [False, True], ids=["sample", "batch"])
def test_profile_layer_steps_sets_one_gauge_per_layer(weights, batched):
    plan = _compile(weights, "cuda", PlanCache(disk_dir=""))
    frames = _frames()
    if batched:
        frames = frames[:, None].expand(-1, 2, -1, -1)
    reg = MetricsRegistry()
    ms = profile_layer_steps(plan, frames, reps=2, registry=reg)
    names = [lp.spec.name for lp in plan.layers]
    assert list(ms) == names
    assert all(v > 0 for v in ms.values())
    for lp in plan.layers:
        assert reg.value("repro_plan_layer_step_ms", layer=lp.spec.name,
                         backend=lp.backend) == ms[lp.spec.name]
