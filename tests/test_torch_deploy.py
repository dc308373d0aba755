"""The port's model lifecycle held to the reference (CPU).

* Registries cross-load: a registry the reference wrote loads in the port
  with bit-equal leaves, and the port's publish of the same content finds
  the existing version (the same digest); the reverse as well.
* The 21 contracts of ``tests/test_deploy.py`` re-run on port engines:
  registry round trip and dedup, aliases, checkpoint -> registry -> serve,
  LSQ round trip, hot-swap under concurrent load with zero failures, a
  swap changing predictions, async and registry swaps, duplicate-label
  and config-drift refusal, remove and swap guards, both drain-barrier
  cases, router proportions and edges, the engine's canary fraction, and
  the monitor's rollback, labels-mode rollback, promotion, latency
  rollback and unbound-label refusal.
* On identical frame sources, the port's monitor decides what the
  reference's decides, round by round.

The reduced config of ``tests/test_deploy.py`` throughout; weights come
from the reference (``tests/_torch_parity.py``).
"""
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import port_leaves, ref_leaves, setup
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.data.radioml import generate_batch as ref_generate_batch
from repro.deploy import CanaryMonitor as RefMonitor
from repro.deploy import MonitorConfig as RefMonitorConfig
from repro.deploy import ModelRegistry as RefRegistry
from repro.models.snn import SNNConfig as RefConfig
from repro.serve import AsyncAMCServeEngine as RefEngine
from repro.train.lsq import init_lsq_scales as ref_init_lsq
from repro_torch.deploy import (
    CanaryMonitor,
    ModelRegistry,
    MonitorConfig,
    WeightedRouter,
    canary_router,
    hot_swap,
    hot_swap_async,
    hot_swap_from_registry,
    publish_from_checkpoint,
    publish_from_trainer,
)
from repro_torch.models.snn import SNNConfig
from repro_torch.serve import AsyncAMCServeEngine, MicroBatcher
from repro_torch.train.lsq import init_lsq_scales
from repro_torch.tree import tree_map

SPEC = dict(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
            fc_specs=((32, 16), (16, 5)), input_width=16, timesteps=3,
            n_classes=5)
CFG_REF = RefConfig(**SPEC)
CFG = SNNConfig(**SPEC)
FRAME_SHAPE = (2, CFG.input_width)


@pytest.fixture(scope="module")
def refs():
    """Reference (p1, m1, p2) and the port's copies of the same numbers."""
    p1, m1, tp1, tm1 = setup(CFG_REF, 0, 0.5)
    p2, _, tp2, _ = setup(CFG_REF, 1, 0.5)
    return {"ref": (p1, m1, p2), "port": (tp1, tm1, tp2)}


@pytest.fixture
def models(refs):
    return refs["port"]


@pytest.fixture
def registry(tmp_path):
    return ModelRegistry(str(tmp_path / "registry"), device="cpu")


def _engine(params, masks=None, **kw):
    kw.setdefault("backend", "dense")
    kw.setdefault("max_batch", 8)
    return AsyncAMCServeEngine(params, CFG, masks, device="cpu", **kw)


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + FRAME_SHAPE).astype(np.float32)


def _permuted_head(params):
    """Injected regression: rolling the last FC's output columns shifts
    every logit by one class."""
    w = torch.roll(params["fc"][1]["w"], 1, dims=1)
    return {"conv": params["conv"],
            "fc": [params["fc"][0], dict(params["fc"][1], w=w)]}


def _assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# registries across the two packages
# ---------------------------------------------------------------------------

def test_reference_registry_loads_in_the_port(refs, tmp_path):
    p1, m1, _ = refs["ref"]
    tp1, tm1, _ = refs["port"]
    root = str(tmp_path / "reg")
    v = RefRegistry(root).publish("amc", p1, CFG_REF, masks=m1,
                                  lsq_scales=ref_init_lsq(p1, 8), quant_bits=8,
                                  assignment="goap", alias="production")
    port = ModelRegistry(root, device="cpu")
    loaded = port.load("amc@production")
    assert loaded.cfg == CFG and loaded.version.digest == v.digest
    assert loaded.version.plan_digest == v.plan_digest   # recorded as is
    _assert_leaves_equal(port_leaves(loaded.params), ref_leaves(p1))
    _assert_leaves_equal(port_leaves(loaded.masks), ref_leaves(m1))
    _assert_leaves_equal(port_leaves(loaded.lsq_scales),
                         ref_leaves(ref_init_lsq(p1, 8)))
    # the port's publish of the same content is the same version
    again = port.publish("amc", tp1, CFG, masks=tm1,
                         lsq_scales=loaded.lsq_scales, quant_bits=8)
    assert again.version == 1 and again.digest == v.digest


def test_port_registry_loads_in_the_reference(refs, tmp_path):
    p1, m1, _ = refs["ref"]
    tp1, tm1, _ = refs["port"]
    root = str(tmp_path / "reg")
    lsq = init_lsq_scales(tp1, 8)
    v = ModelRegistry(root, device="cpu").publish(
        "amc", tp1, CFG, masks=tm1, lsq_scales=lsq, quant_bits=8,
        assignment="cuda_fused", alias="staging")
    assert v.plan_digest     # the port's plan, compiled on the CPU
    ref = RefRegistry(root)
    loaded = ref.load("amc@staging")
    assert loaded.cfg == CFG_REF and loaded.version.digest == v.digest
    _assert_leaves_equal(ref_leaves(loaded.params), port_leaves(tp1))
    _assert_leaves_equal(ref_leaves(loaded.masks), port_leaves(tm1))
    _assert_leaves_equal(ref_leaves(loaded.lsq_scales), port_leaves(lsq))
    again = ref.publish("amc", loaded.params, CFG_REF, masks=loaded.masks,
                        lsq_scales=loaded.lsq_scales, quant_bits=8)
    assert again.version == 1


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_publish_load_roundtrip(registry, models):
    p1, m1, _ = models
    v = registry.publish("amc", p1, CFG, masks=m1, assignment="dense",
                         metrics={"acc": 0.9}, alias="production")
    assert v.version == 1 and v.spec == "amc@1"
    assert v.plan_digest  # plan compiled + cache warmed at publish time
    loaded = registry.load("amc@production")
    assert loaded.cfg == CFG
    assert loaded.version.metrics["acc"] == 0.9
    _assert_leaves_equal(port_leaves(loaded.params), port_leaves(p1))
    _assert_leaves_equal(port_leaves(loaded.masks), port_leaves(m1))


@pytest.mark.parametrize("why", ["no_card", "unknown_backend"])
def test_publish_without_a_plan_records_no_digest(tmp_path, models,
                                                  monkeypatch, why):
    """As in the reference, a version whose plan cannot be compiled here
    is still published, without a plan digest."""
    p1, m1, _ = models
    if why == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        registry, assignment = ModelRegistry(str(tmp_path)), "cuda_fused"
    else:
        registry = ModelRegistry(str(tmp_path), device="cpu")
        assignment = "no-such-backend"
    v = registry.publish("amc", p1, CFG, masks=m1, assignment=assignment)
    assert v.version == 1 and v.plan_digest is None
    assert registry.load("amc").version.assignment == assignment


def test_registry_content_addressing_dedups(registry, models):
    p1, m1, p2 = models
    v1 = registry.publish("amc", p1, CFG, masks=m1)
    again = registry.publish("amc", p1, CFG, masks=m1)
    assert again.version == v1.version  # identical content -> same version
    v2 = registry.publish("amc", p2, CFG)
    assert v2.version == v1.version + 1
    assert registry.versions("amc") == [1, 2]


def test_registry_aliases_and_resolve(registry, models):
    p1, _, p2 = models
    registry.publish("amc", p1, CFG, alias="production")
    registry.publish("amc", p2, CFG, alias="staging")
    assert registry.resolve("amc") == ("amc", 1)          # production alias
    assert registry.resolve("amc@staging") == ("amc", 2)
    assert registry.resolve("amc@2") == ("amc", 2)
    assert registry.resolve("amc@v2") == ("amc", 2)
    registry.set_alias("amc", "production", 2)
    assert registry.resolve("amc") == ("amc", 2)
    with pytest.raises(KeyError):
        registry.resolve("amc@nope")
    with pytest.raises(KeyError):
        registry.resolve("amc@7")
    with pytest.raises(KeyError):
        registry.set_alias("amc", "production", 7)
    # version-shaped aliases would shadow resolve()'s numeric forms
    with pytest.raises(ValueError):
        registry.set_alias("amc", "v2", 1)
    with pytest.raises(ValueError):
        registry.set_alias("amc", "2", 1)


def test_registry_resolve_without_alias_uses_latest(registry, models):
    p1, _, p2 = models
    registry.publish("amc", p1, CFG)
    registry.publish("amc", p2, CFG)
    assert registry.resolve("amc") == ("amc", 2)


def test_checkpoint_to_registry_to_serve_roundtrip(registry):
    """train -> checkpoint -> publish -> load -> serve."""
    from repro_torch.train.trainer import SNNTrainer, TrainerConfig

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainerConfig(total_steps=4, batch_size=8, seed=0,
                             final_density=0.5, ckpt_dir=ckpt_dir,
                             ckpt_every=2)
        trainer = SNNTrainer(CFG, tcfg, device="cpu")
        trainer.run()
        v = publish_from_checkpoint(registry, "amc", CFG, tcfg,
                                    assignment="dense", alias="production")
        assert v.metrics["source_step"] == trainer.step
        assert v.has_masks
        loaded = registry.load("amc@production")
        _assert_leaves_equal(port_leaves(loaded.params),
                             port_leaves(trainer.params))
        # live-trainer publish of identical state dedups to the same version
        assert publish_from_trainer(registry, "amc",
                                    trainer).version == v.version
    with _engine(loaded.params, loaded.masks, max_delay_ms=2.0,
                 version_label=v.spec) as engine:
        preds = engine.classify(_iq(12))
    assert preds.shape == (12,) and engine.stats.requests == 12


def test_lsq_state_round_trips_to_serving(registry, models):
    """LSQ scales published to the registry reach the served step: the
    engine's predictions match the fake-quant forward, and the plan digest
    differs from the unquantized bind."""
    from repro_torch.data.pipeline import sigma_delta_encode_np
    from repro_torch.models.graph import compile_snn
    from repro_torch.train.lsq import make_serving_quant_fn

    p1, m1, _ = models
    lsq = init_lsq_scales(p1, bits=8)
    v = registry.publish("amc", p1, CFG, masks=m1, lsq_scales=lsq,
                         quant_bits=8, assignment="dense")
    assert v.has_lsq and v.quant_bits == 8
    loaded = registry.load("amc@1")

    iq = _iq(8, seed=3)
    frames = torch.from_numpy(sigma_delta_encode_np(iq, CFG.timesteps))
    ref = compile_snn(CFG).apply_batch(
        p1, frames, "dense", masks=m1,
        quant_fn=make_serving_quant_fn(lsq, 8), device="cpu").numpy()
    with _engine(loaded.params, loaded.masks, lsq_scales=loaded.lsq_scales,
                 quant_bits=loaded.version.quant_bits) as eng:
        quant_digest = eng.plan.digest
        preds = eng.classify(iq)
    np.testing.assert_array_equal(preds, ref.argmax(-1))
    with _engine(loaded.params, loaded.masks) as eng:
        assert eng.plan.digest != quant_digest


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------

def test_hot_swap_under_concurrent_load_zero_failures(models):
    """Live hot-swap with zero dropped or failed requests."""
    p1, m1, p2 = models
    engine = _engine(p1, m1, max_delay_ms=1.0, version_label="v1")
    futures, stop = [], threading.Event()
    lock = threading.Lock()

    def pump(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            f = engine.submit(rng.normal(size=FRAME_SHAPE).astype(np.float32))
            with lock:
                futures.append(f)
            time.sleep(0.001)   # offered load below serving capacity

    threads = [threading.Thread(target=pump, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    try:
        deadline = time.perf_counter() + 60.0
        while ((len(futures) < 64 or engine.stats.requests == 0)
               and time.perf_counter() < deadline):
            time.sleep(0.001)
        assert engine.stats.requests > 0, "v1 never served before the flip"
        report = hot_swap(engine, p2, label="v2", backend="dense",
                          drain_timeout=30.0)
        deadline = time.perf_counter() + 60.0
        while (engine.version_stats()["v2"].requests == 0
               and time.perf_counter() < deadline):
            time.sleep(0.001)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    results = [f.result(timeout=60.0) for f in futures]  # raises on failure

    assert report.old_label == "v1" and report.new_label == "v2"
    assert report.drained
    assert engine.active_version == "v2"
    assert len(results) == len(futures)
    stats = engine.version_stats()
    assert stats["v1"].requests > 0 and stats["v2"].requests > 0
    assert stats["v1"].requests + stats["v2"].requests == \
        engine.stats.requests
    engine.close()


def test_hot_swap_changes_served_predictions(models):
    p1, m1, p2 = models
    iq = _iq(16, seed=7)
    with _engine(p1, m1, version_label="v1") as engine:
        before = engine.classify(iq)
        hot_swap(engine, p2, label="v2", backend="dense")
        after = engine.classify(iq)
    with _engine(p2, version_label="ref") as ref_engine:
        ref = ref_engine.classify(iq)
    np.testing.assert_array_equal(after, ref)
    assert before.shape == after.shape


def test_hot_swap_async_and_registry_path(registry, models):
    p1, m1, p2 = models
    registry.publish("amc", p1, CFG, masks=m1, assignment="dense",
                     alias="production")
    registry.publish("amc", p2, CFG, assignment="dense", alias="staging")
    loaded = registry.load("amc@production")
    with _engine(loaded.params, loaded.masks,
                 version_label="amc@1") as engine:
        report = hot_swap_from_registry(engine, registry, "amc@staging")
        assert report.new_label == "amc@2"
        assert engine.active_version == "amc@2"
        assert report.plan_digest == registry.describe("amc", 2).plan_digest
        fut = hot_swap_async(engine, p1, masks=m1, label="v1-again",
                             backend="dense")
        assert fut.result(timeout=60.0).new_label == "v1-again"
        assert engine.active_version == "v1-again"


def test_hot_swap_rejects_duplicate_label_and_config_drift(registry, models):
    import dataclasses

    p1, m1, p2 = models
    other_cfg = dataclasses.replace(CFG, timesteps=4)
    registry.publish("amc", p2, other_cfg, assignment="dense")
    with _engine(p1, m1, version_label="v1") as engine:
        with pytest.raises(ValueError, match="already bound"):
            hot_swap(engine, p2, label="v1", backend="dense")
        with pytest.raises(ValueError, match="SNNConfig"):
            hot_swap_from_registry(engine, registry, "amc@1")


def test_remove_and_swap_guards(models):
    p1, m1, p2 = models
    with _engine(p1, m1, version_label="v1") as engine:
        with pytest.raises(KeyError):
            engine.swap_to("nope")
        with pytest.raises(ValueError, match="primary"):
            engine.remove_version("v1")
        # no race assignment to inherit: an explicit error, not a uniform
        # backend mislabelled "per-layer"
        with pytest.raises(ValueError, match="per-layer"):
            engine.bind_version("v3", p2, backend="per-layer")
        engine.bind_version("v2", p2, backend="dense")
        engine.swap_to("v2")
        engine.remove_version("v1")
        assert set(engine.versions()) == {"v2"}


@pytest.mark.parametrize("engine_backend,bind_backend", [
    ("dense", "auto"), ("goap", None), ("per-layer", None),
    ("per-layer", "per-layer")])
def test_bind_version_backend_choices(models, engine_backend, bind_backend):
    """``None`` inherits the engine's backend (a per-layer engine's
    assignment too), ``"auto"`` races the engine's candidates; the bound
    version serves what its plan says, with its own stats."""
    p1, m1, p2 = models
    iq = _iq(8, seed=5)
    with _engine(p1, m1, backend=engine_backend,
                 version_label="v1") as engine:
        ver = engine.bind_version("v2", p2, backend=bind_backend)
        if bind_backend == "auto":
            assert ver.backend in ("dense", "goap")
        else:
            assert ver.backend == engine_backend
        if engine_backend == "per-layer":
            assert ver.plan.assignment == engine.assignment
        engine.swap_to("v2")
        preds = engine.classify(iq)
        assert engine.version_stats()["v2"].requests == 8
        assert engine.version_stats()["v1"].requests == 0
    with _engine(p2, backend="goap") as ref:
        np.testing.assert_array_equal(preds, ref.classify(iq))


# ---------------------------------------------------------------------------
# drain barrier
# ---------------------------------------------------------------------------

def test_drain_barrier_waits_for_preexisting_backlog():
    b = MicroBatcher(frame_shape=FRAME_SHAPE, max_batch=4, max_delay_ms=1.0)
    for _ in range(6):
        b.submit(np.zeros(FRAME_SHAPE, np.float32))
    assert not b.drain_barrier(timeout=0.05)  # nothing consumed yet
    assert b.get_batch(timeout=1.0) is not None  # 4 of 6
    assert not b.drain_barrier(timeout=0.05)
    assert b.get_batch(timeout=1.0) is not None  # remaining 2
    assert b.drain_barrier(timeout=1.0)
    assert b.drain_barrier(timeout=0.05)        # trivially true when empty


def test_drain_barrier_released_by_close_drain():
    b = MicroBatcher(frame_shape=FRAME_SHAPE, max_batch=4, max_delay_ms=1.0)
    futs = [b.submit(np.zeros(FRAME_SHAPE, np.float32)) for _ in range(3)]
    released = threading.Event()

    def wait():
        if b.drain_barrier(timeout=10.0):
            released.set()

    t = threading.Thread(target=wait)
    t.start()
    b.close()
    assert len(b.drain()) == 3
    t.join(timeout=5.0)
    assert not t.is_alive() and released.is_set()
    del futs


# ---------------------------------------------------------------------------
# canary routing
# ---------------------------------------------------------------------------

def test_weighted_router_exact_proportions():
    r = WeightedRouter({"a": 75.0, "b": 25.0})
    picks = [r() for _ in range(100)]
    assert picks.count("a") == 75 and picks.count("b") == 25
    assert all("b" in picks[i:i + 4] for i in range(0, 100, 4))  # smooth
    assert r.fractions() == {"a": 0.75, "b": 0.25}


def test_canary_router_edges():
    assert canary_router("p", "c", 0.0) is None
    assert canary_router("p", "c", 100.0)() == "c"
    with pytest.raises(ValueError):
        canary_router("p", "c", 150.0)


def test_engine_routes_canary_fraction(models):
    p1, m1, p2 = models
    with _engine(p1, m1, max_batch=4, max_delay_ms=1.0,
                 version_label="prod") as engine:
        engine.bind_version("canary", p2, backend="dense")
        engine.set_router(canary_router("prod", "canary", 25.0))
        engine.classify(_iq(64))
        stats = engine.version_stats()
        assert stats["canary"].batches > 0 and stats["prod"].batches > 0
        total = stats["canary"].batches + stats["prod"].batches
        assert stats["canary"].batches == pytest.approx(0.25 * total, abs=1.0)
        # a router naming a missing label degrades to the primary
        engine.set_router(lambda: "gone")
        assert engine.classify(_iq(8)).shape == (8,)


# ---------------------------------------------------------------------------
# canary monitor
# ---------------------------------------------------------------------------

def _monitor_cfg(**kw):
    base = dict(snr_bins=(0.0, 10.0), frames_per_bin=8, window=3,
                min_rounds=2, promote_after=3, score="agreement")
    base.update(kw)
    return MonitorConfig(**base)


def test_monitor_rolls_back_injected_accuracy_regression(models):
    p1, m1, _ = models
    with _engine(p1, m1, version_label="prod") as engine:
        engine.bind_version("canary", _permuted_head(p1), backend="dense")
        engine.set_router(canary_router("prod", "canary", 25.0))
        mon = CanaryMonitor(engine, baseline="prod", canary="canary",
                            config=_monitor_cfg())
        assert mon.run(max_rounds=8) == "rollback"
        assert "regression" in mon.reason
        assert "canary" not in engine.versions()     # canary evicted
        assert engine.active_version == "prod"       # production untouched
        assert engine._router is None                # traffic restored
        assert engine.classify(_iq(8)).shape == (8,)


def test_monitor_rollback_in_labels_mode(models):
    """Frames labelled with production's own predictions: the baseline
    scores 1.0 and the permuted canary far less."""
    p1, m1, _ = models
    with _engine(p1, m1, version_label="prod") as engine:
        engine.bind_version("canary", _permuted_head(p1), backend="dense")
        prod = engine.get_version("prod")

        def source(seed, n, snr):
            rng = np.random.default_rng(seed)
            iq = rng.normal(size=(n,) + FRAME_SHAPE).astype(np.float32)
            return iq, prod.step(iq).argmax(-1)

        mon = CanaryMonitor(engine, baseline="prod", canary="canary",
                            config=_monitor_cfg(score="labels"),
                            frame_source=source)
        assert mon.run(max_rounds=8) == "rollback"
        assert all(v == 1.0 for v in mon.history[-1].baseline_acc.values())
        s = mon.summary()
        assert any(s["windowed_canary"][snr]
                   < s["windowed_baseline"][snr] - 0.05
                   for snr in s["windowed_baseline"])


def test_monitor_promotes_clean_canary_and_advances_alias(registry, models):
    p1, m1, _ = models
    registry.publish("amc", p1, CFG, masks=m1, alias="production",
                     assignment="dense")
    # the canary: the same weights, no masks: a distinct registry version
    # whose predictions match the (unmasked) baseline exactly
    p_can = tree_map(lambda x: x.clone(), p1)
    registry.publish("amc", p_can, CFG, assignment="dense", alias="staging")
    with _engine(p1, version_label="amc@1") as engine:
        engine.bind_version("amc@2", p_can, backend="dense")
        engine.set_router(canary_router("amc@1", "amc@2", 25.0))
        mon = CanaryMonitor(engine, baseline="amc@1", canary="amc@2",
                            config=_monitor_cfg(min_rounds=1,
                                                promote_after=2),
                            registry=registry, canary_spec="amc@2")
        assert mon.run(max_rounds=8) == "promote"
        assert engine.active_version == "amc@2"
        assert engine._router is None
    assert registry.resolve("amc") == ("amc", 2)  # production advanced


def test_monitor_rolls_back_latency_regression(models):
    p1, m1, p2 = models
    with _engine(p1, m1, version_label="prod") as engine:
        engine.bind_version("canary", p2, backend="dense")
        stats = engine.version_stats()
        stats["prod"].record_latencies([0.001] * 64)
        stats["canary"].record_latencies([0.050] * 64)
        mon = CanaryMonitor(
            engine, baseline="prod", canary="canary",
            config=_monitor_cfg(acc_drop_tol=1.1, min_rounds=1,
                                p99_factor=2.0))
        assert mon.run(max_rounds=4) == "rollback"
        assert "latency" in mon.reason


def test_monitor_fails_fast_on_unbound_labels(models):
    p1, m1, _ = models
    with _engine(p1, m1, version_label="prod") as engine:
        with pytest.raises(KeyError):
            CanaryMonitor(engine, baseline="prod", canary="missing")


# ---------------------------------------------------------------------------
# the monitor against the reference's, on identical frame sources
# ---------------------------------------------------------------------------

def _shared_source(seed, n, snr):
    """Frames both packages evaluate: the reference's generator, clean."""
    iq, labels, _ = ref_generate_batch(seed, n, snr_db=snr,
                                       classes=tuple(range(CFG.n_classes)),
                                       frame_len=CFG.input_width)
    return iq, labels


@pytest.mark.parametrize("canary,score", [("permuted", "agreement"),
                                          ("permuted", "labels"),
                                          ("same", "agreement"),
                                          ("other", "labels")])
def test_monitor_decides_as_the_reference(refs, canary, score):
    p1, m1, p2 = refs["ref"]
    tp1, tm1, tp2 = refs["port"]
    if canary == "permuted":
        w = np.roll(np.asarray(p1["fc"][1]["w"]), 1, axis=1)
        ref_can = {"conv": p1["conv"],
                   "fc": [p1["fc"][0], dict(p1["fc"][1], w=w)]}
        port_can = _permuted_head(tp1)
    elif canary == "same":
        ref_can, port_can = p1, tp1
    else:
        ref_can, port_can = p2, tp2
    kw = dict(snr_bins=(-10.0, 0.5, 10.0), frames_per_bin=16, window=3,
              min_rounds=2, promote_after=3, score=score)
    with RefEngine(p1, CFG_REF, masks=m1, backend="dense", max_batch=8,
                   version_label="prod") as ref_engine, \
            _engine(tp1, tm1, version_label="prod") as engine:
        ref_engine.bind_version("canary", ref_can, masks=m1, backend="dense")
        engine.bind_version("canary", port_can, tm1, backend="dense")
        ref_mon = RefMonitor(ref_engine, baseline="prod", canary="canary",
                             config=RefMonitorConfig(**kw),
                             frame_source=_shared_source)
        mon = CanaryMonitor(engine, baseline="prod", canary="canary",
                            config=MonitorConfig(**kw),
                            frame_source=_shared_source)
        for _ in range(6):
            assert mon.step() == ref_mon.step()
            assert mon.reason == ref_mon.reason
            if ref_mon.decision != "pending":
                break
        got, want = mon.history[-1], ref_mon.history[-1]
        assert got.baseline_acc == want.baseline_acc
        assert got.canary_acc == want.canary_acc
        assert engine.active_version == ref_engine.active_version
        assert set(engine.versions()) == set(ref_engine.versions())

