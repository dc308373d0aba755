"""The port's metrics registry and live Tables I/III gauges, held to the
live reference (CPU).

The registry's exposition text equals the reference's for the same
operations; the gauges read the same schedule geometry; a CPU engine with
a padded bucket counts the real rows only, equal to the ``stream``
counters over those rows; the host diagnostics mode counts what the
reference engine counts.
"""
import numpy as np
import pytest

from _torch_parity import PAPER, PAPER_REF, SMALL, SMALL_REF, setup, t
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.obs import activity as ref_activity
from repro.obs import metrics as ref_metrics
from repro.plan import compile_plan as ref_compile_plan
from repro.models.graph import compile_snn as ref_compile_snn
from repro.serve import AsyncAMCServeEngine as RefEngine
from repro_torch.api import compile_plan, compile_snn
from repro_torch.data.pipeline import sigma_delta_encode_batch
from repro_torch.obs import activity, metrics
from repro_torch.serve import AsyncAMCServeEngine


@pytest.fixture
def registry():
    """A fresh process-wide registry for the test, the old one restored."""
    fresh = metrics.MetricsRegistry()
    old = metrics.set_default_registry(fresh)
    yield fresh
    metrics.set_default_registry(old)


def _drive(mod):
    """The same operations on a registry of ``mod`` (reference or port)."""
    reg = mod.MetricsRegistry()
    c = reg.counter("repro_serve_requests_total", "Requests\nserved",
                    ("engine",))
    c.labels(engine="r0").inc(3)
    c.labels(engine='r"1\\').inc(2.5)
    g = reg.gauge("repro_deploy_production_info", "info", ("version",))
    g.labels(version="v1").set(1)
    g.set_exclusive(version="v2")
    solo = reg.gauge("repro_serve_queue_depth", "depth")
    solo.set(7)
    solo.dec(2)
    h = reg.histogram("repro_serve_request_latency_seconds", "lat",
                      ("engine",), buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.001, 0.02, 5.0):
        h.labels(engine="r0").observe(v)
    reg.histogram("repro_plan_bind_seconds", "bind").observe(0.3)
    return reg


def test_registry_exposition_equals_reference():
    got, want = _drive(metrics), _drive(ref_metrics)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.snapshot() == want.snapshot()
    assert (metrics.MetricsRegistry.merged([got, _drive(metrics)]).to_prometheus()
            == ref_metrics.MetricsRegistry.merged(
                [want, _drive(ref_metrics)]).to_prometheus())
    assert got.value("repro_serve_requests_total", engine="r0") == 3.0
    assert metrics.DEFAULT_LATENCY_BUCKETS == ref_metrics.DEFAULT_LATENCY_BUCKETS


@pytest.mark.parametrize("bad", [
    lambda r: r.counter("bad name"),
    lambda r: r.counter("ok_name", "", ("__reserved",)),
    lambda r: (r.counter("x_total"), r.gauge("x_total")),
    lambda r: r.counter("c_total", "", ("a",)).labels(b="1"),
    lambda r: r.counter("c_total").inc(-1),
    lambda r: r.histogram("h", "", (), buckets=(1.0, 1.0)),
])
def test_registry_refuses_what_the_reference_refuses(bad):
    for mod in (metrics, ref_metrics):
        with pytest.raises(ValueError):
            bad(mod.MetricsRegistry())


def _plans(backend, seed=0, cfg=SMALL, ref_cfg=SMALL_REF):
    params, masks, tparams, tmasks = setup(ref_cfg, seed, 0.5)
    plan = compile_plan(compile_snn(cfg), tparams, masks=tmasks,
                        assignment=backend, device="cpu")
    ref = ref_compile_plan(ref_compile_snn(ref_cfg), params, masks=masks,
                           assignment="stream")
    return plan, ref


@pytest.mark.parametrize("backend", ["stream", "cuda_fused"])
def test_static_schedule_counts_equal_reference(backend):
    plan, ref = _plans(backend)
    assert (activity.static_schedule_counts(plan)
            == ref_activity.static_schedule_counts(ref))


def test_static_schedule_counts_equal_reference_paper_config():
    plan, ref = _plans("cuda_fused", cfg=PAPER, ref_cfg=PAPER_REF)
    want = ref_activity.static_schedule_counts(ref)
    assert activity.static_schedule_counts(plan) == want
    _, _, tparams, tmasks = setup(PAPER_REF, 0, 0.5)
    stream = compile_plan(compile_snn(PAPER), tparams, masks=tmasks,
                          assignment="stream", device="cpu")
    assert activity.static_schedule_counts(stream) == want


def test_observer_counts_real_rows_only(registry):
    plan, _ = _plans("stream")
    obs = activity.ActivityObserver(plan, engine="e")
    accs = {"conv1": np.array([10.0, 20.0, 999.0]),
            "conv2": np.array([1.0, 2.0, 999.0])}
    obs.observe(accs, n_real=2)
    obs.observe(accs, n_real=0)
    assert registry.value("repro_activity_frames_total", engine="e") == 2
    assert registry.value("repro_activity_accumulations_total", engine="e",
                          layer="conv1") == 30.0
    assert registry.value("repro_activity_events_per_frame", engine="e",
                          layer="conv2") == 1.5
    geom = {g["name"]: g for g in obs.geometry}
    assert registry.value("repro_activity_effective_density", engine="e",
                          layer="conv1") == 15.0 / geom["conv1"]["sparse_macs_per_frame"]
    sched = activity.static_schedule_counts(plan)
    for layer, counts in sched.items():
        for key, val in counts.items():
            assert registry.value("repro_activity_schedule", layer=layer,
                                  counter=key) == val


def _iq(n, seed=0, width=SMALL.input_width):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 2, width)).astype(np.float32)


@pytest.mark.parametrize("backend", ["stream", "cuda_fused"])
def test_engine_gauges_count_real_rows_of_a_padded_bucket(registry, backend):
    _, _, tparams, tmasks = setup(SMALL_REF, 1, 0.5)
    iq = _iq(5, seed=3)
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, backend=backend,
                             max_batch=8, max_delay_ms=500.0, device="cpu",
                             name="gauged") as engine:
        assert engine.activity is not None
        preds = engine.classify(iq)
        stats = engine.stats.summary()
    assert stats["padded_frames"] > 0      # the bucket carried zero rows
    stream = compile_plan(compile_snn(SMALL), tparams, masks=tmasks,
                          assignment="stream", device="cpu")
    logits, accs = stream.batch_counters(
        sigma_delta_encode_batch(t(iq), SMALL.timesteps))
    np.testing.assert_array_equal(preds, logits.argmax(-1).numpy())
    assert registry.value("repro_activity_frames_total", engine="gauged") == 5
    for name, a in accs.items():
        assert registry.value("repro_activity_accumulations_total",
                              engine="gauged", layer=name) == float(a.sum())
    assert registry.value("repro_serve_requests_total", engine="gauged") == 5
    assert (registry.value("repro_serve_padded_frames_total", engine="gauged")
            == stats["padded_frames"])


def test_engine_without_counters_or_with_gauges_off_reports_none(registry):
    _, _, tparams, tmasks = setup(SMALL_REF, 1, 0.5)
    for kw in (dict(backend="goap"),
               dict(backend="cuda_fused", activity_gauges=False)):
        with AsyncAMCServeEngine(tparams, SMALL, tmasks, max_batch=4,
                                 device="cpu", name="plain", **kw) as engine:
            assert engine.activity is None
            logits, accs = engine.serve_step(_iq(3))
            assert accs is None and logits.shape == (3, SMALL.n_classes)
    assert registry.value("repro_activity_frames_total", engine="plain") == 0


def test_count_activity_equals_reference_engine():
    params, masks, tparams, tmasks = setup(SMALL_REF, 2, 0.5)
    iq = _iq(6, seed=4)
    with RefEngine(params, SMALL_REF, masks, backend="goap", max_batch=4,
                   count_activity=True) as ref:
        ref_preds = ref.classify(iq)
        want = ref.stats.summary()
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, backend="goap",
                             max_batch=4, count_activity=True,
                             device="cpu") as engine:
        preds = engine.classify(iq)
        got = engine.stats.summary()
    np.testing.assert_array_equal(preds, ref_preds)
    assert got["accumulations"] == want["accumulations"] > 0
    assert got["fetched_bits"] == want["fetched_bits"] > 0


def test_count_batch_activity_equals_reference_paper_config():
    """Paper pin: the diagnostics counts on two paper-model frames."""
    from repro.serve.engine import ServeStats as RefStats
    from repro.serve.engine import count_batch_activity as ref_count
    from repro.models.snn import sparsify_params as ref_sparsify
    from repro_torch.data.pipeline import sigma_delta_encode_np
    from repro_torch.models.snn import sparsify_params
    from repro_torch.serve.engine import ServeStats, count_batch_activity

    params, masks, tparams, tmasks = setup(PAPER_REF, 0, 0.5)
    frames = sigma_delta_encode_np(_iq(2, seed=5, width=128), PAPER.timesteps)
    want = RefStats()
    ref_count(want, ref_sparsify(params, masks), frames, PAPER_REF)
    got = ServeStats()
    count_batch_activity(got, sparsify_params(tparams, tmasks), frames, PAPER)
    assert (got.accumulations, got.fetched_bits) == (want.accumulations,
                                                     want.fetched_bits)
