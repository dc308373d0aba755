"""The port's metrics registry and live Tables I/III gauges, held to the
live reference (CPU).

The registry's exposition text equals the reference's for the same
operations; the gauges read the same schedule geometry; a CPU engine with
a padded bucket counts the real rows only, equal to the ``stream``
counters over those rows; the host diagnostics mode counts what the
reference engine counts.
"""
import json
import sys
import threading
import time

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


# ---------------------------------------------------------------------------
# the serving worker's span log
# ---------------------------------------------------------------------------

def _span_engine(**kw):
    _, _, tparams, tmasks = setup(SMALL_REF, 1, 0.5)
    kw = {"backend": "stream", "max_batch": 4, "max_delay_ms": 5.0,
          "device": "cpu", **kw}
    return AsyncAMCServeEngine(tparams, SMALL, tmasks, **kw)


@pytest.fixture
def tracing_off(monkeypatch):
    """Request tracing off for the test (the previous tracer restored)."""
    from repro_torch.obs import trace
    monkeypatch.setattr(trace, "_tracer", None)
    return trace


def test_batch_spans_come_in_order_inside_their_step(tracing_off):
    trace = tracing_off
    t0 = time.perf_counter()
    trace.enable_tracing()
    with _span_engine() as engine:
        engine.classify(_iq(10, seed=6))
    w = trace._the_log().between(t0, float("inf"))
    assert not w.dropped
    sp = w.spans
    assert int(w.batches["n_real"].sum()) == 10
    top = ["batcher.wait", "batcher.gather", "batcher.form", "engine.step",
           "engine.resolve"]
    for b in w.batches["batch"]:
        mine = (sp["batch"] == b) & (sp["parent"] == -1)
        order = np.argsort(sp["t0"][mine])
        names = list(sp["name"][mine][order])
        assert names == top, names
        t_start, t_end = sp["t0"][mine][order], sp["t1"][mine][order]
        assert (t_start[1:] >= t_end[:-1]).all()      # in order, no overlap
        (step,) = sp["id"][mine][order][names.index("engine.step")],
        kids = sp["parent"] == step
        assert set(sp["name"][kids]) == {"step.eager", "step.unpack"}
        i = names.index("engine.step")
        assert (sp["t0"][kids] >= t_start[i]).all()
        assert (sp["t1"][kids] <= t_end[i]).all()
        assert len(set(sp["thread"][sp["batch"] == b])) == 1
    assert (sp["t1"] >= sp["t0"]).all()


def test_spans_off_record_nothing_and_enter_no_range(tracing_off, monkeypatch):
    trace = tracing_off
    log = trace._the_log()
    calls = {"range": 0, "thread_time": 0}
    real_range, real_thread_time = trace._enter_range, time.thread_time

    def counted_range(name):
        calls["range"] += 1
        return real_range(name)

    def counted_thread_time():
        calls["thread_time"] += 1
        return real_thread_time()

    monkeypatch.setattr(trace, "_enter_range", counted_range)
    monkeypatch.setattr(time, "thread_time", counted_thread_time)
    n = (log.spans.n, log.batches.n, log.waits.n)
    with _span_engine() as engine:
        engine.classify(_iq(9, seed=7))
    assert calls == {"range": 0, "thread_time": 0}
    assert (log.spans.n, log.batches.n, log.waits.n) == n
    assert trace.span_log() is None


def test_span_sites_off_allocate_nothing(tracing_off):
    trace = tracing_off
    assert trace.span("engine.step") is trace.span("step.sync") is trace._OFF
    for _ in range(100):   # warm
        with trace.span("engine.step"):
            pass
    before = sys.getallocatedblocks()
    for _ in range(20_000):
        with trace.span("engine.step"):
            with trace.span("step.sync"):
                pass
    assert sys.getallocatedblocks() - before < 50


def test_a_profiler_alone_turns_the_spans_on(tracing_off):
    trace = tracing_off
    from torch.profiler import ProfilerActivity, profile

    with _span_engine() as engine:
        engine.classify(_iq(4, seed=8))       # warm, untraced
        with profile(activities=[ProfilerActivity.CPU]):
            # the worker's poll that was waiting when the profiler started
            # records nothing; its next ones do
            engine.classify(_iq(4, seed=8))
            t0 = time.perf_counter()
            engine.classify(_iq(8, seed=9))
        t1 = time.perf_counter()
        # a poll of the worker's that began under the profiler (0.1 s)
        # still records; the ones after it do not
        time.sleep(0.25)
        t2 = time.perf_counter()
        engine.classify(_iq(4, seed=10))
    w = trace._the_log().between(t0, t1)
    assert int(w.batches["n_real"].sum()) == 8
    assert set(w.spans["name"]) >= {"engine.step", "step.eager",
                                    "engine.resolve"}
    assert not len(trace._the_log().between(t2, float("inf"))
                   .batches["batch"])


def test_profile_all_threads_records_the_worker_ranges(tracing_off):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with _span_engine() as engine:
        engine.classify(_iq(4, seed=8))
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            engine.classify(_iq(8, seed=11))
    names = {e.name for e in prof.events()}
    assert {"repro_torch::engine.step", "repro_torch::step.eager",
            "repro_torch::engine.resolve",
            "repro_torch::batcher.gather"} <= names


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _flush(mb, clock, at):
    """One get_batch on a fake clock moved to ``at`` from another thread
    while the batcher waits."""
    mover = threading.Timer(0.05, lambda: setattr(clock, "t", at))
    mover.start()
    try:
        return mb.get_batch(timeout=5.0)
    finally:
        mover.cancel()


@pytest.mark.parametrize("kind", ["size", "timeout", "pace", "close"])
def test_flush_kind_lateness_and_waits_on_a_fake_clock(tracing_off, kind):
    trace = tracing_off
    from repro_torch.serve import MicroBatcher

    clock = _Clock(10.0)
    mb = MicroBatcher((2, SMALL.input_width), max_batch=4, max_delay_ms=5.0,
                      pace_ms=1000.0 if kind == "pace" else 0.0, clock=clock)
    n = 4 if kind in ("size", "pace") else 2
    t_enq = [10.0 + 0.1 * i for i in range(n)]
    trace.enable_tracing()
    t0 = time.perf_counter()
    if kind == "pace":     # a first flush sets the gate 1 s ahead
        for _ in range(4):
            mb.submit(_iq(1)[0])
        assert mb.get_batch(timeout=1.0).n_real == 4
        t0 = time.perf_counter()
    for t in t_enq:
        clock.t = t
        mb.submit(_iq(1)[0])
    clock.t = t_pop = t_enq[-1] + 0.001
    if kind == "close":
        threading.Timer(0.05, mb.close).start()
        batch = mb.get_batch(timeout=5.0)
    elif kind == "size":
        batch = mb.get_batch(timeout=5.0)
    else:
        batch = _flush(mb, clock, t_pop + 1.0)
    assert batch is not None and batch.n_real == n
    w = trace._the_log().between(t0, float("inf"))
    assert list(w.batches["kind"]) == [kind]
    (late,) = w.batches["late_s"]
    t_flush = clock.t
    if kind == "timeout":
        assert late == (t_flush - (t_pop + 0.005))
    else:
        assert np.isnan(late)
    np.testing.assert_array_equal(w.waits["wait_s"],
                                  [t_flush - t for t in t_enq])
    assert set(w.waits["batch"]) == set(w.batches["batch"])
    mb.close()


def test_a_wrapped_ring_counts_dropped_and_between_flags_it():
    from repro_torch.obs.trace import SpanLog

    log = SpanLog(capacity=8)
    t0 = time.perf_counter()
    for _ in range(5):
        with log.span("engine.step"):
            pass
    t_mid = time.perf_counter()
    assert log.dropped == 0 and not log.between(t0, t_mid).dropped
    for _ in range(6):
        with log.span("engine.resolve"):
            pass
    assert log.spans.dropped == 3 and log.dropped == 3
    assert log.between(t0, t_mid).dropped            # lost its first spans
    w = log.between(t_mid, float("inf"))
    assert not w.dropped and list(w.spans["name"]) == ["engine.resolve"] * 6
    assert len(log.between(0.0, float("inf")).spans["id"]) == 8
    log.new_batch()
    log.record_batch(3, 4, "size", float("nan"), [0.1, 0.2, 0.3])
    assert log.waits.n == 3 and not log.waits.dropped
    log.record_batch(9, 16, "size", float("nan"), np.arange(9) * 0.01)
    assert log.waits.dropped == 4


def test_trace_dump_carries_the_worker_spans_to_perfetto(tracing_off):
    trace = tracing_off
    from repro_torch.obs.export import to_perfetto, validate_perfetto

    tracer = trace.enable_tracing()
    with _span_engine() as engine:
        engine.classify(_iq(6, seed=12))
    dump = json.loads(json.dumps(tracer.dump()))
    assert dump["spans"] and dump["batches"]
    assert sum(b["n_real"] for b in dump["batches"]) == 6
    forms = [ev for tr in dump["traces"] for ev in tr["events"]
             if ev["name"] == "batch-form"]
    assert {ev["batch"] for ev in forms} == {b["batch"] for b in dump["batches"]}
    doc = to_perfetto(dump)
    assert validate_perfetto(doc) == []
    worker = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert {e["name"] for e in worker} >= {"batcher.gather", "engine.step",
                                           "step.eager", "engine.resolve"}
    gathers = [e for e in worker if e["name"] == "batcher.gather"]
    assert all(e["args"]["flush"] in ("size", "timeout") for e in gathers)
    assert tracer.dump(limit=0)["spans"] == []
