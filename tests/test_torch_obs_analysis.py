"""The port's analysis plane held to the reference (CPU).

* The 27 contracts of ``tests/test_obs_analysis.py`` re-run on the port's
  objects: the time-series store, SLO burn rates, EWMA detection, the
  alert lifecycle and sinks, Perfetto export and its validator, the
  health/readiness surface, and the engine readiness probe on a port
  engine (the repaired ``is_ready()`` / ``closed``).
* Four fleet and HTTP contracts of ``tests/test_obs.py`` on port fleets:
  the shed request's trace, a two-replica timeline from the dump, the
  autoscaler's tick metrics and the metrics server's endpoints.
* The port's ``/metrics`` exposition, ``/timeseries`` and ``/alerts``
  bodies and Perfetto documents equal the reference's on the same
  registry contents; the port's Perfetto output passes the reference's
  validator.

As in the reference, recorders and alert managers run on fake clocks and
the burn-rate fixtures are hand-computed.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from _torch_parity import setup
from repro import obs as ref_obs
from repro.models.snn import SNNConfig as RefConfig
from repro_torch import obs as port_obs
from repro_torch.fleet import Autoscaler, FleetRouter, ShedError, engine_factory
from repro_torch.models.snn import SNNConfig
from repro_torch.obs import (
    AlertManager,
    BurnRateEngine,
    BurnRateWatcher,
    EwmaDetector,
    MetricsRegistry,
    MetricsServer,
    SLO,
    SeriesWatcher,
    TimeSeriesRecorder,
    TraceLog,
    WatchSpec,
    alert_health_check,
    autoscaler_sink,
    begin_trace,
    canary_shadow_sink,
    default_registry,
    default_serve_slos,
    disable_tracing,
    enable_tracing,
    engine_health_check,
    engine_ready_probe,
    get_tracer,
    log_file_sink,
    parse_slo_spec,
    scaled_windows,
    set_default_alert_manager,
    set_default_recorder,
    set_default_registry,
    to_perfetto,
    validate_perfetto,
)
from repro_torch.obs.slo import DEFAULT_BURN_WINDOWS, BurnWindow
from repro_torch.serve import AsyncAMCServeEngine

@pytest.fixture(autouse=True)
def isolated_obs():
    """Fresh default registry, no tracing, no default recorder/manager."""
    prev = set_default_registry(MetricsRegistry())
    disable_tracing()
    prev_rec = set_default_recorder(None)
    prev_mgr = set_default_alert_manager(None)
    try:
        yield
    finally:
        disable_tracing()
        set_default_recorder(prev_rec)
        set_default_alert_manager(prev_mgr)
        set_default_registry(prev)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


# ---------------------------------------------------------------------------
# registry edge cases feeding the analysis plane
# ---------------------------------------------------------------------------

def test_merged_differing_histogram_buckets_raises():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.histogram("lat", "", buckets=(0.1, 1.0)).observe(0.5)
    b.histogram("lat", "", buckets=(0.2, 2.0)).observe(0.5)
    with pytest.raises(ValueError, match="bucket"):
        MetricsRegistry.merged([a, b])


def test_value_on_labeled_family_without_labels():
    reg = MetricsRegistry()
    reg.counter("reqs_total", "", ("engine",)).labels(engine="e0").inc(3)
    # asking for the (nonexistent) unlabeled child is a clean 0.0, not a
    # crash — the SLO engine probes metric names it cannot assume exist
    assert reg.value("reqs_total") == 0.0
    assert reg.value("reqs_total", engine="nope") == 0.0
    assert reg.value("reqs_total", engine="e0") == 3.0
    assert reg.value("never_registered") == 0.0


def test_concurrent_sample_vs_registry_mutation():
    """A sweep racing family/child creation must neither crash nor
    corrupt: whatever it sees mid-mutation, the final sweep sees all."""
    reg = MetricsRegistry()
    clock = FakeClock()
    rec = TimeSeriesRecorder(reg, clock=clock)
    n_threads, per = 4, 40
    stop = threading.Event()
    errors = []

    def mutate(tid):
        try:
            for i in range(per):
                reg.counter(f"m{tid}_{i}_total", "", ("k",)).labels(
                    k=str(i % 3)).inc()
                reg.histogram(f"h{tid}_{i}", "", buckets=(1.0,)).observe(0.5)
        except Exception as e:  # pragma: no cover — the failure signal
            errors.append(e)

    def sweep():
        try:
            while not stop.is_set():
                rec.sample(clock.advance(1.0))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    sampler = threading.Thread(target=sweep)
    workers = [threading.Thread(target=mutate, args=(t,))
               for t in range(n_threads)]
    sampler.start()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    sampler.join()
    assert not errors
    rec.sample(clock.advance(1.0))  # one quiescent sweep sees everything
    assert len(rec.series()) == n_threads * per * 2


# ---------------------------------------------------------------------------
# time-series store
# ---------------------------------------------------------------------------

def test_series_monotonic_append_and_ring_bound():
    clock = FakeClock()
    reg = MetricsRegistry()
    c = reg.counter("n_total", "")
    rec = TimeSeriesRecorder(reg, capacity=4, clock=clock)
    for i in range(10):
        c.inc()
        rec.sample(clock.advance(1.0))
    s = rec.get("n_total")
    assert len(s) == 4                       # ring bound
    assert [t for t, _ in s.points()] == [7.0, 8.0, 9.0, 10.0]
    # a sweep whose clock did not advance is dropped, not reordered
    assert rec.sample(5.0) == 0
    assert [t for t, _ in s.points()] == [7.0, 8.0, 9.0, 10.0]


def test_counter_delta_rate_and_window_left_edge():
    clock = FakeClock()
    reg = MetricsRegistry()
    c = reg.counter("n_total", "")
    rec = TimeSeriesRecorder(reg, clock=clock)
    # samples at t=1..5 with cumulative values 10,20,40,40,70
    for v in (10, 20, 40, 40, 70):
        c.inc(v - reg.value("n_total"))
        rec.sample(clock.advance(1.0))
    s = rec.get("n_total")
    # trailing 2s window ending at t=5 covers [3,5]; window() keeps one
    # point left of the edge (t=3, v=40) so the delta is computable
    assert [t for t, _ in s.window(2.0)] == [3.0, 4.0, 5.0]
    assert s.delta(2.0) == 70 - 40
    assert s.rate(2.0) == (70 - 40) / 2.0
    # whole-history window: delta from the first sample
    assert s.delta(100.0) == 70 - 10
    # per-interval rates, negative deltas clamped (registry swap)
    assert [r for _, r in s.rates()] == [10.0, 20.0, 0.0, 30.0]
    assert s.values() == [10.0, 20.0, 40.0, 40.0, 70.0]


def test_histogram_fraction_over_and_quantile():
    clock = FakeClock()
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", "", buckets=(0.1, 0.5, 1.0))
    rec = TimeSeriesRecorder(reg, clock=clock)
    rec.sample(clock.advance(1.0))           # empty baseline at t=1
    for v in (0.05, 0.05, 0.3, 0.3, 0.3, 0.3, 0.7, 2.0):
        h.observe(v)
    rec.sample(clock.advance(1.0))           # t=2: 8 observations
    s = rec.get("lat_seconds")
    # 2 of 8 over 0.5s; bound snaps to the 0.5 bucket edge
    assert s.fraction_over(0.5, 10.0) == pytest.approx(2 / 8)
    assert s.fraction_over(0.4, 10.0) == pytest.approx(2 / 8)  # snapped up
    assert s.fraction_over(1.0, 10.0) == pytest.approx(1 / 8)
    # median: target 4 of 8 lands at the top of the (0.1, 0.5] bucket
    # with 2 below it -> 0.1 + 0.4 * (4-2)/4 = 0.3
    assert s.quantile_over(0.5, 10.0) == pytest.approx(0.3)
    # windows before any observation answer None, not zero
    assert s.fraction_over(0.5, 0.5, now=1.0) is None


def test_recorder_fleet_merged_callable_and_export():
    clock = FakeClock()
    parts = [MetricsRegistry(), MetricsRegistry()]
    for i, reg in enumerate(parts):
        reg.counter("reqs_total", "", ("replica",)).labels(
            replica=f"r{i}").inc(5 * (i + 1))
    rec = TimeSeriesRecorder(lambda: MetricsRegistry.merged(parts),
                             clock=clock)
    rec.sample(clock.advance(1.0))
    parts[0].counter("reqs_total", "", ("replica",)).labels(
        replica="r0").inc(5)
    rec.sample(clock.advance(1.0))
    assert rec.get("reqs_total", replica="r0").values() == [5.0, 10.0]
    assert rec.get("reqs_total", replica="r1").values() == [10.0, 10.0]
    doc = json.loads(json.dumps(rec.to_json()))   # JSON-clean
    assert doc["n_sweeps"] == 2
    assert {s["name"] for s in doc["series"]} == {"reqs_total"}
    assert len(doc["series"]) == 2


def test_recorder_validation():
    with pytest.raises(ValueError):
        TimeSeriesRecorder(capacity=1)
    with pytest.raises(ValueError):
        TimeSeriesRecorder(interval_s=0.0)
    rec = TimeSeriesRecorder(MetricsRegistry())
    rec.start()
    with pytest.raises(RuntimeError):
        rec.start()
    rec.stop()


# ---------------------------------------------------------------------------
# SLO burn rates: hand-computed fixtures on a fake clock
# ---------------------------------------------------------------------------

def _ratio_fixture(shed_per_tick, submitted_per_tick=100, ticks=20):
    """Counters advancing per 1s tick; returns (recorder, clock)."""
    clock = FakeClock()
    reg = MetricsRegistry()
    sub = reg.counter("repro_fleet_submitted_total", "")
    shed = reg.counter("repro_fleet_shed_total", "")
    rec = TimeSeriesRecorder(reg, capacity=1024, clock=clock)
    sub.inc(0)                               # materialize the children so
    shed.inc(0)                              # the t=0 baseline records 0s
    rec.sample(clock.t)
    for i in range(ticks):
        sub.inc(submitted_per_tick)
        shed.inc(shed_per_tick(i) if callable(shed_per_tick)
                 else shed_per_tick)
        rec.sample(clock.advance(1.0))
    return rec, clock


def test_burn_rate_ratio_hand_computed():
    # 5 shed per 100 submitted -> error rate 0.05; objective 0.999 ->
    # budget 0.001 -> burn = 0.05 / 0.001 = 50, over any window
    rec, _ = _ratio_fixture(5)
    slo = default_serve_slos()[0]
    assert slo.budget == pytest.approx(0.001)
    eng = BurnRateEngine(rec, [slo])
    assert eng.burn_rate(slo, 10.0) == pytest.approx(50.0)
    assert eng.burn_rate(slo, 5.0) == pytest.approx(50.0)


def test_burn_rate_windows_disagree_and_firing_needs_both():
    # shed 5/tick for ticks 0..9, clean for 10..19: at t=20 the 4s short
    # window is clean while the 20s long window still carries the burn
    rec, clock = _ratio_fixture(lambda i: 5 if i < 10 else 0)
    slo = SLO(name="avail", kind="ratio", objective=0.999,
              total_metric="repro_fleet_submitted_total",
              bad_metrics=("repro_fleet_shed_total",))
    windows = (BurnWindow("page", long_s=20.0, short_s=4.0, factor=14.4),)
    eng = BurnRateEngine(rec, [slo], windows=windows)
    # long: 50 shed / 2000 submitted = 0.025 err -> burn 25; short: 0
    assert eng.burn_rate(slo, 20.0) == pytest.approx(25.0)
    assert eng.burn_rate(slo, 4.0) == pytest.approx(0.0)
    st = eng.evaluate()[0]
    assert st.burns["page"] == (pytest.approx(25.0), pytest.approx(0.0))
    assert st.firing == [] and st.ok      # both windows must breach
    # rewind the question to t=10, mid-burn: both windows hot -> fires
    st10 = eng.evaluate(now=10.0)[0]
    assert st10.burns["page"][0] == pytest.approx(50.0)
    assert st10.burns["page"][1] == pytest.approx(50.0)
    assert st10.firing == ["page"]


def test_burn_rate_latency_and_gauge_kinds():
    clock = FakeClock()
    reg = MetricsRegistry()
    h = reg.histogram("repro_serve_request_latency_seconds", "",
                      buckets=(0.05, 0.25, 1.0))
    acc = reg.gauge("repro_canary_window_accuracy", "")
    rec = TimeSeriesRecorder(reg, clock=clock)
    rec.sample(clock.t)
    for v in [0.01] * 90 + [0.5] * 10:       # 10% of requests over 250ms
        h.observe(v)
    acc.set(0.8)
    rec.sample(clock.advance(1.0))
    lat = SLO(name="lat", kind="latency", objective=0.99,
              latency_metric="repro_serve_request_latency_seconds",
              bound_s=0.25)
    gauge = SLO(name="acc", kind="gauge", objective=0.9,
                gauge_metric="repro_canary_window_accuracy")
    eng = BurnRateEngine(rec, [lat, gauge])
    # latency: err 0.10 / budget 0.01 -> burn 10
    assert eng.burn_rate(lat, 10.0) == pytest.approx(10.0)
    # gauge: err (1-0.8)=0.2 / budget 0.1 -> burn 2
    assert eng.burn_rate(gauge, 10.0) == pytest.approx(2.0)
    # unknown metrics answer None (insufficient data), never 0
    ghost = SLO(name="g", kind="ratio", objective=0.5,
                total_metric="nope_total", bad_metrics=("also_nope",))
    assert eng.burn_rate(ghost, 10.0) is None


def test_scaled_windows_and_slo_validation():
    w = scaled_windows(1 / 60)
    assert [x.severity for x in w] == ["page", "ticket"]
    assert w[0].long_s == pytest.approx(60.0)
    assert w[0].short_s == pytest.approx(5.0)
    assert w[0].factor == DEFAULT_BURN_WINDOWS[0].factor   # unchanged
    assert w[1].long_s == pytest.approx(3 * 86400 / 60)
    with pytest.raises(ValueError):
        scaled_windows(0.0)
    with pytest.raises(ValueError):
        SLO(name="x", kind="nope", objective=0.9)
    with pytest.raises(ValueError):
        SLO(name="x", kind="ratio", objective=1.5,
            total_metric="t", bad_metrics=("b",))
    with pytest.raises(ValueError):
        SLO(name="x", kind="latency", objective=0.9,
            latency_metric="m", bound_s=0.0)


def test_parse_slo_spec():
    slos = parse_slo_spec("default")
    assert [s.name for s in slos] == ["availability", "latency"]
    slos = parse_slo_spec("availability=0.99, p99_ms=50@0.95, accuracy=0.9")
    assert slos[0].objective == 0.99
    assert slos[1].kind == "latency"
    assert slos[1].bound_s == pytest.approx(0.050)
    assert slos[1].objective == 0.95
    assert slos[2].kind == "gauge" and slos[2].objective == 0.9
    for bad in ("", "p99_ms", "frobnicate=1"):
        with pytest.raises(ValueError):
            parse_slo_spec(bad)


# ---------------------------------------------------------------------------
# EWMA anomaly detection
# ---------------------------------------------------------------------------

def test_ewma_warmup_shift_freeze_resolve():
    det = EwmaDetector(alpha=0.2, threshold=4.0, min_samples=8)
    rng = np.random.default_rng(0)
    base = 0.5 + 0.01 * rng.standard_normal(20)
    flags = [det.update(x)[0] for x in base]
    assert not any(flags)                     # warmup + in-band: quiet
    mean_before = det.mean
    # sustained level shift: every shifted sample keeps flagging because
    # the baseline freezes instead of absorbing the new level
    shifted = [det.update(0.15)[0] for _ in range(10)]
    assert all(shifted)
    assert det.mean == pytest.approx(mean_before)   # frozen
    ok, z = det.update(0.5)                   # back in band -> resolves
    assert not ok and abs(z) < 4.0


def test_ewma_direction_down_only():
    mk = lambda: EwmaDetector(alpha=0.2, threshold=3.0, min_samples=4,
                              direction="down")
    warmup = (0.5, 0.51, 0.49, 0.5, 0.5, 0.51)
    det = mk()
    for x in warmup:
        assert det.update(x)[0] is False
    assert det.update(0.1)[0] is True         # drop: flagged
    det = mk()                                # fresh baseline
    for x in warmup:
        det.update(x)
    ok, z = det.update(5.0)                   # rise: ignored (and the
    assert ok is False and z > 3.0            # EWMA absorbs it)
    with pytest.raises(ValueError):
        EwmaDetector(direction="sideways")


# ---------------------------------------------------------------------------
# alert lifecycle, sinks, watchers
# ---------------------------------------------------------------------------

def test_alert_dedup_refire_resolve_and_gauge():
    reg = MetricsRegistry()
    clock = FakeClock(100.0)
    mgr = AlertManager(reg, clock=clock)
    transitions = []
    mgr.add_sink(lambda a, tr: transitions.append((a.name, dict(a.labels),
                                                   tr)))
    a1 = mgr.fire("burn", labels={"severity": "page"}, severity="page",
                  value=20.0)
    a2 = mgr.fire("burn", labels={"severity": "ticket"}, severity="ticket",
                  value=2.0)
    again = mgr.fire("burn", labels={"severity": "page"}, severity="page",
                     value=30.0)
    assert again is a1 and a1.n_refires == 1 and a1.value == 30.0
    assert len(mgr.firing()) == 2
    # the gauge is the count of firing instances under the name
    assert reg.value("repro_alerts_firing", alert="burn") == 2
    clock.advance(5.0)
    resolved = mgr.resolve("burn", labels={"severity": "page"})
    assert resolved is a1 and a1.state == "resolved"
    assert a1.t_resolved == pytest.approx(105.0)
    assert reg.value("repro_alerts_firing", alert="burn") == 1  # ticket
    assert mgr.resolve("burn", labels={"severity": "page"}) is None
    assert mgr.firing(severity="ticket") == [a2]
    # refires do not re-notify; transitions are fire,fire,resolve
    assert [t[2] for t in transitions] == ["fire", "fire", "resolve"]
    doc = json.loads(json.dumps(mgr.to_json()))
    assert len(doc["firing"]) == 1 and len(doc["alerts"]) == 2
    assert doc["n_history"] == 2


def test_sink_errors_swallowed(tmp_path):
    mgr = AlertManager(MetricsRegistry())
    mgr.add_sink(lambda a, tr: 1 / 0)
    log = tmp_path / "alerts.jsonl"
    mgr.add_sink(log_file_sink(str(log)))
    mgr.fire("a", t=1.0)
    mgr.resolve("a", t=2.0)
    assert mgr.sink_errors == 2               # broken sink never propagates
    lines = [json.loads(l) for l in log.read_text().splitlines()]
    assert [l["transition"] for l in lines] == ["fire", "resolve"]
    assert lines[1]["state"] == "resolved"


def test_series_watcher_drift_fire_and_resolve():
    clock = FakeClock()
    reg = MetricsRegistry()
    g = reg.gauge("repro_activity_effective_density", "", ("layer",))
    rec = TimeSeriesRecorder(reg, clock=clock)
    mgr = AlertManager(reg, clock=clock)
    watcher = SeriesWatcher(rec, mgr, watches=[
        WatchSpec("repro_activity_effective_density",
                  alert_name="sparsity_drift", severity="ticket",
                  detector=lambda: EwmaDetector(alpha=0.2, threshold=4.0,
                                                min_samples=6))])
    rng = np.random.default_rng(1)

    def feed(level, n):
        for _ in range(n):
            g.labels(layer="conv1").set(level + 0.005 * rng.random())
            rec.sample(clock.advance(1.0))
            watcher.step()

    feed(0.5, 12)
    assert mgr.firing() == []
    feed(0.15, 3)                             # injected density shift
    firing = mgr.firing()
    assert [a.name for a in firing] == ["sparsity_drift"]
    assert dict(firing[0].labels) == {"layer": "conv1"}
    feed(0.5, 3)                              # revert -> resolves
    assert mgr.firing() == []
    assert reg.value("repro_alerts_firing", alert="sparsity_drift") == 0
    # watcher consumed each point exactly once (cursor, not re-reads)
    assert watcher._detectors[
        ("repro_activity_effective_density",
         (("layer", "conv1"),))].n >= 12


def test_burn_rate_watcher_and_autoscaler_pressure():
    rec, clock = _ratio_fixture(5, ticks=10)
    slo = default_serve_slos()[0]
    eng = BurnRateEngine(
        rec, [slo],
        windows=(BurnWindow("page", long_s=8.0, short_s=2.0, factor=14.4),))
    reg = MetricsRegistry()
    mgr = AlertManager(reg, clock=clock)

    class Fleet:
        def __init__(self):
            self.t, self.ups = 0.0, 0

        def signals(self):
            self.t += 1.0
            return dict(t=self.t, p99_ms=1.0, queue_depth=0, n_replicas=1,
                        shed=0, expired=0, workers=1, busy_s=0.0)

        def scale_up(self):
            self.ups += 1
            return "r2"

        def scale_down(self):
            return None

    fleet = Fleet()
    scaler = Autoscaler(fleet, target_p99_ms=100.0, up_patience=1,
                        cooldown_ticks=0, clock=lambda: fleet.t)
    mgr.add_sink(autoscaler_sink(scaler))
    watcher = BurnRateWatcher(eng, mgr)
    watcher.step()
    assert [a.name for a in mgr.firing()] == ["slo_burn:availability"]
    assert scaler.alert_pressure() == ["slo_burn:availability"]
    # every signal healthy, yet the burn pressure forces the scale-up
    tick = scaler.step()
    assert tick.action == "scale-up" and "alert pressure" in tick.reason
    assert fleet.ups == 1
    # burn stops -> alert resolves -> pressure clears -> holds again
    for _ in range(10):                       # clean ticks wash the window
        rec.sample(clock.advance(1.0))
    watcher.step()
    assert mgr.firing() == [] and scaler.alert_pressure() == []
    assert scaler.step().action == "hold"


def test_canary_shadow_sink_gating():
    class Monitor:
        def __init__(self):
            self.decision = "pending"
            self.steps = 0

        def step(self):
            self.steps += 1

    mon = Monitor()
    mgr = AlertManager(MetricsRegistry())
    mgr.add_sink(canary_shadow_sink(mon))
    mgr.fire("canary_accuracy_drift")         # not a sparsity-drift name
    assert mon.steps == 0
    mgr.fire("sparsity_drift", labels={"layer": "conv1"})
    assert mon.steps == 1
    mgr.resolve("sparsity_drift", labels={"layer": "conv1"})
    assert mon.steps == 1                     # resolves never trigger
    mon.decision = "promote"
    mgr.fire("events_per_frame_drift")
    assert mon.steps == 1                     # decided monitors left alone


# ---------------------------------------------------------------------------
# Perfetto export + validator
# ---------------------------------------------------------------------------

def _fake_dump(n=3, overlap=True):
    """A dump with n completed requests on one engine, overlapping."""
    log = TraceLog(capacity=16)
    for i in range(n):
        tr = log.begin()
        base = 100.0 + (0.0 if overlap else 10.0) * i
        tr.add("submit", t=base, engine="e0")
        tr.add("jit-step-start", t=base + 1.0 + i, backend="stream")
        tr.add("jit-step-end", t=base + 2.0 + i)
        tr.add("complete", t=base + 3.0 + i, pred=i)
        tr.finish()
    return log.dump()


def test_perfetto_export_lanes_and_validity():
    doc = to_perfetto(_fake_dump(3, overlap=True),
                      layer_ms={"conv1": 1.5, "conv2": 0.5})
    assert validate_perfetto(doc) == []
    evs = doc["traceEvents"]
    reqs = [e for e in evs if e["ph"] == "B" and e.get("cat") == "request"]
    assert len(reqs) == 3
    # overlapping requests on one engine must not share a tid (B/E stack)
    assert len({e["tid"] for e in reqs}) == 3
    # earliest event normalized to ts 0 on a common axis
    assert min(e["ts"] for e in evs if "ts" in e) == 0.0
    # the jit gap is named as a span, carrying its attrs
    jit = [e for e in evs if e.get("name") == "jit-step"]
    assert len(jit) == 3 and jit[0]["args"]["backend"] == "stream"
    # per-layer X events on their own track
    xs = [e for e in evs if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["conv1", "conv2"]
    assert xs[0]["dur"] == pytest.approx(1500.0)   # 1.5ms in us
    names = [e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"]
    assert "e0" in names and "layers" in names
    # non-overlapping requests reuse lane 1
    doc2 = to_perfetto(_fake_dump(3, overlap=False))
    reqs2 = [e for e in doc2["traceEvents"]
             if e["ph"] == "B" and e.get("cat") == "request"]
    assert {e["tid"] for e in reqs2} == {1}
    assert json.loads(json.dumps(doc)) == doc      # JSON-clean


def test_validate_perfetto_catches_broken_docs():
    assert validate_perfetto({}) == ["traceEvents missing or not a list"]
    bad = {"traceEvents": [
        {"pid": 1, "tid": 1, "ts": 0.0},                        # no ph
        {"ph": "B", "name": "a", "ts": 0.0},                    # no pid/tid
        {"ph": "E", "pid": 1, "tid": 1, "ts": 5.0},             # stray E
        {"ph": "B", "name": "b", "pid": 1, "tid": 1, "ts": 4.0},  # ts back
        {"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 9.0,
         "dur": -1.0},                                          # bad dur
        {"ph": "Q", "pid": 1, "tid": 1, "ts": 9.0},             # bad ph
    ]}
    problems = validate_perfetto(bad)
    assert len(problems) == 7                  # incl. the unclosed B
    assert any("missing ph" in p for p in problems)
    assert any("E without matching B" in p for p in problems)
    assert any("ts" in p and "previous" in p for p in problems)
    assert any("bad dur" in p for p in problems)
    assert any("unsupported ph" in p for p in problems)
    assert any("unclosed B" in p for p in problems)


def test_trace_dump_limit_keeps_newest():
    log = TraceLog(capacity=16)
    for i in range(5):
        tr = log.begin()
        tr.add("submit", t=float(i))
        tr.add("complete", t=float(i) + 0.5)
        tr.finish()
    assert [t["events"][0]["name"] for t in log.dump(limit=2)["traces"]]
    dump = log.dump(limit=2)
    assert len(dump["traces"]) == 2
    assert [t["t0"] for t in dump["traces"]] == [3.0, 4.0]
    assert dump["n_completed"] == 5            # headline counters intact
    assert log.dump(limit=0)["traces"] == []
    with pytest.raises(ValueError):
        log.dump(limit=-1)


def test_enable_tracing_per_pass_isolation():
    """Regression: each bench pass gets a fresh ring at its own capacity —
    a later ``enable_tracing`` must not inherit the previous pass's
    counters or traces (the obs_bench per-attempt isolation)."""
    log1 = enable_tracing(sample_every=1, capacity=8)
    for _ in range(8):
        tr = log1.begin()
        tr.add("submit")
        tr.add("complete")
        tr.finish()
    assert log1.n_completed == 8
    log2 = enable_tracing(sample_every=1, capacity=4)
    assert log2 is get_tracer() and log2 is not log1
    assert log2.n_seen == 0 and log2.n_completed == 0
    assert log2.capacity == 4 and log2.dump()["traces"] == []
    # the old pass's artifact is still intact for whoever held it
    assert log1.n_completed == 8 and len(log1.dump()["traces"]) == 8


# ---------------------------------------------------------------------------
# HTTP surface: health checks, readiness probes, query params, HEAD
# ---------------------------------------------------------------------------

def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.read()


def test_healthz_checks_and_readyz_probes():
    with MetricsServer(port=0) as srv:
        # stock state: no checks/probes -> healthy and ready
        code, body, _ = srv._route("/healthz", {})
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body, _ = srv._route("/readyz", {})
        assert code == 200 and json.loads(body)["ready"] is True

        ready = {"ok": False}
        srv.add_ready_probe("engine", lambda: ready["ok"])
        code, body, _ = srv._route("/readyz", {})
        assert code == 503 and json.loads(body)["waiting_on"] == ["engine"]
        ready["ok"] = True
        code, _, _ = srv._route("/readyz", {})
        assert code == 200

        mgr = AlertManager(MetricsRegistry())
        set_default_alert_manager(mgr)
        srv.add_health_check("alerts", alert_health_check())
        srv.add_health_check("boom", lambda: 1 / 0)   # broken check
        code, body, _ = srv._route("/healthz", {})
        failed = json.loads(body)["failed"]
        assert code == 503 and [f["check"] for f in failed] == ["boom"]
        mgr.fire("slo_burn:latency", severity="page")
        code, body, _ = srv._route("/healthz", {})
        failed = json.loads(body)["failed"]
        assert {f["check"] for f in failed} == {"alerts", "boom"}
        assert "slo_burn:latency" in failed[0]["reason"]
        # ticket-severity alerts do not degrade liveness
        mgr.resolve("slo_burn:latency")
        mgr.fire("sparsity_drift", severity="ticket")
        code, body, _ = srv._route("/healthz", {})
        assert [f["check"] for f in json.loads(body)["failed"]] == ["boom"]


def test_http_endpoints_limit_head_and_analysis_routes():
    reg = MetricsRegistry()
    set_default_registry(reg)
    reg.counter("smoke_total", "").inc(2)
    with MetricsServer(port=0) as srv:
        # /timeseries and /alerts 404 until the defaults are installed
        for path in ("/timeseries", "/alerts"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url(path))
            assert e.value.code == 404
        clock = FakeClock()
        rec = TimeSeriesRecorder(reg, clock=clock)
        rec.sample(clock.advance(1.0))
        set_default_recorder(rec)
        mgr = AlertManager(reg, clock=clock)
        mgr.fire("x", severity="ticket")
        set_default_alert_manager(mgr)
        status, body = _get(srv.url("/timeseries"))
        assert status == 200
        assert json.loads(body)["n_sweeps"] == 1
        status, body = _get(srv.url("/alerts"))
        assert json.loads(body)["firing"][0]["name"] == "x"

        enable_tracing(sample_every=1)
        for i in range(5):
            tr = get_tracer().begin()
            tr.add("submit", t=float(i), engine="e0")
            tr.add("complete", t=float(i) + 0.1)
            tr.finish()
        status, body = _get(srv.url("/trace?limit=2"))
        assert len(json.loads(body)["traces"]) == 2
        code, body, _ = srv._route("/trace", {"limit": ["bogus"]})
        assert code == 400
        status, body = _get(srv.url("/trace/perfetto?limit=3"))
        doc = json.loads(body)
        assert validate_perfetto(doc) == []
        reqs = [e for e in doc["traceEvents"]
                if e["ph"] == "B" and e.get("cat") == "request"]
        assert len(reqs) == 3
        # HEAD: headers only, no body, on every route
        status, body = _get(srv.url("/metrics"), method="HEAD")
        assert status == 200 and body == b""
        status, body = _get(srv.url("/healthz"), method="HEAD")
        assert status == 200 and body == b""


# ---------------------------------------------------------------------------
# engine readiness: the one real-engine test, on a port engine
# ---------------------------------------------------------------------------

def test_engine_ready_and_closed_probes():
    spec = dict(conv_specs=((3, 2, 4),), pool=2, fc_specs=((32, 5),),
                input_width=16, timesteps=2, n_classes=5)
    _, _, params, masks = setup(RefConfig(**spec), 0, 0.5)
    eng = AsyncAMCServeEngine(params, SNNConfig(**spec), masks=masks,
                              backend="dense", buckets=[2], max_delay_ms=5,
                              device="cpu")
    probe = engine_ready_probe(eng)
    health = engine_health_check(eng)
    try:
        # the warm-up runs every bucket in __init__: the engine is born ready
        assert eng.is_ready() and probe()
        assert not eng.closed and health() is None
    finally:
        eng.close()
    assert eng.closed and not eng.is_ready() and not probe()
    assert "closed" in health()


def test_engine_without_warmup_is_ready_at_its_first_step():
    spec = dict(conv_specs=((3, 2, 4),), pool=2, fc_specs=((32, 5),),
                input_width=16, timesteps=2, n_classes=5)
    _, _, params, masks = setup(RefConfig(**spec), 0, 0.5)
    with AsyncAMCServeEngine(params, SNNConfig(**spec), masks=masks,
                             backend="dense", buckets=[2], max_delay_ms=5,
                             warmup=False, device="cpu") as eng:
        probe = engine_ready_probe(eng)
        assert not eng.is_ready() and not probe()
        eng.submit(np.zeros((2, 16), np.float32)).result(timeout=30.0)
        assert eng.is_ready() and probe()


# ---------------------------------------------------------------------------
# fleet and HTTP contracts of tests/test_obs.py, on port fleets
# ---------------------------------------------------------------------------

FLEET_SPEC = dict(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
                  fc_specs=((32, 16), (16, 5)), input_width=16, timesteps=3,
                  n_classes=5)
FLEET_CFG = SNNConfig(**FLEET_SPEC)
FRAME_SHAPE = (2, FLEET_CFG.input_width)

#: The full success timeline, in order, for a fleet-submitted request.
HAPPY_PATH = ["submit", "admit", "enqueue", "dequeue", "batch-form",
              "jit-step-start", "jit-step-end", "complete"]


@pytest.fixture(scope="module")
def weights():
    _, _, params, masks = setup(RefConfig(**FLEET_SPEC), 0, 0.5)
    return params, masks


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + FRAME_SHAPE).astype(np.float32)


def test_shed_request_trace(weights):
    """Admission refusal at the fleet door records the shed terminal —
    after a per-replica ``replica-full`` hop for every replica tried."""
    params, masks = weights
    enable_tracing(sample_every=1)
    fleet = FleetRouter(
        engine_factory(params, FLEET_CFG, masks=masks, backend="dense",
                       buckets=[2], max_delay_ms=50, pace_ms=500.0,
                       max_queue=2, device="cpu"),
        replicas=1)
    try:
        sheds = 0
        for i in range(12):
            try:
                fleet.submit(_iq(12)[i])
            except ShedError:
                sheds += 1
        assert sheds > 0
        shed_traces = [tr for tr in get_tracer().completed()
                       if tr.terminal() == "shed"]
        assert len(shed_traces) == sheds
        names = [ev.name for ev in shed_traces[0].events]
        assert names[0] == "submit"
        assert "replica-full" in names and names[-1] == "shed"
        assert default_registry().value(
            "repro_fleet_shed_total", reason="queue",
            priority="realtime") == sheds
    finally:
        fleet.close()


def test_fleet_two_replica_timeline_from_dump(weights):
    """Full span timelines reconstructible from the trace-dump artifact,
    on the fleet path, with two replicas; its Perfetto export passes both
    packages' validators."""
    params, masks = weights
    enable_tracing(sample_every=1)
    fleet = FleetRouter(
        engine_factory(params, FLEET_CFG, masks=masks, backend="dense",
                       buckets=[4], max_delay_ms=5, device="cpu"),
        replicas=2)
    try:
        preds = fleet.classify(_iq(12), timeout=60)
        assert preds.shape == (12,)
    finally:
        fleet.close()
    dump = json.loads(json.dumps(get_tracer().dump()))  # JSON round-trip
    assert dump["n_seen"] == 12 and dump["n_completed"] == 12
    replicas_seen = set()
    for rec in dump["traces"]:
        assert rec["terminal"] == "complete"
        assert [ev["name"] for ev in rec["events"]] == HAPPY_PATH
        admit = rec["events"][1]
        replicas_seen.add(admit["replica"])
        # spans are reconstructible and non-negative end to end
        assert len(rec["spans"]) == len(HAPPY_PATH) - 1
        assert all(s["seconds"] >= 0 for s in rec["spans"])
        assert rec["total_s"] >= 0
    assert len(replicas_seen) == 2, "JSQ must have used both replicas"
    assert default_registry().value("repro_fleet_submitted_total") == 12
    doc = to_perfetto(dump)
    assert validate_perfetto(doc) == []
    assert ref_obs.validate_perfetto(doc) == []
    assert doc == ref_obs.to_perfetto(dump)


class _FakeFleet:
    def __init__(self):
        self.t = 0.0
        self.sig = dict(p99_ms=0.0, queue_depth=0, n_replicas=1,
                        shed=0, expired=0, workers=1, busy_s=0.0)
        self.ups = 0

    def signals(self):
        self.t += 1.0
        return dict(self.sig, t=self.t)

    def scale_up(self):
        self.ups += 1
        self.sig["n_replicas"] += 1
        return f"r{self.sig['n_replicas']}"

    def scale_down(self):
        return None


def test_autoscaler_emits_tick_metrics():
    fleet = _FakeFleet()
    scaler = Autoscaler(fleet, target_p99_ms=10.0, up_patience=1,
                        cooldown_ticks=0, clock=lambda: fleet.t)
    scaler.step()                       # p99 0 -> hold
    fleet.sig["p99_ms"] = 50.0
    scaler.step()                       # breach -> scale-up
    reg = default_registry()
    assert reg.value("repro_autoscale_ticks_total", action="hold") == 1
    assert reg.value("repro_autoscale_ticks_total", action="scale-up") == 1
    assert reg.value("repro_autoscale_p99_ms") == 50.0
    assert reg.value("repro_autoscale_replicas") == 1  # count at tick time
    assert fleet.ups == 1


def _get3(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_metrics_server_endpoints():
    reg = default_registry()
    reg.counter("smoke_total", "smoke").inc(3)
    with MetricsServer(port=0) as srv:
        status, ctype, body = _get3(srv.url("/metrics"))
        assert status == 200
        assert ctype.startswith("text/plain; version=0.0.4")
        assert b"smoke_total 3" in body
        status, ctype, body = _get3(srv.url("/healthz"))
        assert status == 200 and json.loads(body)["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get3(srv.url("/trace"))     # tracing disabled -> 404
        assert e.value.code == 404
        enable_tracing(sample_every=1)
        tr = begin_trace()
        tr.add("submit")
        tr.add("complete")
        tr.finish()
        status, _, body = _get3(srv.url("/trace"))
        assert status == 200
        assert json.loads(body)["n_completed"] == 1


# ---------------------------------------------------------------------------
# the port's documents against the reference's, on the same contents
# ---------------------------------------------------------------------------

def _analysis_plane(mod, clock):
    """Registry, recorder and alert manager of ``mod`` (reference or port)
    driven through the same operations on ``clock``."""
    reg = mod.MetricsRegistry()
    sub = reg.counter("repro_fleet_submitted_total", "admitted")
    shed = reg.counter("repro_fleet_shed_total", "shed",
                       ("reason", "priority"))
    lat = reg.histogram("repro_serve_request_latency_seconds", "lat",
                        ("engine",), buckets=(0.001, 0.01, 0.1, 1.0))
    depth = reg.gauge("repro_serve_queue_depth", "depth", ("engine",))
    rec = mod.TimeSeriesRecorder(reg, capacity=64, clock=clock)
    mgr = mod.AlertManager(reg, clock=clock)
    sub.inc(0)
    rec.sample(clock.t)
    for i in range(6):
        sub.inc(100)
        shed.labels(reason="queue", priority="bulk").inc(3 + i)
        for v in (0.0005, 0.004, 0.03 * (i + 1), 0.5):
            lat.labels(engine=f"replica-{i % 2}").observe(v)
        depth.labels(engine="replica-0").set(i)
        rec.sample(clock.advance(1.0))
    watcher = mod.BurnRateWatcher(
        mod.BurnRateEngine(rec, mod.parse_slo_spec("default, p99_ms=50"),
                           windows=mod.scaled_windows(1 / 600)), mgr)
    watcher.step()
    mgr.fire("sparsity_drift", labels={"layer": "conv1"},
             severity="ticket", value=0.15)
    clock.advance(2.0)
    mgr.resolve("sparsity_drift", labels={"layer": "conv1"})
    return reg, rec, mgr


def test_exposition_timeseries_and_alerts_equal_reference():
    reg, rec, mgr = _analysis_plane(port_obs, FakeClock())
    ref_reg, ref_rec, ref_mgr = _analysis_plane(ref_obs, FakeClock())
    assert mgr.firing() and len(mgr.history) == len(ref_mgr.history)
    assert reg.to_prometheus() == ref_reg.to_prometheus()
    assert json.dumps(rec.to_json()) == json.dumps(ref_rec.to_json())
    assert json.dumps(mgr.to_json()) == json.dumps(ref_mgr.to_json())
    # the same bodies through both packages' HTTP routes
    set_default_registry(reg)
    set_default_recorder(rec)
    set_default_alert_manager(mgr)
    old = (ref_obs.set_default_registry(ref_reg),
           ref_obs.set_default_recorder(ref_rec),
           ref_obs.set_default_alert_manager(ref_mgr))
    try:
        with MetricsServer(port=0) as srv, \
                ref_obs.MetricsServer(port=0) as ref_srv:
            for path in ("/metrics", "/timeseries", "/alerts"):
                code, body, ctype = srv._route(path, {})
                assert (code, body, ctype) == ref_srv._route(path, {}), path
                assert code == 200
    finally:
        ref_obs.set_default_registry(old[0])
        ref_obs.set_default_recorder(old[1])
        ref_obs.set_default_alert_manager(old[2])


def test_perfetto_documents_equal_reference():
    for n, overlap in ((3, True), (4, False)):
        dump = _fake_dump(n, overlap=overlap)
        layer_ms = {"conv1": 1.5, "conv2": 0.5, "fc1": 0.25}
        doc = to_perfetto(dump, layer_ms=layer_ms)
        assert doc == ref_obs.to_perfetto(dump, layer_ms=layer_ms)
        assert ref_obs.validate_perfetto(doc) == []
    broken = {"traceEvents": [{"ph": "E", "pid": 1, "tid": 1, "ts": 5.0},
                              {"ph": "B", "name": "b", "pid": 1, "tid": 1,
                               "ts": 4.0}]}
    assert validate_perfetto(broken) == ref_obs.validate_perfetto(broken)
