"""The port's fleet tier held to the reference's contracts (CPU).

The 24 contracts of ``tests/test_fleet.py`` re-run on port engines
(``repro_torch.fleet`` over ``repro_torch.serve.AsyncAMCServeEngine`` on
the CPU): deadlines that never reach the served step, priority order,
realtime p99 under saturation, shedding at the door and on a p99 breach,
the retirement fence, fault propagation, scale-down drains, scale-up
lineage replay, a fleet-wide hot-swap, fair stats merging, replica
bounds, and the autoscaler's control law on a fake fleet and live.  The
reduced config of ``tests/test_fleet.py``; weights come from the
reference (``tests/_torch_parity.py``).

As in the reference, saturation is built from the batcher's ``pace_ms``
gate (a capacity configuration, not a host-speed race), the autoscaler
runs on fake clocks, and timing assertions that touch the wall clock use
the reference's margins.
"""
import threading
import time

import numpy as np
import pytest

from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from _torch_parity import setup
from repro.models.snn import SNNConfig as RefConfig
from repro_torch.deploy import hot_swap
from repro_torch.fleet import (
    Autoscaler,
    FleetRouter,
    ShedError,
    engine_factory,
    merge_stats,
)
from repro_torch.models.snn import SNNConfig
from repro_torch.serve import (
    AsyncAMCServeEngine,
    DeadlineExceeded,
    MicroBatcher,
    QueueFull,
    ServeStats,
)

SPEC = dict(
    conv_specs=((3, 2, 4), (3, 4, 8)),
    pool=2,
    fc_specs=((32, 16), (16, 5)),
    input_width=16,
    timesteps=3,
    n_classes=5,
)
CFG = SNNConfig(**SPEC)
FRAME_SHAPE = (2, CFG.input_width)


@pytest.fixture(scope="module")
def weights():
    """The reference's seed-0 weights at density 0.5, as port tensors."""
    _, _, params, masks = setup(RefConfig(**SPEC), 0, 0.5)
    return params, masks


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + FRAME_SHAPE).astype(np.float32)


def _factory(weights, **kw):
    params, masks = weights
    kw.setdefault("backend", "dense")
    kw.setdefault("buckets", [4])
    kw.setdefault("max_delay_ms", 5)
    return engine_factory(params, CFG, masks=masks, device="cpu", **kw)


# ---------------------------------------------------------------------------
# deadlines: expired requests fail fast and never reach the served step
# ---------------------------------------------------------------------------

def test_expired_request_never_reaches_step(weights):
    params, masks = weights
    eng = AsyncAMCServeEngine(params, CFG, masks=masks, backend="dense",
                              buckets=[4], max_delay_ms=5,
                              pace_ms=200.0, warmup=True, device="cpu")
    try:
        ver = eng.get_version("default")
        calls = {"n": 0, "batch_sizes": []}
        inner = ver.serve_step     # what the port's worker calls

        def counting_step(frames):
            calls["n"] += 1
            calls["batch_sizes"].append(int(frames.shape[0]))
            return inner(frames)

        ver.serve_step = counting_step
        # the pace gate spaces *consecutive* flushes 200 ms apart: serve a
        # plug request first, then a 5 ms deadline is guaranteed-expired
        # by the time the next flush dequeues
        plug = eng.submit(_iq(1)[0], deadline_ms=5_000.0)
        assert plug.result(timeout=10.0) is not None
        doomed = eng.submit(_iq(1)[0], deadline_ms=5.0)
        time.sleep(0.03)
        live = eng.submit(_iq(1, seed=1)[0], deadline_ms=5_000.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=5.0)
        assert live.result(timeout=10.0) is not None
        # the expired frame consumed zero served-step slots: exactly two
        # batches ran (plug, live) and only those two frames were served
        assert calls["n"] == 2
        assert eng.stats.requests == 2
        assert eng.batcher.n_expired == 1
    finally:
        eng.close()


def test_deadline_propagates_through_fleet(weights):
    fleet = FleetRouter(_factory(weights, pace_ms=200.0), replicas=1,
                        default_deadline_ms=5.0)
    try:
        fut = fleet.submit(_iq(1)[0])       # inherits the default deadline
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=5.0)
        assert fleet.batcher.n_expired == 1
        assert fleet.export_stats()["n_expired"] == 1
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# priorities: weighted dequeue order, realtime ahead of bulk
# ---------------------------------------------------------------------------

def test_priority_dequeue_order_deterministic():
    mb = MicroBatcher(FRAME_SHAPE, max_batch=1, max_delay_ms=1)
    frames = _iq(8)
    order = []
    for i in range(4):
        f = mb.submit(frames[i], priority="bulk")
        f.add_done_callback(lambda _f, i=i: order.append(("bulk", i)))
    for i in range(4):
        f = mb.submit(frames[4 + i], priority="realtime")
        f.add_done_callback(lambda _f, i=i: order.append(("rt", i)))
    # drain one-request batches by hand: the weighted round-robin
    # (realtime:8, bulk:1) must serve all four realtime first even though
    # every bulk request arrived earlier, and FIFO within each class
    for _ in range(8):
        batch = mb.get_batch(timeout=1.0)
        for req in batch.requests:
            req.future.set_result(0)
    mb.close()
    assert order[:4] == [("rt", 0), ("rt", 1), ("rt", 2), ("rt", 3)]
    assert order[4:] == [("bulk", 0), ("bulk", 1), ("bulk", 2), ("bulk", 3)]


def test_realtime_p99_beats_bulk_under_saturation(weights):
    """Saturate one paced replica; realtime tail must stay below bulk's."""
    params, masks = weights
    eng = AsyncAMCServeEngine(params, CFG, masks=masks, backend="dense",
                              buckets=[4], max_delay_ms=2,
                              pace_ms=25.0, warmup=True, device="cpu")
    lat = {"realtime": [], "bulk": []}
    lock = threading.Lock()
    try:
        rng = np.random.default_rng(7)
        frames = _iq(64, seed=3)
        futures = []
        # enqueue a standing backlog (mixed classes, seeded order) much
        # larger than one batch: dequeue order is then pure policy
        kinds = ["bulk" if rng.random() < 0.5 else "realtime"
                 for _ in range(64)]
        t0 = time.perf_counter()
        for i, kind in enumerate(kinds):
            fut = eng.submit(frames[i], priority=kind)

            def done(_f, kind=kind, t0=t0):
                with lock:
                    lat[kind].append(time.perf_counter() - t0)

            fut.add_done_callback(done)
            futures.append(fut)
        for fut in futures:
            fut.result(timeout=60.0)
        p99_rt = float(np.percentile(lat["realtime"], 99))
        p99_bulk = float(np.percentile(lat["bulk"], 99))
        assert p99_rt < p99_bulk, (
            f"realtime p99 {p99_rt*1e3:.1f}ms not below bulk "
            f"{p99_bulk*1e3:.1f}ms")
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# admission control / shedding
# ---------------------------------------------------------------------------

def test_no_shed_below_saturation(weights):
    fleet = FleetRouter(_factory(weights, max_queue=64), replicas=1)
    try:
        out = fleet.classify(_iq(16), timeout=30.0)
        assert out.shape == (16,)
        assert fleet.n_shed == 0
        assert fleet.export_stats()["n_shed"] == 0
    finally:
        fleet.close()


def test_queue_bound_sheds_at_the_door(weights):
    # pace gate effectively freezes the workers; queues fill to max_queue
    fleet = FleetRouter(_factory(weights, max_queue=4, pace_ms=60_000.0),
                        replicas=2)
    try:
        frames = _iq(16, seed=2)
        admitted = []
        for i in range(8):      # 2 replicas x max_queue=4
            admitted.append(fleet.submit(frames[i]))
        with pytest.raises(ShedError) as exc:
            fleet.submit(frames[8])
        assert exc.value.reason == "queue"
        assert fleet.n_shed == 1
        assert fleet.shed_by_reason["queue"] == 1
        assert fleet.shed_by_priority["realtime"] == 1
        # JSQ spread the admitted load evenly across both replicas
        depths = [r.engine.batcher.qsize() for r in fleet._snapshot()]
        assert depths == [4, 4]
        for fut in admitted:
            fut.cancel()
    finally:
        fleet.close()


def test_p99_breach_sheds_bulk_only(weights):
    fleet = FleetRouter(_factory(weights), replicas=1, shed_p99_ms=0.5)
    try:
        # prime the latency window past the (absurdly low) threshold
        fleet.classify(_iq(8), timeout=30.0)
        assert fleet.recent_p99_ms() > 0.5
        with pytest.raises(ShedError) as exc:
            fleet.submit(_iq(1)[0], priority="bulk")
        assert exc.value.reason == "p99"
        # realtime still admitted during the breach
        fut = fleet.submit(_iq(1)[0], priority="realtime")
        assert fut.result(timeout=30.0) is not None
        assert fleet.shed_by_priority["bulk"] == 1
        assert fleet.shed_by_priority["realtime"] == 0
    finally:
        fleet.close()


def test_rejects_unknown_priority(weights):
    fleet = FleetRouter(_factory(weights), replicas=1)
    try:
        with pytest.raises(ValueError):
            fleet.submit(_iq(1)[0], priority="best-effort")
    finally:
        fleet.close()


def test_fenced_replica_takes_no_new_traffic(weights):
    """The scale_down retirement fence: a replica whose fence is up must
    be skipped by submit even while it still sits in a (stale) routing
    snapshot — the window in which a request could otherwise land behind
    the drain barrier and be dropped by the subsequent engine close."""
    fleet = FleetRouter(_factory(weights), replicas=2)
    try:
        fenced = fleet._snapshot()[1]
        with fenced.gate:       # exactly what scale_down does before draining
            fenced.fenced = True
        futures = [fleet.submit(_iq(4, seed=13)[i]) for i in range(4)]
        # all traffic routed around the fence (JSQ would otherwise have
        # spread it across both replicas)
        assert fenced.engine.batcher.qsize() == 0
        for f in futures:
            assert f.result(timeout=30.0) is not None
        assert fenced.engine.stats.requests == 0
        assert fleet.n_shed == 0
    finally:
        fleet.close()


def test_engine_fault_propagates_instead_of_shedding(weights):
    """Only EngineClosed/QueueFull reroute to the next replica; a genuine
    engine fault must propagate, not be miscounted as a queue shed."""
    fleet = FleetRouter(_factory(weights), replicas=1)
    try:
        rep = fleet._snapshot()[0]
        orig = rep.engine.submit

        def broken(*a, **kw):
            raise RuntimeError("worker fault")

        rep.engine.submit = broken
        with pytest.raises(RuntimeError, match="worker fault"):
            fleet.submit(_iq(1)[0])
        assert fleet.n_shed == 0
        rep.engine.submit = orig
        assert fleet.submit(_iq(1)[0]).result(timeout=30.0) is not None
    finally:
        fleet.close()


def test_scale_down_drains_reordered_priority_backlog(weights):
    """scale_down on a replica whose queue holds bulk requests *behind*
    already-served realtime ones: the drain barrier must wait for the
    low-seq bulk backlog (a max-seq watermark would release early and
    the close would fail the still-queued futures)."""
    fleet = FleetRouter(_factory(weights, pace_ms=40.0), replicas=2)
    try:
        rep = fleet._snapshot()[1]
        frames = _iq(10, seed=17)
        # enqueue directly into the doomed replica: bulk first (low seqs),
        # then realtime (high seqs) — WRR hands the realtime ones first
        futures = [rep.engine.submit(frames[i], priority="bulk")
                   for i in range(5)]
        futures += [rep.engine.submit(frames[5 + i], priority="realtime")
                    for i in range(5)]
        assert fleet.scale_down(drain_timeout=60.0) == rep.name
        # zero dropped requests: every future resolved with a prediction
        for f in futures:
            assert f.result(timeout=30.0) is not None
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# elasticity: scale up/down, lineage replay, merged stats
# ---------------------------------------------------------------------------

def test_scale_up_down_and_serve(weights):
    fleet = FleetRouter(_factory(weights), replicas=1, max_replicas=3)
    try:
        assert fleet.n_replicas == 1
        assert fleet.scale_up() == "replica-1"
        assert fleet.scale_up() == "replica-2"
        assert fleet.scale_up() is None          # at max
        out = fleet.classify(_iq(12, seed=5), timeout=30.0)
        assert out.shape == (12,)
        assert fleet.scale_down() == "replica-2"  # youngest first
        assert fleet.n_replicas == 2
        # retired replicas keep counting in the merged fleet stats
        assert fleet.stats.requests == 12
        assert fleet.export_stats()["retired"] == ["replica-2"]
        out = fleet.classify(_iq(4, seed=6), timeout=30.0)
        assert out.shape == (4,)
    finally:
        fleet.close()


def test_scale_up_replays_deploy_lineage(weights):
    params, masks = weights
    fleet = FleetRouter(_factory(weights), replicas=1, max_replicas=2)
    try:
        fleet.bind_version("v2", params, masks=masks, backend="dense",
                           warmup=False)
        fleet.swap_to("v2")
        name = fleet.scale_up()
        assert name is not None
        late = next(r.engine for r in fleet._snapshot() if r.name == name)
        # the late joiner serves the same version table and primary
        assert sorted(late.versions()) == ["default", "v2"]
        assert late.active_version == "v2"
        assert fleet.active_version == "v2"
    finally:
        fleet.close()


def test_fleet_wide_hot_swap_zero_failures(weights):
    """deploy.hot_swap on a 2-replica fleet: drains, flips everywhere."""
    params, masks = weights
    fleet = FleetRouter(_factory(weights), replicas=2)
    try:
        report = hot_swap(fleet, params, masks, label="v2",
                          backend="dense", warmup=False)
        assert report.drained
        assert report.old_label == "default" and report.new_label == "v2"
        for rep in fleet._snapshot():
            assert rep.engine.active_version == "v2"
        out = fleet.classify(_iq(8, seed=9), timeout=30.0)
        assert out.shape == (8,)
        stats = fleet.version_stats()
        assert stats["v2"].requests == 8
    finally:
        fleet.close()


def test_merge_stats_counters_and_window():
    a, b = ServeStats(backend="dense"), ServeStats(backend="dense")
    a.requests, b.requests = 3, 5
    a.batches, b.batches = 1, 2
    a.wall_s, b.wall_s = 0.5, 2.0
    a.record_latencies([0.010, 0.020])
    b.record_latencies([0.030])
    m = merge_stats([a, b])
    assert m.requests == 8 and m.batches == 3
    assert m.wall_s == 2.0                  # widest window, not the sum
    assert sorted(m.latencies_s) == [0.010, 0.020, 0.030]


def test_merge_stats_fair_window():
    """Full per-replica windows must merge fairly, not last-writer-wins.

    A slow replica and a fast replica each carry a full MAX_SAMPLES
    history.  Concatenate-then-trim would keep only the final replica's
    window, so the merged p99 would be whichever replica happened to be
    listed last.  The fair merge keeps an equal share of each, and the
    slow replica's tail must survive regardless of merge order.
    """
    cap = ServeStats.MAX_SAMPLES
    slow, fast = ServeStats(backend="dense"), ServeStats(backend="dense")
    slow.record_latencies([1.0] * cap)      # 1000 ms each
    fast.record_latencies([0.001] * cap)    # 1 ms each
    for order in ([slow, fast], [fast, slow]):
        m = merge_stats(order)
        assert len(m.latencies_s) <= cap
        lat = np.asarray(m.latencies_s)
        # both replicas contribute an equal share of the merged window
        assert np.isclose((lat == 1.0).mean(), 0.5)
        assert float(np.percentile(lat * 1e3, 99)) > 500.0

    # queue depths get the same treatment (and stay ints)
    slow.queue_depths = [9] * cap
    fast.queue_depths = [1] * cap
    m = merge_stats([fast, slow])
    assert set(m.queue_depths) == {1, 9}
    assert all(isinstance(d, int) for d in m.queue_depths)


def test_replica_bounds_validated(weights):
    with pytest.raises(ValueError):
        FleetRouter(_factory(weights), replicas=5, max_replicas=2)
    with pytest.raises(ValueError):
        FleetRouter(_factory(weights), replicas=1, min_replicas=0)


# ---------------------------------------------------------------------------
# autoscaler control law (fake fleet + fake clock: fully deterministic)
# ---------------------------------------------------------------------------

class FakeFleet:
    def __init__(self, clock):
        self.clock = clock
        self.n = 1
        self.max = 4
        self.min = 1
        self.p99_ms = 0.0
        self.queue_depth = 0
        self.busy_s = 0.0
        self.shed = 0
        self.expired = 0

    def signals(self):
        return {
            "t": self.clock(), "n_replicas": self.n,
            "queue_depth": self.queue_depth, "p99_ms": self.p99_ms,
            "requests": 0, "busy_s": self.busy_s, "workers": self.n,
            "shed": self.shed, "expired": self.expired, "rejected": 0,
        }

    def scale_up(self):
        if self.n >= self.max:
            return None
        self.n += 1
        return f"replica-{self.n - 1}"

    def scale_down(self):
        if self.n <= self.min:
            return None
        self.n -= 1
        return f"replica-{self.n}"


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _scaler(fleet, clock, **kw):
    kw.setdefault("target_p99_ms", 100.0)
    kw.setdefault("up_patience", 1)
    kw.setdefault("down_patience", 2)
    kw.setdefault("cooldown_ticks", 1)
    return Autoscaler(fleet, clock=clock, **kw)


def test_autoscaler_scales_up_on_p99_breach():
    clock = FakeClock()
    fleet = FakeFleet(clock)
    scaler = _scaler(fleet, clock)
    fleet.p99_ms = 250.0
    clock.advance(0.5)
    tick = scaler.step()
    assert tick.action == "scale-up" and fleet.n == 2
    assert "p99" in tick.reason


def test_autoscaler_scales_up_on_shedding_even_with_low_p99():
    clock = FakeClock()
    fleet = FakeFleet(clock)
    scaler = _scaler(fleet, clock)
    scaler.step()                       # baseline tick (deltas need one)
    fleet.p99_ms = 10.0
    fleet.shed = 7
    clock.advance(0.5)
    tick = scaler.step()
    assert tick.action == "scale-up" and tick.shed_delta == 7
    assert "shed" in tick.reason


def test_autoscaler_cooldown_blocks_consecutive_actions():
    clock = FakeClock()
    fleet = FakeFleet(clock)
    scaler = _scaler(fleet, clock, cooldown_ticks=2)
    fleet.p99_ms = 500.0
    for _ in range(4):
        clock.advance(0.5)
        scaler.step()
    actions = [t.action for t in scaler.trace]
    # breach every tick, but cooldown spaces the scale-ups 2 ticks apart
    assert actions == ["scale-up", "hold", "hold", "scale-up"]
    assert fleet.n == 3


def test_autoscaler_scales_down_after_patience_and_clamps_at_min():
    clock = FakeClock()
    fleet = FakeFleet(clock)
    fleet.n = 3
    scaler = _scaler(fleet, clock, down_patience=2, cooldown_ticks=0)
    fleet.p99_ms = 1.0                  # well under down_ratio * target
    ticks = []
    for _ in range(8):
        clock.advance(0.5)
        ticks.append(scaler.step())
    assert fleet.n == 1                 # never below min_replicas
    downs = [t for t in ticks if t.action == "scale-down"]
    assert len(downs) == 2
    # patience: the very first idle tick must not have acted
    assert ticks[0].action == "hold"
    assert ticks[-1].reason == "idle (at min replicas)"


def test_autoscaler_utilization_is_windowed():
    clock = FakeClock()
    fleet = FakeFleet(clock)
    fleet.n = 2
    scaler = _scaler(fleet, clock, target_p99_ms=1e9,
                     high_utilization=0.8, down_patience=10**6)
    scaler.step()
    # 0.9s of busy work across 2 workers in a 0.5s window -> util 0.9
    fleet.busy_s += 0.9
    clock.advance(0.5)
    tick = scaler.step()
    assert tick.utilization == pytest.approx(0.9, abs=1e-6)
    assert tick.action == "scale-up" and "util" in tick.reason


def test_autoscaler_holds_at_max_replicas():
    clock = FakeClock()
    fleet = FakeFleet(clock)
    fleet.n = fleet.max
    scaler = _scaler(fleet, clock, cooldown_ticks=0)
    fleet.p99_ms = 500.0
    clock.advance(0.5)
    tick = scaler.step()
    assert tick.action == "hold" and "at max replicas" in tick.reason
    assert fleet.n == fleet.max


def test_autoscaler_live_scale_up_lowers_latency(weights):
    """End-to-end: a real paced fleet under backlog; one control tick
    adds a replica and the next backlog clears measurably faster."""
    fleet = FleetRouter(_factory(weights, pace_ms=30.0, max_delay_ms=2),
                        replicas=1, max_replicas=2)
    scaler = Autoscaler(fleet, target_p99_ms=50.0, up_patience=1,
                        cooldown_ticks=0)
    try:
        frames = _iq(32, seed=11)

        def drain_time(n):
            t0 = time.perf_counter()
            futures = [fleet.submit(frames[i]) for i in range(n)]
            for f in futures:
                f.result(timeout=60.0)
            return time.perf_counter() - t0

        t_one = drain_time(32)          # 8 paced batches on one replica
        tick = scaler.step()            # p99 breach observed -> scale up
        assert tick.action == "scale-up"
        assert fleet.n_replicas == 2
        t_two = drain_time(32)          # 4 paced batches per replica
        assert t_two < t_one * 0.8, (
            f"2 replicas not faster: {t_one:.3f}s -> {t_two:.3f}s")
    finally:
        fleet.close()


def test_autoscaler_scales_in_a_light_fleet_whose_workers_take_short_holds(
        weights):
    """A real two-replica fleet at light load: each worker's short hold
    adds steps and lifts its busy share past ``low_utilization``, but the
    held batches' busy seconds are not load, so the fleet still reads idle
    and scales in."""
    make = _factory(weights, max_delay_ms=200.0)

    def slowed(name):                   # a 30 ms step, measurable busy time
        engine = make(name)
        ver = engine.get_version(engine.active_version)
        step = ver.serve_step

        def timed_step(iq):
            time.sleep(0.03)
            return step(iq)

        ver.serve_step = timed_step
        return engine

    fleet = FleetRouter(slowed, replicas=2, max_replicas=2)
    scaler = Autoscaler(fleet, target_p99_ms=10_000.0, down_patience=3,
                        cooldown_ticks=0)
    raw = []                            # each tick's busy share, held in
    try:
        sig = fleet.signals()
        ticks = [scaler.step()]
        t_tick = time.perf_counter()
        futures = []
        while len(ticks) < 10:          # 20 requests a second
            futures.append(fleet.submit(_iq(1, seed=len(futures))[0]))
            time.sleep(0.05)
            if time.perf_counter() - t_tick >= 0.4:
                prev, sig = sig, fleet.signals()
                raw.append((sig["busy_s"] - prev["busy_s"])
                           / ((sig["t"] - prev["t"]) * prev["workers"]))
                ticks.append(scaler.step())
                t_tick = time.perf_counter()
        for f in futures:
            f.result(timeout=30.0)
        short_holds = fleet.stats.short_holds
        n_replicas = fleet.n_replicas
    finally:
        fleet.close()
    actions = [t.action for t in ticks]
    assert actions.count("scale-down") == 1 and n_replicas == 1
    down = actions.index("scale-down")
    assert short_holds > 0
    # the idle windows up to it (raw[i] ends at tick i + 1) held more
    # busy seconds than low_utilization; the autoscaler read them idle
    assert max(raw[:down]) > scaler.low_utilization
    assert all(t.utilization < scaler.low_utilization
               for t in ticks[1:down + 1])
