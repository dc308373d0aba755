"""Port serving tier: the batcher contracts of tests/test_serve.py, and the
engine's predictions against the reference engine's (CPU)."""
import collections
import concurrent.futures
import math
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import SMALL, SMALL_REF, setup, setup_bf16
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.serve import AMCServeEngine as RefSyncEngine
from repro.serve import AsyncAMCServeEngine as RefEngine
from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.serve import (
    AMCServeEngine,
    AsyncAMCServeEngine,
    DeadlineExceeded,
    EngineClosed,
    MicroBatcher,
)
from repro_torch.serve.batcher import bucket_for, make_buckets

FRAME_SHAPE = (2, SMALL.input_width)


@pytest.fixture(scope="module")
def weights():
    return setup(SMALL_REF, 0, 0.5)


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + FRAME_SHAPE).astype(np.float32)


def _engine(weights, **kw):
    _, _, tparams, tmasks = weights
    kw.setdefault("backend", "cuda_fused")
    return AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu", **kw)


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------

def test_bucket_ladder():
    assert make_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
    assert make_buckets(48, align=4) == (4, 8, 16, 32, 48)
    assert make_buckets(5, align=2) == (2, 4)
    assert make_buckets(1, align=2) == (2,)
    assert bucket_for(3, (1, 2, 4, 8)) == 4
    assert bucket_for(100, (1, 2, 4, 8)) == 8


def test_batcher_flushes_on_size():
    mb = MicroBatcher(FRAME_SHAPE, max_batch=4, max_delay_ms=60_000)
    for _ in range(4):
        mb.submit(_iq(1)[0])
    t0 = time.perf_counter()
    batch = mb.get_batch(timeout=1.0)
    assert time.perf_counter() - t0 < 5.0
    assert batch is not None and batch.n_real == 4 and batch.bucket == 4
    assert batch.n_padded == 0
    mb.close()


def test_batcher_flushes_on_timeout_and_pads_to_bucket():
    mb = MicroBatcher(FRAME_SHAPE, max_batch=64, max_delay_ms=50)
    frames = _iq(3)
    for i in range(3):
        mb.submit(frames[i])
    t0 = time.perf_counter()
    batch = mb.get_batch(timeout=1.0)
    assert batch is not None and batch.n_real == 3
    assert time.perf_counter() - t0 >= 0.04
    assert batch.bucket == 4 and batch.n_padded == 1
    np.testing.assert_array_equal(batch.frames[:3], frames)
    np.testing.assert_array_equal(batch.frames[3], np.zeros(FRAME_SHAPE))
    mb.close()


def test_batcher_rejects_bad_shapes_and_close_wakes_consumers():
    mb = MicroBatcher(FRAME_SHAPE, max_batch=4, max_delay_ms=10)
    with pytest.raises(ValueError, match="expected frame of shape"):
        mb.submit(np.zeros((3, 7), np.float32))
    mb.close()
    assert mb.get_batch(timeout=1.0) is None
    with pytest.raises(EngineClosed, match="closed"):
        mb.submit(np.zeros(FRAME_SHAPE, np.float32))


def test_drain_barrier_waits_for_priority_reordered_backlog():
    mb = MicroBatcher(FRAME_SHAPE, max_batch=1, max_delay_ms=1)
    frames = _iq(2)
    bulk = mb.submit(frames[0], priority="bulk")
    mb.submit(frames[1], priority="realtime")
    batch = mb.get_batch(timeout=1.0)
    assert [r.priority for r in batch.requests] == ["realtime"]
    assert not mb.drain_barrier(timeout=0.05)
    batch = mb.get_batch(timeout=1.0)
    assert [r.priority for r in batch.requests] == ["bulk"]
    assert mb.drain_barrier(timeout=1.0)
    bulk.cancel()
    mb.close()


def test_expired_requests_fail_even_while_consumer_keeps_blocking():
    mb = MicroBatcher(FRAME_SHAPE, max_batch=4, max_delay_ms=1)
    fut = mb.submit(_iq(1)[0], deadline=mb.now() - 1.0)
    consumer = threading.Thread(target=mb.get_batch, kwargs={"timeout": None},
                                daemon=True)
    consumer.start()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=5.0)
    assert consumer.is_alive()
    assert mb.n_expired == 1
    mb.close()
    consumer.join(timeout=5.0)
    assert not consumer.is_alive()


@pytest.fixture
def span_records(monkeypatch):
    """Request tracing on for the test (the previous tracer restored); the
    process's span log, which then records every batch."""
    from repro_torch.obs import trace

    monkeypatch.setattr(trace, "_tracer", None)
    trace.enable_tracing()
    return trace._the_log()


@pytest.mark.parametrize(
    "case,max_delay_ms,pace_ms,hold_s,n,kind,hold",
    [("no hold waits max_delay", 300.0, 0.0, None, 2, "timeout", 0.3),
     ("short hold", 2000.0, 0.0, 0.02, 2, "timeout", 0.02),
     ("hold capped by max_delay", 300.0, 0.0, 5.0, 2, "timeout", 0.3),
     ("full bucket at once", 2000.0, 0.0, 1.5, 4, "size", 1.5),
     ("pace gate holds", 2000.0, 300.0, 0.02, 1, "pace", 0.02)])
def test_batcher_holds_a_partial_batch_for_the_consumer_hold(
        span_records, case, max_delay_ms, pace_ms, hold_s, n, kind, hold):
    """A partial batch flushes at first pop + min(max_delay, hold_s), and
    at first pop + max_delay where the consumer passes no hold; a full
    bucket ships at once and a pace gate still holds to itself.  Real
    clock: each bound sits far from the time the other rule would give."""
    mb = MicroBatcher(FRAME_SHAPE, max_batch=4, max_delay_ms=max_delay_ms,
                      pace_ms=pace_ms)
    t_gate = time.perf_counter()
    if pace_ms:   # a first flush sets the gate pace_ms ahead
        for _ in range(4):
            mb.submit(_iq(1)[0])
        assert mb.get_batch(timeout=1.0).n_real == 4
    t0 = time.perf_counter()
    for x in _iq(n):
        mb.submit(x)
    batch = mb.get_batch(timeout=1.0, hold_s=hold_s)
    t1 = time.perf_counter()
    assert batch is not None and batch.n_real == n
    w = span_records.between(t0, math.inf)
    assert list(w.batches["kind"]) == [kind]
    assert list(w.batches["hold_s"]) == [hold]
    (late,) = w.batches["late_s"]
    short = kind == "timeout" and hold < max_delay_ms / 1e3
    assert batch.short_hold == short
    if kind == "timeout":
        # never past max_delay; late_s from the flush's own deadline
        assert hold <= t1 - t0 < hold + 1.0
        assert 0.0 <= late <= (t1 - t0) - hold
    else:
        assert math.isnan(late)
    if kind == "size":
        assert t1 - t0 < 1.0
    if kind == "pace":
        assert pace_ms / 1e3 <= t1 - t_gate < pace_ms / 1e3 + 1.0
    mb.close()


def test_batcher_rejects_conflicting_max_batch_and_buckets():
    with pytest.raises(ValueError, match="conflicts with explicit buckets"):
        MicroBatcher(FRAME_SHAPE, max_batch=64, buckets=(2, 4))
    mb = MicroBatcher(FRAME_SHAPE, buckets=(2, 4))
    assert mb.max_batch == 4
    mb.close()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_engine_predictions_equal_reference_engine(weights):
    params, masks, _, _ = weights
    iq = _iq(11, seed=5)
    with RefEngine(params, SMALL_REF, masks=masks, backend="pallas_fused",
                   max_batch=8, warmup=False, activity_gauges=False) as ref:
        want = ref.classify(iq)
    with _engine(weights, max_batch=8) as engine:
        got = engine.classify(iq)
        st = engine.stats
    np.testing.assert_array_equal(got, want)
    assert st.requests == 11 and len(st.latencies_s) == 11
    assert st.backend_batch_counts() == {"cuda_fused": st.batches}
    assert st.wall_s > 0 and st.throughput_fps() > 0


def test_engine_step_equals_plan_on_encoded_frames(weights):
    iq = _iq(4, seed=6)
    with _engine(weights, max_batch=4, warmup=False) as engine:
        got = engine.step(iq)
        frames = torch.from_numpy(sigma_delta_encode_np(iq, SMALL.timesteps))
        want = engine.plan.bound.batch(frames).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_submit_future_path_and_close_never_leaves_a_future_pending(weights):
    with _engine(weights, max_batch=4, warmup=False) as engine:
        preds = [f.result(timeout=30.0)
                 for f in [engine.submit(x) for x in _iq(9, seed=11)]]
    assert len(preds) == 9 and all(isinstance(p, int) for p in preds)
    engine = _engine(weights, max_batch=2, max_delay_ms=1.0, warmup=False)
    futures = [engine.submit(f) for f in _iq(16, seed=9)]
    engine.close()
    served = drained = 0
    for fut in futures:
        try:
            assert isinstance(fut.result(timeout=10.0), int)
            served += 1
        except RuntimeError as e:
            assert "closed" in str(e)
            drained += 1
    assert served + drained == 16
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(_iq(1)[0])


def _slowed(ver, step_s):
    """Make ``ver``'s served step sleep ``step_s(thread name)`` first."""
    step = ver.serve_step

    def timed_step(iq):
        time.sleep(step_s(threading.current_thread().name))
        return step(iq)

    ver.serve_step = timed_step


@pytest.mark.parametrize("workers", [1, 2])
def test_engine_worker_holds_for_its_own_service_time(weights, span_records,
                                                      workers):
    """After its first batch each worker passes the median of its own busy
    times as the hold: a later one-request batch flushes near that, not at
    max_delay, and counts as a short hold.  Worker 1's steps take 0.2 s,
    worker 0's 0.03 s, so their holds cannot mix; a pause between requests
    keeps each worker busy less than HOLD_BUSY_MAX of its time."""
    from repro_torch.obs.metrics import default_registry

    step_s = {"amc-serve-worker-0": 0.03, "amc-serve-worker-1": 0.2}
    hold_range = {"amc-serve-worker-0": (0.03, 0.2),
                  "amc-serve-worker-1": (0.2, 0.6)}
    name = f"hold-test-{workers}"
    before = default_registry().value("repro_serve_short_holds_total",
                                      engine=name)
    t0 = time.perf_counter()
    with _engine(weights, max_batch=4, max_delay_ms=1000.0, warmup=False,
                 workers=workers, name=name) as engine:
        _slowed(engine.get_version(engine.active_version), step_s.get)
        names = {t.native_id: t.name for t in engine._threads}
        per_thread = collections.Counter()
        for i in range(60):   # one request at a time: every batch partial
            engine.classify(_iq(1, seed=i))
            sp = span_records.between(t0, math.inf).spans
            per_thread = collections.Counter(
                names[th] for th in sp["thread"][sp["name"] == "engine.step"])
            if len(per_thread) == workers and min(per_thread.values()) >= 3:
                break
            time.sleep(0.25)
        stats = engine.stats.summary()
    w = span_records.between(t0, math.inf)
    assert len(per_thread) == workers and min(per_thread.values()) >= 3
    gathers = w.spans["name"] == "batcher.gather"
    thread_of = dict(zip(w.spans["batch"][gathers], w.spans["thread"][gathers]))
    gather_s = dict(zip(w.spans["batch"][gathers],
                        w.spans["t1"][gathers] - w.spans["t0"][gathers]))
    seen = set()
    for b, kind, hold in zip(w.batches["batch"], w.batches["kind"],
                             w.batches["hold_s"]):
        assert kind == "timeout"
        thread = names[thread_of[b]]
        if thread not in seen:          # no batch served yet: max_delay
            seen.add(thread)
            assert hold == 1.0 and gather_s[b] >= 1.0
            continue
        lo, hi = hold_range[thread]
        assert lo <= hold < hi
        assert gather_s[b] < 1.0        # near the hold, not at max_delay
    n_short = len(w.batches["batch"]) - workers
    assert stats["short_holds"] == engine.stats.short_holds == n_short
    assert default_registry().value("repro_serve_short_holds_total",
                                    engine=name) - before == n_short


@pytest.mark.parametrize("case,busy,cycle,hold", [
    ("before its first batch", [], [], None),
    ("idle worker", [0.01] * 8, [0.1] * 8, 0.01),
    ("one slow step does not set it", [0.01] * 7 + [0.5], [0.1] * 7 + [1.0],
     0.01),
    ("busy just under the share", [0.035] * 8, [0.1] * 8, 0.035),
    ("busy half its time", [0.05] * 8, [0.1] * 8, None),
    ("busy all its time", [0.02] * 8, [0.02] * 8, None)])
def test_worker_hold_is_the_median_service_time_under_the_busy_share(
        case, busy, cycle, hold):
    """The worker's hold: the median of its recent busy intervals while
    they fill less than HOLD_BUSY_MAX of their wall time, else (and before
    any batch) None, which the batcher reads as max_delay."""
    from repro_torch.serve.engine import HOLD_BUSY_MAX, worker_hold

    assert 0.35 < HOLD_BUSY_MAX <= 0.5
    assert worker_hold(busy, cycle) == hold


def test_engine_worker_holds_max_delay_while_busy_past_the_share(
        weights, span_records, monkeypatch):
    """A load that keeps the worker busy past HOLD_BUSY_MAX at its short
    hold: the worker passes worker_hold of its own busy and cycle intervals,
    so it meets both sides of the line; a batch given None waits max_delay
    and counts as no short hold, the others flush at the short hold."""
    from repro_torch.serve import engine as engine_mod

    rule = engine_mod.worker_hold
    calls = []

    def spy(busy_s, cycle_s):
        out = rule(busy_s, cycle_s)
        calls.append((list(busy_s), list(cycle_s), out))
        return out

    monkeypatch.setattr(engine_mod, "worker_hold", spy)
    t0 = time.perf_counter()
    with _engine(weights, max_batch=32, max_delay_ms=300.0,
                 warmup=False) as engine:
        _slowed(engine.get_version(engine.active_version), lambda _: 0.05)
        passed = []
        get_batch = engine.batcher.get_batch

        def spied_get_batch(timeout=None, hold_s=None):
            batch = get_batch(timeout=timeout, hold_s=hold_s)
            if batch is not None:
                passed.append(hold_s)
            return batch

        engine.batcher.get_batch = spied_get_batch
        time.sleep(0.15)            # the worker's call in flight returns
        t0 = time.perf_counter()
        futures = []
        while time.perf_counter() - t0 < 2.5:   # 50 requests a second
            futures.append(engine.submit(_iq(1, seed=len(futures))[0]))
            time.sleep(0.02)
        for f in futures:
            f.result(timeout=10.0)
        stats = engine.stats.summary()
    w = span_records.between(t0, math.inf)
    for busy, cycle, out in calls:
        assert all(b >= 0.05 for b in busy)       # its own steps' intervals
        assert all(c >= b for b, c in zip(busy, cycle))
    holds = [0.3 if h is None else min(0.3, h) for h in passed]
    assert list(w.batches["hold_s"]) == pytest.approx(holds)
    assert None in passed[1:] and any(h is not None for h in passed)
    gathers = w.spans["name"] == "batcher.gather"
    gather_s = dict(zip(w.spans["batch"][gathers],
                        w.spans["t1"][gathers] - w.spans["t0"][gathers]))
    for b, kind, hold in zip(w.batches["batch"], w.batches["kind"],
                             w.batches["hold_s"]):
        if kind == "timeout":
            assert gather_s[b] >= hold
    short = (w.batches["kind"] == "timeout") & (w.batches["hold_s"] < 0.3)
    assert 0 < short.sum() == stats["short_holds"]


def test_classify_timeout_cancels_queued_futures(weights):
    eng = _engine(weights, max_delay_ms=60_000.0, warmup=False)
    captured = []
    orig_submit = eng.submit

    def recording_submit(iq, **kw):
        fut = orig_submit(iq, **kw)
        captured.append(fut)
        return fut

    eng.submit = recording_submit
    try:
        with pytest.raises((TimeoutError, concurrent.futures.TimeoutError)):
            eng.classify(_iq(4), timeout=0.2)
        assert len(captured) == 4 and all(f.cancelled() for f in captured)
    finally:
        eng.close()
    assert eng.stats.requests == 0


def test_engine_needs_cuda_or_an_explicit_cpu(weights):
    _, _, tparams, tmasks = weights
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncAMCServeEngine(tparams, SMALL, tmasks, warmup=False)
    # mesh serving is ported: a serving mesh constructs, anything else is
    # refused
    from repro_torch.distributed.sharding import serve_mesh

    with pytest.raises(TypeError, match="ServeMesh"):
        AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu",
                            warmup=False, mesh=object())
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu",
                             warmup=False, backend="goap",
                             mesh=serve_mesh(1, device_type="cpu")) as engine:
        assert engine.mesh.size == 1
    # activity counting and quantized serving are ported: they construct
    from repro_torch.train.lsq import init_lsq_scales

    for kw in ({"count_activity": True},
               {"lsq_scales": init_lsq_scales(tparams)}):
        with AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu",
                                 warmup=False, **kw) as engine:
            assert engine.plan is not None
    # model versions are ported: a bound version takes over on swap_to
    with _engine(weights, warmup=False, version_label="v1") as engine:
        with pytest.raises(KeyError):
            engine.swap_to("v2")
        engine.bind_version("v2", tparams, tmasks, backend="goap",
                            warmup=False)
        assert engine.swap_to("v2") == "v1" and engine.active_version == "v2"
        assert engine.backend == "goap" and set(engine.versions()) == {"v1",
                                                                       "v2"}


# ---------------------------------------------------------------------------
# the sync engine and the engine's fleet-facing accessors
# ---------------------------------------------------------------------------

def test_sync_engine_tail_padding(weights):
    params, masks, tparams, tmasks = weights
    iq = _iq(11)
    engine = AMCServeEngine(tparams, SMALL, tmasks, batch_size=4,
                            backend="dense", device="cpu")
    preds = engine.classify(iq)
    st = engine.stats
    assert preds.shape == (11,)
    assert st.requests == 11 and st.batches == 3
    assert st.padded_frames == 1
    assert len(st.latencies_s) == 11  # one latency per real request only
    assert st.backend_batch_counts() == {"dense": 3}
    ref = RefSyncEngine(params, SMALL_REF, masks=masks, batch_size=4,
                        backend="dense")
    np.testing.assert_array_equal(preds, ref.classify(iq))


def test_async_engine_counts_activity_like_sync(weights):
    params, masks, tparams, tmasks = weights
    iq = _iq(6, seed=3)
    sync = AMCServeEngine(tparams, SMALL, tmasks, batch_size=8,
                          count_activity=True, backend="dense", device="cpu")
    sync.classify(iq)
    with _engine(weights, backend="dense", max_batch=8, warmup=False,
                 count_activity=True) as engine:
        engine.classify(iq)
        st = engine.stats
    # identical activity despite different batching and padding
    assert st.accumulations == sync.stats.accumulations
    assert st.fetched_bits == sync.stats.fetched_bits
    assert st.accumulations > 0 and st.fetched_bits > 0
    ref = RefSyncEngine(params, SMALL_REF, masks=masks, batch_size=8,
                        count_activity=True, backend="dense")
    ref.classify(iq)
    assert sync.stats.accumulations == ref.stats.accumulations
    assert sync.stats.fetched_bits == ref.stats.fetched_bits


def test_sync_engine_count_path_unit(weights):
    _, _, tparams, tmasks = weights
    engine = AMCServeEngine(tparams, SMALL, tmasks, batch_size=2,
                            count_activity=True, backend="goap", device="cpu")
    engine.classify(_iq(1, seed=7))
    st = engine.stats
    assert st.requests == 1 and st.batches == 1
    assert st.accumulations > 0
    assert st.fetched_bits > st.accumulations  # >= 1 bit fetched per accum


@pytest.mark.parametrize("backend", ["cuda_fused", "fixed"])
def test_sync_engine_equals_async_engine(weights, backend):
    _, _, tparams, tmasks = weights
    iq = _iq(10, seed=12)
    sync = AMCServeEngine(tparams, SMALL, tmasks, batch_size=4,
                          backend=backend, device="cpu")
    with _engine(weights, backend=backend, max_batch=4,
                 warmup=False) as engine:
        np.testing.assert_array_equal(sync.classify(iq), engine.classify(iq))


def test_engine_fleet_accessors(weights):
    with _engine(weights, max_batch=4, warmup=False,
                 version_label="v1") as engine:
        assert engine.n_workers == 1 and engine.active_version == "v1"
        engine.classify(_iq(6, seed=4))
        lat = engine.recent_latencies()
        assert len(lat) == 6 and all(x > 0 for x in lat)
        assert engine.recent_latencies(k=2) == lat[-2:]
        assert engine.busy_s > 0 and 0.0 < engine.utilization() <= 1.0
        s = engine.export_stats()
    assert s["requests"] == 6 and s["workers"] == 1
    assert s["active_version"] == "v1" and s["queue_depth"] == 0
    assert s["queue_depths_by_priority"] == {"realtime": 0, "bulk": 0}
    assert s["n_expired"] == s["n_rejected"] == s["n_cancelled"] == 0
    assert s["busy_s"] > 0 and 0.0 < s["utilization"] <= 1.0


@pytest.mark.parametrize("port,ref", [("dense", "dense"), ("stream", "stream"),
                                      ("cuda_fused", "pallas_fused")])
def test_bf16_model_serves_like_the_reference_sync_engine(port, ref):
    """A bf16 model on the backends ``tests/test_torch_bf16.py`` does not
    serve (it serves ``goap`` and ``cuda``): the port's sync and async
    engines give the reference sync engine's predictions; ``cuda_fused``
    serves through the f32 whole-network kernel on the cast operands, as
    the reference's ``pallas_fused`` does."""
    import jax.numpy as jnp

    params, masks, tparams, tmasks = setup_bf16(SMALL_REF, 7, jnp.bfloat16, True)
    iq = np.random.default_rng(7).normal(size=(16,) + FRAME_SHAPE).astype(np.float32)
    want = RefSyncEngine(params, SMALL_REF, masks, batch_size=8,
                         backend=ref).classify(iq)
    sync = AMCServeEngine(tparams, SMALL, tmasks, batch_size=8, backend=port,
                          device="cpu")
    np.testing.assert_array_equal(sync.classify(iq), want)
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, backend=port, max_batch=8,
                             device="cpu") as engine:
        got = [f.result(timeout=60) for f in [engine.submit(x) for x in iq]]
    np.testing.assert_array_equal(np.array(got), want)
