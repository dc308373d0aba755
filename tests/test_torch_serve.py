"""Port serving tier: the batcher contracts of tests/test_serve.py, and the
engine's predictions against the reference engine's (CPU)."""
import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import SMALL, SMALL_REF, setup
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
    with pytest.raises(NotImplementedError):
        AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu",
                            warmup=False, mesh=object())
    # activity counting and quantized serving are ported: they construct
    from repro_torch.train.lsq import init_lsq_scales

    for kw in ({"count_activity": True},
               {"lsq_scales": init_lsq_scales(tparams)}):
        with AsyncAMCServeEngine(tparams, SMALL, tmasks, device="cpu",
                                 warmup=False, **kw) as engine:
            assert engine.plan is not None
    with _engine(weights, warmup=False) as engine:
        with pytest.raises(NotImplementedError):
            engine.swap_to("v2")


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
