"""The five readers of the program's span log (``queue_wait_ms``,
``flush_late_ms``, ``step_sync_ms``, ``step_host_ms``, ``resolve_ms``) on
hand-made windows, and nothing where the window is empty, lost records to
the ring, or the run had no device trace."""
import math
import types

import numpy as np
import pytest

from amcbench.metrics import (flush_late_ms, queue_wait_ms, resolve_ms,
                              step_host_ms, step_sync_ms)
from repro_torch.obs import trace
from repro_torch.obs.trace import FLUSH_KINDS, SPAN_NAMES, SpanLog

READERS = [queue_wait_ms, flush_late_ms, step_sync_ms, step_host_ms,
           resolve_ms]


def _span(log, name, sid, parent, t0, t1):
    c = log.spans.cols
    i = log.spans.reserve()
    c["name"][i], c["id"][i], c["parent"][i] = SPAN_NAMES.index(name), sid, parent
    c["batch"][i], c["thread"][i] = sid // 100, 1
    c["t0"][i], c["t1"][i] = t0, t1


def _batch(log, batch, kind, late_s, t0, waits):
    c = log.batches.cols
    i = log.batches.reserve()
    c["batch"][i], c["n_real"][i], c["bucket"][i] = batch, len(waits), 16
    c["kind"][i], c["late_s"][i], c["t0"][i] = FLUSH_KINDS.index(kind), late_s, t0
    idx = log.waits.reserve_many(len(waits))
    log.waits.cols["batch"][idx] = batch
    log.waits.cols["wait_s"][idx] = waits
    log.waits.cols["t0"][idx] = t0


def _step(log, k, t, sync_s):
    """Batch ``k`` at ``t``: form 0.1 ms, a 1 ms step holding copies, a
    replay and the sync, then a resolve of 0.2 ms."""
    b = 100 * k
    _span(log, "batcher.form", b + 1, -1, t, t + 1e-4)
    _span(log, "engine.step", b + 2, -1, t + 1e-4, t + 1.1e-3)
    _span(log, "step.copy_in", b + 3, b + 2, t + 1e-4, t + 2e-4)
    _span(log, "step.replay", b + 4, b + 2, t + 2e-4, t + 3e-4)
    _span(log, "step.sync", b + 5, b + 2, t + 3e-4, t + 3e-4 + sync_s)
    _span(log, "engine.resolve", b + 6, -1, t + 1.1e-3, t + 1.3e-3)


@pytest.fixture
def log(monkeypatch):
    fresh = SpanLog(capacity=64)
    monkeypatch.setattr(trace, "_SPANS", fresh)
    return fresh


def _run(t0=100.0, t1=101.0, device_events=5):
    return types.SimpleNamespace(sub0={"t": t0}, sub1={"t": t1},
                                 trace={"device_events": device_events})


def test_each_reader_on_a_hand_made_window(log):
    _step(log, 0, 99.5, 5e-4)        # before the window: never read
    _batch(log, 0, "timeout", 9.0, 99.5, [9.0])
    for k, sync_s in enumerate([3e-4, 5e-4, 7e-4], 1):
        _step(log, k, 100.0 + 0.1 * k, sync_s)
    _batch(log, 1, "timeout", 1e-3, 100.1, [6e-3, 5e-3])
    _batch(log, 2, "size", math.nan, 100.2, [4e-3, 3e-3])
    _batch(log, 3, "timeout", 3e-3, 100.3, [2e-3])
    _step(log, 9, 101.0, 5e-4)       # at the window's end: never read
    run = _run()
    assert queue_wait_ms.read(run, "queue_wait_ms.latency") == pytest.approx(4.0)
    assert flush_late_ms.read(run, "flush_late_ms.latency") == pytest.approx(2.0)
    assert step_sync_ms.read(run, "step_sync_ms.latency") == pytest.approx(0.5)
    # each 1 ms step less its sync
    assert step_host_ms.read(run, "step_host_ms.latency") == pytest.approx(0.5)
    assert resolve_ms.read(run, "resolve_ms.latency") == pytest.approx(0.2)


def test_a_step_without_its_sync_counts_whole(log):
    _span(log, "engine.step", 1, -1, 100.0, 100.002)
    _step(log, 1, 100.1, 5e-4)
    _step(log, 2, 100.2, 5e-4)
    assert step_host_ms.read(_run(), "step_host_ms.latency") == pytest.approx(0.5)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_nothing_from_an_empty_window(log, reader):
    _step(log, 1, 100.5, 5e-4)
    _batch(log, 1, "timeout", 1e-3, 100.5, [1e-3])
    assert reader.read(_run(102.0, 103.0), "x.latency") is None
    assert reader.read(_run(device_events=0), "x.latency") is None


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_nothing_from_a_window_the_ring_dropped(log, reader):
    for k in range(12):              # 72 spans into a ring of 64
        _step(log, k, 100.0 + 0.05 * k, 5e-4)
        _batch(log, k, "timeout", 1e-3, 100.0 + 0.05 * k, [1e-3])
    assert log.spans.dropped > 0
    assert reader.read(_run(), "x.latency") is None


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_nothing_without_a_span_log(monkeypatch, reader):
    monkeypatch.setattr(trace, "_SPANS", None)
    assert reader.read(_run(), "x.latency") is None
