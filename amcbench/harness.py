"""One run of one cell: set-up, the measured window, the check.

Set-up makes the frame pool (frames of the configuration's
``input_width``, of the mix's ``frames`` set) and the model from the seed,
builds the configuration's engine (its backend pinned: no race) with every
bucket captured, and starts the load, which runs ``warm_s`` before the
window.
The window lasts ``seconds``; after it the load drains (a minute at most).
With ``trace`` the same traffic then runs once more under
``torch.profiler`` for the traced window (``trace.py``).  Then the peak
device memory is read, the engine is closed and freed, and the reference
runs over the pool in blocks; the metrics and the check read what the
window left.  ``override(served_step, model, device)`` (for
the control and the fault tests, never in a benchmark run) gives the step
that serves in the served step's place.
"""
from __future__ import annotations

import gc
import math
import pathlib
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from amcbench import check, spec
from amcbench.frames import DEFAULT_SET, make_pool
from amcbench.load import OK, Load
from amcbench.model import make_model, program_params, snn_config
from amcbench.probe import StepProbe
from amcbench.reference.snn import forward_blocks
from amcbench.trace import TRACE_LEAD_S, TRACE_S, DeviceTrace, top

REF_BLOCK = 2048
DRAIN_S = 60.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


class GcPauses:
    """The collector's passes while armed: count, longest and total pause
    a generation (a pass holds the interpreter lock), and when each pass
    of over a millisecond ran."""

    LONG_MS = 1.0

    def __init__(self):
        self.armed = False
        self._t = 0.0
        self.passes: Dict[int, list] = {}
        self.long: list = []

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self.armed:
            t = time.perf_counter()
            ms = (t - self._t) * 1e3
            n, worst, total = self.passes.get(info["generation"], (0, 0.0, 0.0))
            self.passes[info["generation"]] = [n + 1, max(worst, ms), total + ms]
            if ms > self.LONG_MS:
                self.long.append((self._t, t))

    def overlap_ms(self, a: float, b: float) -> float:
        """Milliseconds of the long passes that fell inside [a, b]."""
        return sum(max(0.0, min(b, e) - max(a, s)) for s, e in self.long) * 1e3


def snapshot(engine) -> Dict[str, float]:
    st = engine.stats
    return {"t": time.perf_counter(), "requests": st.requests,
            "batches": st.batches, "padded": st.padded_frames,
            "busy_s": engine.busy_s}


class Run:
    """What one run's window left, for the metric readers and the check."""

    def __init__(self, cell: spec.Cell, pool: np.ndarray, model, load: Load,
                 probe: StepProbe, max_batch: int):
        self.cell = cell
        self.config = cell.config
        self.pool = pool
        self.model = model
        self.load = load
        self.probe = probe
        self.max_batch = max_batch
        self.snap0 = self.snap1 = self.sub0 = self.sub1 = None
        self.trace_load: Optional[Load] = None
        self.trace: Optional[Dict[str, Any]] = None
        self.frame_counts: Dict[str, np.ndarray] = {}

    @property
    def t0(self) -> float:
        return self.snap0["t"]

    @property
    def t1(self) -> float:
        return self.snap1["t"]

    def traced_frames(self) -> np.ndarray:
        """Pool indices of the frames served in the traced window: the
        requests of the traced load completed in it, and the padded rows
        as the zero frame (index ``len(pool)``)."""
        a, b, load = self.sub0, self.sub1, self.trace_load
        real = load.idx[load.completed_between(a["t"], b["t"])]
        padded = np.full(int(b["padded"] - a["padded"]), len(self.pool))
        return np.concatenate([real, padded]).astype(np.int64)


def traced_window(run: Run, engine, tracer: DeviceTrace, traffic, seed: int,
                  rate_fps: Optional[float]) -> bool:
    """The traced window: the profiler started with the card idle, the
    cell's traffic for ``TRACE_LEAD_S`` and then the marked ``TRACE_S``
    seconds, the load drained, the profiler stopped.  False if the load
    did not drain."""
    load = Load(engine.submit, run.pool, {**traffic, "warm_s": TRACE_LEAD_S},
                seed, TRACE_S, rate_fps=rate_fps)
    run.trace_load = load
    tracer.start()
    load.start()
    sleep_until(load.t0)
    tracer.mark_start()
    run.sub0 = snapshot(engine)
    sleep_until(load.t1)
    run.sub1 = snapshot(engine)
    tracer.mark_end()
    load.join()
    drained = load.wait_done(DRAIN_S)
    tracer.stop()
    return drained


def wake_late_ms(n: int = 400, nap_s: float = 0.0005) -> Dict[str, float]:
    """How late ``n`` sleeps of ``nap_s`` wake, in ms, with the engine
    closed: the delay a sleeping thread (the client before each request,
    the batcher's worker at its timeout) pays on this machine."""
    late = np.empty(n)
    for i in range(n):
        t = time.perf_counter()
        time.sleep(nap_s)
        late[i] = (time.perf_counter() - t - nap_s) * 1e3
    return {"median": float(np.median(late)),
            "p90": float(np.percentile(late, 90)), "max": float(late.max())}


def _q(x: np.ndarray) -> Dict[str, float]:
    return {"p50": float(np.median(x)), "p99": float(np.percentile(x, 99))}


def window_detail(run: Run, pauses: GcPauses) -> Dict[str, Any]:
    """From the window's own records, for the run's earlier lines: the
    longest steps and gaps between steps, with the collector's long passes
    inside each; and each request's
    latency split into the client's lateness (due to sent), the wait for
    its step (sent to the step's start: the batch forming and the queue),
    the step, and its future's resolution after the step.  A request's
    step is the last that returned before it resolved (one worker resolves
    a batch's futures before its next step)."""
    load, probe, t0, t1 = run.load, run.probe, run.t0, run.t1
    out: Dict[str, Any] = {}
    n = min(probe.n, len(probe.t_call))
    calls, backs = probe.t_call[:n], probe.t_back[:n]
    inside = np.nonzero((calls >= t0) & (calls < t1) & np.isfinite(backs))[0]
    if len(inside) > 1:
        ms = (backs[inside] - calls[inside]) * 1e3
        gaps = np.diff(calls[inside]) * 1e3
        out["longest_steps"] = [
            [round(float(calls[i] - t0), 3), float(ms[j]),
             pauses.overlap_ms(calls[i], backs[i])]
            for j, i in ((j, inside[j]) for j in np.argsort(ms)[::-1][:5])]
        out["longest_step_gaps"] = [
            [round(float(calls[inside[j]] - t0), 3), float(gaps[j]),
             pauses.overlap_ms(calls[inside[j]], calls[inside[j + 1]])]
            for j in np.argsort(gaps)[::-1][:5]]
    w = load.window_requests()
    w = w[load.status[w] == OK]
    done = load.done[w]
    k = np.searchsorted(backs, done, side="right") - 1
    w, done, k = w[k >= 0], done[k >= 0], k[k >= 0]
    if len(w):
        sent = load.sent[w]
        due = load.t_start + load.due[w]
        out["latency_split_ms"] = {
            "late": _q((sent - due) * 1e3), "wait": _q((calls[k] - sent) * 1e3),
            "step": _q((backs[k] - calls[k]) * 1e3),
            "resolve": _q((done - backs[k]) * 1e3)}
    late = flush_lateness(run)
    if late is not None:
        out["flush_late_ms"] = late
    return out


def flush_lateness(run: Run) -> Optional[Dict[str, Any]]:
    """How late the traced window's timeout flushes came past their own
    hold (first pop + ``hold_s``), in ms, with the median hold, from the
    program's span log's batch records (their ``late_s``, on the batcher's
    clock).  None where the run has no such records: no traced window, a
    program without the span log, lost records, or no timeout flush."""
    if run.sub0 is None:
        return None
    try:
        from repro_torch.obs.trace import span_window
    except ImportError:   # a program without the span log
        return None
    w = span_window(run.sub0["t"], run.sub1["t"])
    if w is None:
        return None
    timeout = w.batches["kind"] == "timeout"
    if not timeout.any():
        return None
    return {**_q(w.batches["late_s"][timeout] * 1e3),
            "hold_p50": float(np.median(w.batches["hold_s"][timeout])) * 1e3,
            "batches": int(timeout.sum())}


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float,
             trace: bool, t_proc: float, device: str = "cuda", *,
             override: Optional[Callable] = None,
             pool_frames: Optional[int] = None,
             rate_fps: Optional[float] = None) -> Dict[str, Any]:
    """The result of one run: ``{"line": the result's JSON object,
    "checks": [(name, value, limit)], "info": {...}, "run": Run}``."""
    from repro_torch.launch.serve import serving_heap
    from repro_torch.serve.engine import AsyncAMCServeEngine

    cell = spec.resolve(root, workload)
    cfg, traffic = cell.config, cell.traffic
    info: Dict[str, Any] = {"cell": workload, "seed": seed,
                            "start_s": time.perf_counter() - t_proc}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    pool, _, _ = make_pool(seed, pool_frames or int(traffic["pool_frames"]),
                           range(*traffic["snr_db"]),
                           length=int(cfg["model"]["input_width"]),
                           frames=traffic.get("frames", DEFAULT_SET))
    info["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = make_model(cfg, seed, dev)
    params, masks = program_params(model)
    info["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = AsyncAMCServeEngine(
        params, snn_config(cfg["model"]), masks, backend=cfg["backend"],
        max_batch=int(cfg["max_batch"]), max_delay_ms=float(cfg["max_delay_ms"]),
        device=device)
    info["engine_s"] = time.perf_counter() - t
    max_batch = engine.batcher.max_batch
    probe = StepProbe(engine, seed, None if override is None else
                      (lambda served: override(served, model, dev)))
    load = Load(engine.submit, pool, traffic, seed, seconds, rate_fps=rate_fps)
    run = Run(cell, pool, model, load, probe, max_batch)
    tracer = DeviceTrace(dev) if trace else None

    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        with serving_heap():
            load.start()
            sleep_until(load.t0)
            run.snap0 = snapshot(engine)
            probe.armed = pauses.armed = True
            sleep_until(load.t1)
            run.snap1 = snapshot(engine)
            probe.armed = pauses.armed = False
            load.join()
            drained = load.wait_done(DRAIN_S)
            if tracer is not None and drained:
                drained = traced_window(run, engine, tracer, traffic, seed,
                                        rate_fps)
        setup_s = run.t0 - t_proc
        info["drained"] = drained
        mem_peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
    finally:
        gc.callbacks.remove(pauses)
        engine.close()
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    info["wake_late_ms"] = wake_late_ms()
    info["gc_passes"] = {str(g): v for g, v in sorted(pauses.passes.items())}
    info.update(window_detail(run, pauses))
    lat = load.latencies_ms()
    if len(lat):
        info["latency_ms"] = dict(zip(("p50", "p90", "p99", "p999", "max"),
                                      np.percentile(lat, [50, 90, 99, 99.9, 100]).tolist()))
    late = load.lateness_ms()
    if len(late):
        info["generator_late_ms"] = {"median": float(np.median(late)),
                                     "worst": float(late.max()),
                                     "over_1ms": float((late > 1.0).mean())}
    if tracer is not None:
        t = time.perf_counter()
        run.trace = tracer.reduce()
        info["trace_reduce_s"] = time.perf_counter() - t
        info["device_events"] = run.trace["device_events"]

    t = time.perf_counter()
    frames = torch.from_numpy(np.concatenate([pool, np.zeros((1,) + pool.shape[1:],
                                                             pool.dtype)]))
    ref, counts = forward_blocks(model, frames.to(dev), REF_BLOCK, work=trace)
    run.frame_counts = {k: v.numpy() for k, v in counts.items()}
    info["reference_s"] = time.perf_counter() - t

    nums = check.numbers(run, ref.numpy())
    correct, compared = check.verdict(nums, cfg["limits"])
    correct = correct and drained
    info.update({k: nums[k] for k in ("rows", "answers", "attempted", "failed")})
    info["numbers"] = {k: nums[k] for k in ("rows_off", "answers_off", "row_err_max")}
    info["window"] = {"requests": run.snap1["requests"] - run.snap0["requests"],
                      "batches": run.snap1["batches"] - run.snap0["batches"],
                      "padded": run.snap1["padded"] - run.snap0["padded"]}

    metrics: Dict[str, Dict[str, Any]] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = setup_s if m.name == "setup_s" else spec.reader(m).read(run, m.name)
        if value is not None and math.isfinite(value):
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": nums["attempted"],
                            "failed": nums["failed"], "metrics": metrics,
                            "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": top(run.trace["ops"]),
                             "idle_gaps": top(run.trace["gaps"])}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in compared}
    if dev.type == "cuda":
        info["card"] = card()
    return {"line": line, "checks": compared, "info": info, "run": run}
