"""Chrome-trace / Perfetto JSON export for request traces.

A copy of the reference's ``repro/obs/export.py`` (stdlib only): the
port's traces use the reference's event names, so both export alike.

Turns a :class:`~repro_torch.obs.trace.TraceLog` dump into a Chrome
trace-event file loadable in ``ui.perfetto.dev`` (or
``chrome://tracing``): open the dumped JSON and every request becomes a
nested span stack — the outer ``request`` span wraps one child span per
phase gap (``submit→admit``, ``enqueue→dequeue``, ``jit-step``, ...), so
queueing vs batching vs served-step time is visible per request, and
batch formation shows up as the same ``jit-step`` span lighting up
across riders simultaneously.

Layout:

* one Perfetto *process* (``pid``) per replica/engine — the ``replica``
  attr stamped at fleet ``admit`` wins, else the ``engine`` attr from
  ``submit``, else a single ``serve`` track;
* one *thread* (``tid``) per concurrency lane inside that process.
  Chrome trace ``B``/``E`` events form a stack per (pid, tid), so two
  overlapping requests must not share a tid — a greedy lane allocator
  reuses the lowest lane whose previous request already ended;
* ``ts`` is microseconds on a common axis (the dump's ``t0`` anchors,
  normalized to the earliest event so Perfetto opens at t=0);
* ``M``etadata events name the tracks;
* per-layer timings from
  :func:`~repro_torch.plan.streaming.profile_layer_steps` land as ``X``
  (complete) events on a dedicated ``layers`` process so kernel-level
  cost sits beside request-level latency;
* the serving worker's spans (the dump's ``spans``, the port's addition
  to the reference's layout) land as nested ``X`` events on a ``worker``
  process, one track per thread, after everything else; a span that
  began before the first request event is clipped to it, and each
  ``batcher.gather`` span carries its batch's size, bucket and flush.

:func:`validate_perfetto` is the schema gate shared by the tests, the
bench, and the obs-smoke CI job: required keys, monotonic ``ts`` per
track, and strictly matching ``B``/``E`` pairs.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["to_perfetto", "write_perfetto", "validate_perfetto"]

_US = 1e6


def _trace_pid(trace: Dict[str, Any]) -> str:
    """Replica (fleet admit) > engine (submit) > 'serve'.

    Only the ``admit`` event's replica counts — ``replica-full`` also
    carries a ``replica`` attr, but that names the replica that refused.
    """
    for ev in trace.get("events", ()):
        if ev.get("name") == "admit" and ev.get("replica"):
            return str(ev["replica"])
    for ev in trace.get("events", ()):
        if ev.get("engine"):
            return str(ev["engine"])
    return "serve"


class _LaneAllocator:
    """Greedy per-pid lane (tid) assignment for non-overlapping stacking."""

    def __init__(self):
        self._lanes: List[float] = []   # lane -> end time of last span

    def take(self, t_start: float, t_end: float) -> int:
        for i, busy_until in enumerate(self._lanes):
            if t_start >= busy_until:
                self._lanes[i] = t_end
                return i
        self._lanes.append(t_end)
        return len(self._lanes) - 1


def to_perfetto(dump: Dict[str, Any],
                layer_ms: Optional[Dict[str, float]] = None
                ) -> Dict[str, Any]:
    """Convert a :meth:`TraceLog.dump` dict (+ optional per-layer ms
    from ``profile_layer_steps``) to Chrome trace-event JSON."""
    traces = [t for t in dump.get("traces", []) if t.get("events")]
    # absolute event times: t0 + t_rel_s (older dumps without t0 still
    # render, each anchored at its own zero)
    def abs_t(trace, ev):
        return float(trace.get("t0", 0.0)) + float(ev["t_rel_s"])

    spans = dump.get("spans") or []
    t_min = min((abs_t(tr, tr["events"][0]) for tr in traces),
                default=min((sp["t0"] for sp in spans), default=0.0))

    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    lanes: Dict[int, _LaneAllocator] = {}
    seen_tids: set = set()

    def pid_of(name: str) -> int:
        if name not in pids:
            pids[name] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[name], "tid": 0,
                           "args": {"name": name}})
        return pids[name]

    for tr in sorted(traces, key=lambda t: abs_t(t, t["events"][0])):
        evs = tr["events"]
        pid = pid_of(_trace_pid(tr))
        t_start = (abs_t(tr, evs[0]) - t_min) * _US
        t_end = (abs_t(tr, evs[-1]) - t_min) * _US
        lane = lanes.setdefault(pid, _LaneAllocator())
        tid = lane.take(t_start, t_end) + 1
        if (pid, tid) not in seen_tids:
            seen_tids.add((pid, tid))
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": f"lane-{tid}"}})
        terminal = tr.get("terminal") or "open"
        rid = tr.get("request_id")
        # outer request span
        events.append({
            "ph": "B", "name": f"request ({terminal})", "pid": pid,
            "tid": tid, "ts": t_start, "cat": "request",
            "args": {"request_id": rid, "terminal": terminal,
                     "total_s": tr.get("total_s")},
        })
        # nested per-phase spans: the gap from event i to event i+1
        for a, b in zip(evs, evs[1:]):
            ta = (abs_t(tr, a) - t_min) * _US
            tb = (abs_t(tr, b) - t_min) * _US
            name = ("jit-step" if a["name"] == "jit-step-start"
                    else f"{a['name']}→{b['name']}")
            args = {k: v for k, v in a.items()
                    if k not in ("name", "t_rel_s")}
            events.append({"ph": "B", "name": name, "pid": pid,
                           "tid": tid, "ts": ta, "cat": "phase",
                           "args": args})
            events.append({"ph": "E", "pid": pid, "tid": tid, "ts": tb,
                           "cat": "phase"})
        events.append({"ph": "E", "pid": pid, "tid": tid, "ts": t_end,
                       "cat": "request"})

    if layer_ms:
        pid = pid_of("layers")
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 1, "args": {"name": "per-layer step"}})
        # sequential X spans: one profiled step per layer, end to end
        cursor = 0.0
        for layer, ms in layer_ms.items():
            dur = float(ms) * 1000.0      # ms -> us
            events.append({"ph": "X", "name": layer, "pid": pid,
                           "tid": 1, "ts": cursor, "dur": dur,
                           "cat": "layer",
                           "args": {"ms_per_step": float(ms)}})
            cursor += dur

    if spans:
        pid = pid_of("worker")
        batches = {b["batch"]: b for b in dump.get("batches", ())}
        threads = sorted({sp["thread"] for sp in spans})
        for tid, thread in enumerate(threads, 1):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"worker-{thread}"}})
        tids = {thread: tid for tid, thread in enumerate(threads, 1)}
        # parents before their children at one start: longest first
        for sp in sorted(spans, key=lambda sp: (sp["t0"], -sp["t1"])):
            t0 = max(sp["t0"], t_min)
            if sp["t1"] < t0:
                continue
            args = {"batch": sp["batch"], "span": sp["id"],
                    "parent": sp["parent"]}
            if sp["name"] == "batcher.gather" and sp["batch"] in batches:
                b = batches[sp["batch"]]
                args.update(n_real=b["n_real"], bucket=b["bucket"],
                            flush=b["flush"], late_s=b["late_s"],
                            hold_s=b.get("hold_s"), waves=b.get("waves"))
            events.append({"ph": "X", "name": sp["name"], "pid": pid,
                           "tid": tids[sp["thread"]],
                           "ts": (t0 - t_min) * _US,
                           "dur": (sp["t1"] - t0) * _US, "cat": "span",
                           "args": args})

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(path: str, dump: Dict[str, Any],
                   layer_ms: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Any]:
    doc = to_perfetto(dump, layer_ms=layer_ms)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_perfetto(doc: Dict[str, Any]) -> List[str]:
    """Chrome trace-event schema check; returns a list of problems
    (empty = valid).  Shared by tests, the bench gate, and obs-smoke CI.

    Checks: ``traceEvents`` list present; every event has ``ph`` and
    ``pid``/``tid``; duration/begin/end events have numeric ``ts``
    (``X`` also ``dur`` >= 0); per-(pid, tid) timestamps are monotonic
    non-decreasing in file order; and ``B``/``E`` events pair exactly
    (no unclosed begins, no stray ends).
    """
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts: Dict[Tuple, float] = {}
    depth: Dict[Tuple, int] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing ph")
            continue
        if "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i} ({ph}): missing pid/tid")
            continue
        if ph == "M":
            if "name" not in ev or "args" not in ev:
                problems.append(f"event {i}: metadata without name/args")
            continue
        if ph not in ("B", "E", "X"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i} ({ph}): non-numeric ts {ts!r}")
            continue
        if ph in ("B", "X") and "name" not in ev:
            problems.append(f"event {i} ({ph}): missing name")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} (X): bad dur {dur!r}")
        key = (ev["pid"], ev["tid"])
        if key in last_ts and ts < last_ts[key] - 1e-9:
            problems.append(
                f"event {i} ({ph}): ts {ts} < previous {last_ts[key]} "
                f"on track {key}")
        last_ts[key] = ts
        if ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            d = depth.get(key, 0)
            if d <= 0:
                problems.append(f"event {i}: E without matching B "
                                f"on track {key}")
            else:
                depth[key] = d - 1
    for key, d in sorted(depth.items()):
        if d:
            problems.append(f"track {key}: {d} unclosed B event(s)")
    return problems
