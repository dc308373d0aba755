"""Stdlib HTTP exposition endpoint for the whole observability plane.

A copy of the reference's ``repro/obs/http.py`` over the port's
registry, tracer, recorder and alert manager.

A :class:`MetricsServer` runs a ``ThreadingHTTPServer`` on a daemon
thread — the shape a scraper (Prometheus, a curl in CI) expects, with no
dependency beyond the standard library:

* ``GET /metrics``        — text exposition format 0.0.4 of the registry;
* ``GET /healthz``        — liveness *with pluggable checks*: 200
  ``{"status": "ok"}`` while every registered check passes, 503
  ``{"status": "degraded", "failed": [...]}`` otherwise (stock checks:
  :func:`alert_health_check` degrades on firing page-severity alerts,
  :func:`engine_health_check` on a closed engine);
* ``GET /readyz``         — readiness: 200 only once every registered
  readiness probe returns True (the serving engine arms its probe after
  its warm-up or its first successful step), 503 ``{"ready": false}``
  before —
  the orchestrator-facing "can I route traffic here yet" signal,
  distinct from liveness;
* ``GET /trace``          — the active :class:`~repro_torch.obs.trace.TraceLog`
  dump (404 when tracing is disabled); honors ``?limit=N`` (newest N);
* ``GET /trace/perfetto`` — the same dump exported as Chrome trace-event
  JSON (:mod:`repro_torch.obs.export`), directly loadable in ui.perfetto.dev;
* ``GET /timeseries``     — the process-wide
  :class:`~repro_torch.obs.timeseries.TimeSeriesRecorder` ring (404 if none
  installed);
* ``GET /alerts``         — the process-wide
  :class:`~repro_torch.obs.anomaly.AlertManager` state (404 if none).

``HEAD`` is supported on every route (headers only — what load-balancer
probes send).  The registry, tracer, recorder, and alert manager are
resolved **per request** (defaulting to the process-wide ones), so a
server started before ``enable_tracing`` still serves traces, and a test
swapping the default registry is immediately visible on the next scrape.
``port=0`` binds an ephemeral port (``server.port`` reports it).
"""
from __future__ import annotations

import http.server
import json
import threading
import time
import urllib.parse
from typing import Callable, List, Optional, Tuple

from repro_torch.obs.anomaly import get_default_alert_manager
from repro_torch.obs.export import to_perfetto
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.timeseries import get_default_recorder
from repro_torch.obs.trace import get_tracer

__all__ = ["MetricsServer", "alert_health_check", "engine_health_check",
           "engine_ready_probe"]

#: health check: () -> None when healthy, or a failure-reason string
HealthCheck = Callable[[], Optional[str]]
#: readiness probe: () -> bool
ReadyProbe = Callable[[], bool]


def alert_health_check(manager=None) -> HealthCheck:
    """Degrade /healthz while any page-severity alert is firing.

    ``manager=None`` resolves the process-wide manager per call, so the
    check can be registered before alerting is wired up.
    """
    def check() -> Optional[str]:
        mgr = manager if manager is not None \
            else get_default_alert_manager()
        if mgr is None:
            return None
        firing = mgr.firing(severity="page")
        if firing:
            names = ", ".join(sorted({a.name for a in firing}))
            return f"page alerts firing: {names}"
        return None
    return check


def engine_health_check(engine) -> HealthCheck:
    """Degrade /healthz once the engine/fleet has been closed."""
    def check() -> Optional[str]:
        if getattr(engine, "closed", False):
            return f"engine {getattr(engine, 'name', '?')} closed"
        return None
    return check


def engine_ready_probe(engine) -> ReadyProbe:
    """Ready once the engine reports its warm-up or first successful
    step (``engine.is_ready()``)."""
    def probe() -> bool:
        is_ready = getattr(engine, "is_ready", None)
        return bool(is_ready()) if callable(is_ready) else True
    return probe


class MetricsServer:
    """Background HTTP endpoint for metrics/health/traces/alerts."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._registry = registry
        self._t_started = time.perf_counter()
        self._lock = threading.Lock()
        self._health_checks: List[Tuple[str, HealthCheck]] = []
        self._ready_probes: List[Tuple[str, ReadyProbe]] = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 — silence stderr
                pass

            def _send(self, code: int, body: bytes, ctype: str,
                      head_only: bool = False) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if not head_only:
                    self.wfile.write(body)

            def _respond(self, head_only: bool) -> None:
                parsed = urllib.parse.urlsplit(self.path)
                path = parsed.path
                query = urllib.parse.parse_qs(parsed.query)
                try:
                    code, body, ctype = outer._route(path, query)
                    self._send(code, body, ctype, head_only=head_only)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # scraper went away mid-response

            def do_GET(self):  # noqa: N802 — http.server API
                self._respond(head_only=False)

            def do_HEAD(self):  # noqa: N802 — http.server API
                self._respond(head_only=True)

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"obs-metrics-{self.port}")
        self._thread.start()

    # -- wiring --------------------------------------------------------------

    def add_health_check(self, name: str, check: HealthCheck) -> None:
        with self._lock:
            self._health_checks.append((name, check))

    def add_ready_probe(self, name: str, probe: ReadyProbe) -> None:
        with self._lock:
            self._ready_probes.append((name, probe))

    # -- routing (outside the handler so tests can call it directly) ---------

    def _route(self, path: str, query) -> Tuple[int, bytes, str]:
        if path == "/metrics":
            reg = (self._registry if self._registry is not None
                   else default_registry())
            return (200, reg.to_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
        if path == "/healthz":
            return self._healthz()
        if path == "/readyz":
            return self._readyz()
        if path in ("/trace", "/trace/perfetto"):
            tracer = get_tracer()
            if tracer is None:
                return (404, b'{"error": "tracing disabled"}',
                        "application/json")
            limit = None
            if query.get("limit"):
                try:
                    limit = max(0, int(query["limit"][0]))
                except ValueError:
                    return (400, b'{"error": "bad limit"}',
                            "application/json")
            dump = tracer.dump(limit=limit)
            if path == "/trace/perfetto":
                return (200, json.dumps(to_perfetto(dump)).encode(),
                        "application/json")
            return 200, json.dumps(dump).encode(), "application/json"
        if path == "/timeseries":
            recorder = get_default_recorder()
            if recorder is None:
                return (404, b'{"error": "no recorder installed"}',
                        "application/json")
            return (200, json.dumps(recorder.to_json()).encode(),
                    "application/json")
        if path == "/alerts":
            manager = get_default_alert_manager()
            if manager is None:
                return (404, b'{"error": "no alert manager installed"}',
                        "application/json")
            return (200, json.dumps(manager.to_json()).encode(),
                    "application/json")
        return 404, b"not found", "text/plain"

    def _healthz(self) -> Tuple[int, bytes, str]:
        with self._lock:
            checks = list(self._health_checks)
        failed = []
        for name, check in checks:
            try:
                reason = check()
            except Exception as e:  # a broken check is itself unhealthy
                reason = f"check raised {type(e).__name__}: {e}"
            if reason is not None:
                failed.append({"check": name, "reason": reason})
        body = {
            "status": "ok" if not failed else "degraded",
            "uptime_s": time.perf_counter() - self._t_started,
        }
        if failed:
            body["failed"] = failed
        return ((200 if not failed else 503),
                json.dumps(body).encode(), "application/json")

    def _readyz(self) -> Tuple[int, bytes, str]:
        with self._lock:
            probes = list(self._ready_probes)
        waiting = []
        for name, probe in probes:
            try:
                ok = bool(probe())
            except Exception:
                ok = False
            if not ok:
                waiting.append(name)
        ready = not waiting
        body = {"ready": ready}
        if waiting:
            body["waiting_on"] = waiting
        return ((200 if ready else 503),
                json.dumps(body).encode(), "application/json")

    # -- lifecycle -----------------------------------------------------------

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
