"""The port's serving CLI and its captured served step, held to the
reference (CPU).

* ``repro_torch.launch.serve.main(..., "--device", "cpu")`` and
  ``repro.launch.serve.main`` serve one reduced-config registry version
  and print the same requests, batches, activity counts and agreement,
  for the sync and the async engine, and the same per-version split for
  a canary.
* The CLI's observability plane on the CPU: two replicas behind the fleet
  router, a live ``/metrics`` endpoint scraped during ``--hold-s``, SLOs,
  the trace dump (every trace submit -> complete, both replicas admitted)
  and a Perfetto file both packages' validators pass.
* The served step: the plain-torch backends served without CUDA graphs
  are pinned (none), kernel backends never among them; launches made
  while a graph is captured are recorded for it, not counted, and every
  replay adds them; the race winner's step serves the first version.

Bucket flushes are made deterministic by full batches (requests a
multiple of the batch) and a long ``--max-delay-ms``.
"""
import contextlib
import gc
import io
import json
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from _torch_parity import setup
from repro import obs as ref_obs
from repro.deploy import ModelRegistry as RefRegistry
from repro.launch import serve as ref_serve
from repro.models.snn import SNNConfig as RefConfig
from repro_torch import obs
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.launches import add_launches, count_launch, recording
from repro_torch.kernels.stream_fused import stream_fused_forward
from repro_torch.launch import serve
from repro_torch.models.snn import SNNConfig
from repro_torch.serve import AsyncAMCServeEngine
from repro_torch.serve.capture import EAGER_BACKENDS, captures

SPEC = dict(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
            fc_specs=((32, 16), (16, 5)), input_width=16, timesteps=3,
            n_classes=5)
REQUESTS, BATCH = 32, 8
# full buckets only: a flush never waits on the delay, so the batch count
# is the same in both packages on any host
DETERMINISTIC = ["--requests", str(REQUESTS), "--batch", str(BATCH),
                 "--max-delay-ms", "2000"]


@pytest.fixture(autouse=True)
def isolated_obs():
    """Both packages' process-wide observability state, fresh per test:
    the CLI installs a registry's metrics, a tracer and SLO defaults."""
    saved = []
    for mod in (obs, ref_obs):
        saved.append((mod, mod.set_default_registry(mod.MetricsRegistry()),
                      mod.set_default_recorder(None),
                      mod.set_default_alert_manager(None)))
        mod.disable_tracing()
    try:
        yield
    finally:
        for mod, reg, rec, mgr in saved:
            mod.disable_tracing()
            mod.set_default_registry(reg)
            mod.set_default_recorder(rec)
            mod.set_default_alert_manager(mgr)


@pytest.fixture(scope="module")
def registry_root(tmp_path_factory):
    """A reference registry holding two reduced-config versions: v1
    (seed 0, production) and v2 (seed 1)."""
    root = str(tmp_path_factory.mktemp("registry"))
    reg = RefRegistry(root)
    cfg = RefConfig(**SPEC)
    for seed, alias in ((0, "production"), (1, "staging")):
        params, masks, _, _ = setup(cfg, seed, 0.5)
        reg.publish("amc", params, cfg, masks=masks, assignment="goap",
                    alias=alias)
    return root


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _report(text):
    """The fields both CLIs must agree on."""
    m = re.search(r"^requests=(\d+) batches=(\d+) backend=(\S+)", text, re.M)
    activity = re.search(r"^activity: .*$", text, re.M).group(0)
    agreement = re.search(r"^\(untrained net\) agreement.*$", text,
                          re.M).group(0)
    versions = re.findall(r"^  ([* ])(\S+)\s+backend=(\S+)\s+requests=\s*(\d+)"
                          r" batches=\s*(\d+)", text, re.M)
    return {"requests": int(m.group(1)), "batches": int(m.group(2)),
            "backend": m.group(3), "activity": activity,
            "agreement": agreement, "versions": versions}


@pytest.mark.parametrize("engine", ["sync", "async"])
def test_cli_prints_what_the_reference_prints(registry_root, engine):
    argv = ["--arch", "saocds-amc", "--registry", registry_root,
            "--engine", engine, "--backend", "goap"] + DETERMINISTIC
    rc, got = _run(serve.main, argv + ["--device", "cpu"])
    ref_rc, want = _run(ref_serve.main, argv)
    assert rc == ref_rc == 0
    port, ref = _report(got), _report(want)
    assert port == ref
    assert port["requests"] == REQUESTS
    assert port["batches"] == REQUESTS // BATCH
    assert "accum=0 " not in port["activity"]    # counted, not empty
    assert "registry: serving amc@1" in got


def test_cli_canary_split_equals_the_reference(registry_root):
    argv = ["--arch", "saocds-amc", "--registry", registry_root,
            "--canary", "amc@2", "--canary-pct", "25", "--backend", "goap",
            ] + DETERMINISTIC
    rc, got = _run(serve.main, argv + ["--device", "cpu"])
    ref_rc, want = _run(ref_serve.main, argv)
    assert rc == ref_rc == 0
    port = _report(got)
    assert port == _report(want)
    assert sorted(label for _, label, *_ in port["versions"]) == [
        "amc@1", "amc@2"]
    assert sum(int(v[3]) for v in port["versions"]) == REQUESTS
    assert "canary: amc@2 at 25% of batches" in got


def _scrape(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def test_cli_fleet_metrics_slo_and_dumps(registry_root, tmp_path):
    """Two replicas, a live endpoint scraped during the hold, the SLO
    plane, and both dumps, on the CPU."""
    trace, perfetto = tmp_path / "trace.json", tmp_path / "trace.pftrace.json"
    alerts = tmp_path / "alerts.jsonl"
    argv = ["--arch", "saocds-amc", "--registry", registry_root,
            "--backend", "goap", "--replicas", "2", "--metrics-port", "0",
            "--slo", "default", "--slo-interval-s", "0.05",
            "--alert-log", str(alerts), "--trace-dump", str(trace),
            "--perfetto-dump", str(perfetto), "--hold-s", "3",
            "--device", "cpu"] + DETERMINISTIC
    out = io.StringIO()
    result = {}

    def run():
        with contextlib.redirect_stdout(out):
            result["rc"] = serve.main(argv)

    worker = threading.Thread(target=run)
    worker.start()
    scraped = {}
    try:
        deadline = time.monotonic() + 120
        while "perfetto:" not in out.getvalue():   # serving done, holding
            assert worker.is_alive() and time.monotonic() < deadline
            time.sleep(0.05)
        base = re.search(r"metrics: (http://\S+)/metrics",
                         out.getvalue()).group(1)
        for path in ("/readyz", "/healthz", "/metrics", "/timeseries",
                     "/alerts"):
            scraped[path] = _scrape(base + path)
    finally:
        worker.join(timeout=60)
    assert not worker.is_alive() and result["rc"] == 0
    text = out.getvalue()
    assert "fleet: 2 replicas" in text
    assert all(code == 200 for code, _ in scraped.values())
    assert json.loads(scraped["/readyz"][1])["ready"] is True
    assert json.loads(scraped["/healthz"][1])["status"] == "ok"
    served = re.findall(
        rb'^repro_serve_requests_total\{engine="replica-(\d)"\} (\S+)$',
        scraped["/metrics"][1], re.M)
    assert {r for r, _ in served} == {b"0", b"1"}
    assert sum(float(n) for _, n in served) == REQUESTS
    assert json.loads(scraped["/timeseries"][1])["n_sweeps"] > 0
    assert "firing" in json.loads(scraped["/alerts"][1])
    dump = json.loads(trace.read_text())
    assert dump["n_completed"] == REQUESTS
    replicas = set()
    for rec in dump["traces"]:
        names = [ev["name"] for ev in rec["events"]]
        assert names[0] == "submit" and names[-1] == "complete"
        replicas |= {ev["replica"] for ev in rec["events"]
                     if ev["name"] == "admit"}
    assert replicas == {"replica-0", "replica-1"}
    doc = json.loads(perfetto.read_text())
    assert obs.validate_perfetto(doc) == []
    assert ref_obs.validate_perfetto(doc) == []
    assert re.search(r"^alerts: \d+ firing", text, re.M)


def test_cli_serves_with_the_warm_heap_frozen(registry_root, tmp_path,
                                             monkeypatch):
    """The stalled traced replica (ROADMAP Queue 3): tracing's allocations
    set off a full collection mid-window, which walks every long-lived
    object of the process.  The CLI freezes the warm heap for the serving
    window: at the first submit a full pass would walk a small fraction
    of what it walks outside the window, and the heap is handed back
    after."""
    seen = {}
    submit = AsyncAMCServeEngine.submit

    def first_submit(self, *args, **kwargs):
        if not seen:
            seen["frozen"] = gc.get_freeze_count()
            seen["walked"] = len(gc.get_objects())
        return submit(self, *args, **kwargs)

    monkeypatch.setattr(AsyncAMCServeEngine, "submit", first_submit)
    outside = len(gc.get_objects())      # a full pass walks these unfrozen
    rc, _ = _run(serve.main, [
        "--arch", "saocds-amc", "--registry", registry_root, "--device", "cpu",
        "--backend", "goap", "--deadline-ms", "600000",
        "--trace-dump", str(tmp_path / "trace.json")] + DETERMINISTIC)
    assert rc == 0
    assert seen["frozen"] > 0.8 * outside
    assert seen["walked"] < 0.1 * seen["frozen"]
    assert gc.get_freeze_count() == 0


def test_serving_heap_leaves_a_callers_frozen_heap_as_it_is():
    """A caller that froze its own heap before calling the CLI gets it back
    frozen: the serving window neither collects nor thaws it."""
    gc.freeze()
    try:
        frozen = gc.get_freeze_count()
        with serve.serving_heap():
            assert gc.get_freeze_count() == frozen
        assert gc.get_freeze_count() == frozen
    finally:
        gc.unfreeze()
    with serve.serving_heap():
        assert gc.get_freeze_count() > 0
    assert gc.get_freeze_count() == 0


def test_cli_refuses_what_it_cannot_serve(registry_root, capsys):
    # the language-model archs serve since the zoo was ported
    # (tests/test_torch_lm_train.py); the encoder-decoder one returns 1 with
    # the reference's message, and an arch of neither kind is refused by
    # the parser, as the reference's refuses it
    rc, text = _run(serve.main, ["--arch", "whisper-large-v3", "--device", "cpu"])
    assert rc == 1 and "use --arch of a decoder-only config" in text
    with pytest.raises(SystemExit) as refused:
        serve.main(["--arch", "gpt-2", "--device", "cpu"])
    assert refused.value.code == 2
    assert "invalid choice: 'gpt-2'" in capsys.readouterr().err
    rc, text = _run(serve.main, ["--arch", "saocds-amc", "--engine", "sync",
                                 "--replicas", "2", "--registry",
                                 registry_root, "--device", "cpu"])
    assert rc == 1 and "require the async engine" in text
    rc, text = _run(serve.main, ["--arch", "saocds-amc", "--canary",
                                 "amc@2", "--device", "cpu"])
    assert rc == 1 and "--canary requires --registry" in text


def test_cli_flags_are_the_reference_flags_plus_device():
    # the reference builds its parser inside main: read its flags from its
    # source
    with open(ref_serve.__file__) as f:
        ref_flags = set(re.findall(r'ap\.add_argument\("(--[a-z0-9-]+)"',
                                   f.read()))
    port_flags = {o for a in serve._parser()._actions
                  for o in a.option_strings} - {"-h", "--help"}
    assert len(ref_flags) == 29
    assert port_flags == ref_flags | {"--device"}


# ---------------------------------------------------------------------------
# the served step: which backends replay graphs, launch counts under replay
# ---------------------------------------------------------------------------

def test_no_backend_is_served_uncaptured_on_the_card():
    # no plain-torch backend needed an eager exception; the kernel
    # backends may never take one
    assert EAGER_BACKENDS == {}
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    for backend in ("dense", "goap", "stream", "fixed", "cuda", "cuda_fused"):
        assert captures(backend, card)
        assert not captures(backend, cpu)
    assert captures({"conv1": "cuda_fused", "fc1": "goap"}, card)


def test_capture_records_launches_and_replays_count_them():
    reset_launch_counts()
    count_launch(stream_fused_forward)                 # an eager launch
    with recording() as record:
        count_launch(stream_fused_forward)             # captured: no launch
        count_launch(stream_fused_forward)
        other = threading.Thread(target=count_launch,
                                 args=(stream_fused_forward,))
        other.start()                                  # another thread's
        other.join()                                   # launch counts
    assert dict(record) == {stream_fused_forward: 2}
    assert launch_counts()["stream_fused_forward"] == 2
    for _ in range(3):                                 # three replays
        add_launches(record)
    assert launch_counts()["stream_fused_forward"] == 8
    with recording():
        with pytest.raises(RuntimeError, match="nest"):
            with recording():
                pass
    reset_launch_counts()


def test_the_race_winner_step_serves_the_first_version(monkeypatch):
    _, _, params, masks = setup(RefConfig(**SPEC), 0, 0.5)
    made = []
    inner = AsyncAMCServeEngine._make_step

    def counting(self, plan, assignment):
        step = inner(self, plan, assignment)
        made.append((assignment, step[0]))
        return step

    monkeypatch.setattr(AsyncAMCServeEngine, "_make_step", counting)
    with AsyncAMCServeEngine(params, SNNConfig(**SPEC), masks,
                             max_batch=8, candidates=("dense", "goap"),
                             device="cpu") as engine:
        assert [a for a, _ in made] == ["dense", "goap"]   # the race only
        winner = dict(made)[engine.backend]
        assert engine.get_version("default").serve_step is winner
        engine.bind_version("v2", params, masks, backend="goap")
        assert len(made) == 3                              # a fresh step
