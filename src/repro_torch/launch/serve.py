"""Serving CLI: ``python -m repro_torch.launch.serve --arch saocds-amc``.

The paper's deployment mode on the card (``--device cpu`` for the CPU): a
stream of I/Q frames is Σ-Δ encoded and classified through the async
serving tier (:class:`~repro_torch.serve.AsyncAMCServeEngine`: request
queue -> dynamic micro-batcher -> autotuned backend, its served step
replayed from CUDA graphs on the card), reporting throughput, latency
percentiles and the activity counters that feed the power model.
``--engine sync`` runs the per-chunk loop instead; ``--replicas N`` puts N
replicas on the one card behind the fleet router; ``--metrics-port``,
``--trace-dump``, ``--perfetto-dump`` and ``--slo`` turn on the
observability plane.  The flags and the printed report are the
reference's (``repro/launch/serve.py``), plus ``--device``.

``--arch <assigned-lm-id>`` runs batched greedy generation on the reduced
config (:func:`generate`: one prefill that builds the decode state, then
``--new-tokens`` decode steps; on the card each is a CUDA-graph replay),
reporting tokens/s; the encoder-decoder ``whisper-large-v3`` returns 1, as
in the reference.

Examples::

    # the paper model on the card, two replicas, a live /metrics endpoint
    python -m repro_torch.launch.serve --arch saocds-amc --batch 64 \\
        --requests 512 --replicas 2 --metrics-port 9119 --hold-s 15

    # a registry version on the CPU
    python -m repro_torch.launch.serve --arch saocds-amc --device cpu \\
        --registry ./registry --model amc@production --backend goap

    # greedy generation on a reduced language model, on the card
    python -m repro_torch.launch.serve --arch llama3-8b --batch 4
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS

__all__ = ["Generator", "generate", "main"]


# the collector's permanent generation when this module was imported (the
# interpreter may start with a few hundred objects there)
_FROZEN_AT_IMPORT = gc.get_freeze_count()


@contextlib.contextmanager
def serving_heap():
    """Keep the collector's full passes off the serving window.

    Once the engine is warm, the process holds hundreds of thousands of
    long-lived objects (torch, the plans, the graphs).  A full (gen-2)
    collection walks all of them while it holds the GIL, and the
    allocations of tracing set one off during serving: on one H100 (NVIDIA
    H100 80GB HBM3, 700.00 W) one such pass of 117-142 ms stalled 3 of 10
    traced 1-replica windows of 512 requests to 3,014-3,685 frames/s,
    against 30,879-43,651 untraced (``chip_smoke.py``'s ``cli_window``).
    Here the garbage is collected once (84-268 ms of host time before the
    first request, on that machine), the survivors are moved to the collector's permanent
    generation for the window (``gc.freeze``), so a full pass during
    serving walks only what serving made, and they are handed back after
    it.  A caller that has frozen its own heap since this module was
    imported keeps it as it is: nothing is collected, frozen or handed
    back (``gc.unfreeze`` cannot hand back only part of it)."""
    if gc.get_freeze_count() > _FROZEN_AT_IMPORT:
        yield
        return
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


class Generator:
    """Greedy decode on fixed ``params``: the port of the reference's
    jitted prefill and decode step (``repro/launch/serve.py``).

    Both run through :func:`repro_torch.train.capture.static_jit` on the
    prompts' device: on the card each is a CUDA graph, captured at its
    shapes' first call and replayed (``capture=False`` runs the same
    buffers op by op, as the CPU always does).  The decode step donates
    its state and its token: the graph writes the next state and the
    greedy token back into its own buffers, so a step copies nothing in
    and waits for nothing.  The graphs read ``params`` in place, so they
    must not be reassigned; a ``Generator`` is reused across calls of the
    same shapes.
    """

    def __init__(self, cfg, params, capture: Optional[bool] = None):
        self.cfg, self.params, self.capture = cfg, params, capture
        self._prefill: Dict[int, Callable] = {}     # n_new -> step
        self._decode: Optional[Callable] = None

    def _greedy(self, logits):
        return torch.argmax(logits[:, -1, : self.cfg.vocab], dim=-1
                            ).to(torch.int32)[:, None]

    def _steps(self, device, n_new: int):
        from repro_torch.models.lm import lm_decode_step, lm_prefill
        from repro_torch.train.capture import static_jit

        cfg, params = self.cfg, self.params

        def prefill(prompts):
            patch = None
            if cfg.family == "vlm":
                patch = torch.zeros((prompts.shape[0], cfg.n_patches,
                                     cfg.d_model), dtype=torch.bfloat16,
                                    device=prompts.device)
            logits, states = lm_prefill(params, prompts, cfg,
                                        patch_embeds=patch,
                                        cache_headroom=n_new)
            return self._greedy(logits), states

        def decode(states, token):
            logits, states = lm_decode_step(params, states, token, cfg)
            return states, self._greedy(logits)

        if n_new not in self._prefill:
            self._prefill[n_new] = static_jit(prefill, device,
                                              capture=self.capture)
        if self._decode is None:
            self._decode = static_jit(decode, device, donate_argnums=(0, 1),
                                      capture=self.capture)
        return self._prefill[n_new], self._decode

    def __call__(self, prompts, n_new: int):
        """prompts (B, S) -> (B, S + n_new) int32 tokens, on the prompts'
        device; ties go to the lowest token id, as ``jnp.argmax`` gives
        them."""
        prefill, decode = self._steps(prompts.device, n_new)
        with torch.no_grad():
            token, states = prefill(prompts)
            out = [prompts.to(torch.int32)]
            for _ in range(n_new):
                out.append(token.clone())
                states, token = decode(states, token)
            return torch.cat(out, dim=1)


def generate(cfg, params, prompts, n_new: int, capture: Optional[bool] = None):
    """Greedy decode: prompts (B, S) -> (B, S + n_new) int32 tokens, on the
    prompts' device.  One prefill with room for ``n_new`` tokens in its
    caches, then ``n_new`` decode steps (see :class:`Generator`, which
    keeps its graphs for the next call)."""
    return Generator(cfg, params, capture=capture)(prompts, n_new)


def _serve_lm(args) -> int:
    """The reference's LM branch: greedy generation on the reduced config
    with params from seed 0, prompts from ``np.random.default_rng(0)``."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import init_lm

    cfg = reduced_config(args.arch)
    if cfg.family == "encdec":
        print("whisper serving demo lives in examples/; use --arch of a "
              "decoder-only config here")
        return 1
    device = resolve_device(args.device)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device=device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    t0 = time.perf_counter()
    tokens = generate(cfg, params, prompts, args.new_tokens)
    tokens = tokens.cpu()   # waits for the card
    dt = time.perf_counter() - t0
    n_gen = args.batch * args.new_tokens
    print(f"generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({n_gen / dt:.1f} tok/s)")
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True,
                    choices=list(ARCH_IDS) + ["saocds-amc"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64,
                    help="saocds-amc: number of I/Q frames to classify")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--engine", choices=["async", "sync"], default="async",
                    help="saocds-amc: async micro-batched tier or the "
                         "per-chunk loop")
    ap.add_argument("--backend", default="auto",
                    help="saocds-amc: execution backend ('dense'/'goap'/"
                         "'cuda'/'cuda_fused'/'stream'/'fixed'), 'auto' to "
                         "race the candidates at bind time, or 'per-layer' "
                         "to race them layer by layer and serve the "
                         "winning assignment (async engine only); 'fixed' "
                         "serves integer inference (hardware-parity tier)")
    ap.add_argument("--quant-bits", type=int, choices=(8, 16), default=None,
                    help="saocds-amc: weight quantization width for the "
                         "fixed/LSQ serving paths (default: the registry "
                         "version's setting, else 16)")
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1,
                    help="saocds-amc: replicas on the one card behind a "
                         "fleet router with join-shortest-queue dispatch "
                         "and admission control (async engine only)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="saocds-amc: per-request latency budget; a request "
                         "still queued past it fails fast instead of "
                         "occupying a batch slot (async engine only)")
    ap.add_argument("--priority", choices=["realtime", "bulk"],
                    default="realtime",
                    help="saocds-amc: dequeue class for the offered "
                         "requests (realtime preempts bulk, weighted)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="saocds-amc: per-replica admission bound; submits "
                         "beyond it are rejected (shed at the fleet door)")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="saocds-amc: serve from a model registry instead "
                         "of fresh random weights")
    ap.add_argument("--model", default="amc", metavar="NAME[@VER|@ALIAS]",
                    help="registry spec to serve (default: 'amc', which "
                         "resolves through the production alias)")
    ap.add_argument("--canary", default=None, metavar="NAME@VER",
                    help="registry spec to bind as a canary next to the "
                         "primary (async engine only)")
    ap.add_argument("--canary-pct", type=float, default=10.0,
                    help="percent of batches routed to the canary")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="saocds-amc: serve /metrics (Prometheus text), "
                         "/healthz, /readyz, /trace, /timeseries and "
                         "/alerts on this port for the run's duration (0 "
                         "picks a free port)")
    ap.add_argument("--metrics-host", default="127.0.0.1",
                    help="bind address for --metrics-port")
    ap.add_argument("--trace-dump", default=None, metavar="PATH",
                    help="saocds-amc: enable request tracing and write the "
                         "completed span timelines to PATH as JSON")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="trace every Nth request (deterministic; 1 = all)")
    ap.add_argument("--hold-s", type=float, default=0.0,
                    help="keep the metrics endpoint alive this many "
                         "seconds after serving finishes; the engine stays "
                         "open through the hold so /readyz and /healthz "
                         "reflect a live serving process")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="saocds-amc: comma-separated SLO clauses "
                         "('default', 'availability=0.999', 'p99_ms=50', "
                         "'accuracy=0.9'); starts a live time-series "
                         "recorder + burn-rate engine + drift detectors, "
                         "served on /timeseries and /alerts")
    ap.add_argument("--slo-scale", type=float, default=1.0 / 60.0,
                    help="shrink the Google-SRE burn windows by this "
                         "factor (default 1/60: the 5m/1h page pair "
                         "becomes 5s/60s, sized for runs of a minute)")
    ap.add_argument("--slo-interval-s", type=float, default=0.5,
                    help="time-series sampling / alert evaluation period")
    ap.add_argument("--alert-log", default=None, metavar="PATH",
                    help="append one JSON line per alert fire/resolve "
                         "transition to PATH")
    ap.add_argument("--perfetto-dump", default=None, metavar="PATH",
                    help="saocds-amc: enable request tracing and write the "
                         "completed spans as Chrome trace-event JSON "
                         "(loadable in ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run the "
                         "plain versions on the CPU)")
    return ap


def _serve_async(engine, iq: np.ndarray, args) -> np.ndarray:
    """Submit every request to the async engine (or fleet) and collect
    the predictions; with replicas or a deadline, a blown deadline or a
    shed request is an outcome to report, not a crash of the CLI."""
    if args.replicas > 1 or args.deadline_ms is not None:
        from repro_torch.fleet import ShedError
        from repro_torch.serve import DeadlineExceeded, QueueFull

        preds = np.full((args.requests,), -1, np.int32)
        n_expired = n_shed = 0
        futures = []
        for i in range(args.requests):
            try:
                futures.append((i, engine.submit(
                    iq[i], deadline_ms=args.deadline_ms,
                    priority=args.priority)))
            except (ShedError, QueueFull):
                n_shed += 1
        for i, fut in futures:
            try:
                preds[i] = fut.result(timeout=300.0)
            except DeadlineExceeded:
                n_expired += 1
        if n_expired or n_shed:
            print(f"outcomes: {n_expired} expired, {n_shed} shed of "
                  f"{args.requests}")
        return preds
    return engine.classify(iq, priority=args.priority)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.arch != "saocds-amc":
        return _serve_lm(args)

    from repro_torch.configs.saocds_amc import CONFIG
    from repro_torch.data.radioml import generate_batch
    from repro_torch.models.snn import init_snn
    from repro_torch.serve import AMCServeEngine, AsyncAMCServeEngine
    from repro_torch.train.pruning import make_mask_pytree

    # observability first: the exposition endpoint and the tracer must
    # exist before the engine binds (bind-time schedule gauges) and before
    # the first submit (trace timelines start at the door)
    metrics_server = None
    if args.metrics_port is not None:
        from repro_torch.obs import MetricsServer

        metrics_server = MetricsServer(host=args.metrics_host,
                                       port=args.metrics_port)
        print(f"metrics: http://{metrics_server.host}"
              f":{metrics_server.port}/metrics")
    if args.trace_dump or args.perfetto_dump:
        from repro_torch.obs import enable_tracing

        enable_tracing(sample_every=max(1, args.trace_sample))

    # the analysis plane: recorder -> burn-rate engine + drift detectors ->
    # alert manager, sampled on one loop thread; the process-wide installs
    # make /timeseries and /alerts live
    obs_stop = threading.Event()
    obs_thread = alert_manager = None
    if args.slo:
        from repro_torch.obs import (
            AlertManager,
            BurnRateEngine,
            BurnRateWatcher,
            SeriesWatcher,
            TimeSeriesRecorder,
            log_file_sink,
            parse_slo_spec,
            scaled_windows,
            set_default_alert_manager,
            set_default_recorder,
        )

        slos = parse_slo_spec(args.slo)
        recorder = TimeSeriesRecorder(interval_s=args.slo_interval_s,
                                      capacity=4096)
        alert_manager = AlertManager()
        if args.alert_log:
            alert_manager.add_sink(log_file_sink(args.alert_log))
        burn_watcher = BurnRateWatcher(
            BurnRateEngine(recorder, slos,
                           windows=scaled_windows(args.slo_scale)),
            alert_manager)
        drift_watcher = SeriesWatcher(recorder, alert_manager)
        set_default_recorder(recorder)
        set_default_alert_manager(alert_manager)

        def obs_loop() -> None:
            while not obs_stop.wait(args.slo_interval_s):
                recorder.sample()
                drift_watcher.step()
                burn_watcher.step()

        obs_thread = threading.Thread(target=obs_loop, daemon=True,
                                      name="obs-analysis")
        obs_thread.start()
        print(f"slo: {', '.join(s.name for s in slos)} "
              f"(windows x{args.slo_scale:g}, "
              f"sampling {args.slo_interval_s:g}s)")

    snn_config = CONFIG
    registry = canary_loaded = None
    version_label = "adhoc"
    lsq_scales, quant_bits = None, 16
    if args.registry:
        from repro_torch.deploy import ModelRegistry

        registry = ModelRegistry(args.registry, device=args.device)
        loaded = registry.load(args.model)
        params, masks = loaded.params, loaded.masks
        lsq_scales = loaded.lsq_scales
        quant_bits = loaded.version.quant_bits
        snn_config = loaded.cfg
        version_label = loaded.version.spec
        print(f"registry: serving {version_label} "
              f"(digest {loaded.version.digest[:12]}…)")
        if args.canary:
            if args.engine == "sync":
                print("--canary requires the async engine (--engine async)")
                return 1
            canary_loaded = registry.load(args.canary)
            if canary_loaded.cfg != snn_config:
                print("canary config differs from the primary's; a config "
                      "change is a redeploy, not a canary")
                return 1
    else:
        if args.canary:
            print("--canary requires --registry")
            return 1
        params = init_snn(0, snn_config)
        masks = make_mask_pytree(params, args.density)
    if args.quant_bits is not None:
        quant_bits = args.quant_bits
    if args.backend == "fixed":
        src = ("trained LSQ steps" if lsq_scales is not None
               else "max-abs calibration")
        print(f"fixed-point tier: {quant_bits}-bit integer inference ({src})")
    iq, labels, _ = generate_batch(0, args.requests, snr_db=10.0,
                                   frame_len=snn_config.input_width)
    if args.engine == "sync":
        if args.replicas > 1 or args.deadline_ms is not None \
                or args.max_queue is not None:
            print("--replicas/--deadline-ms/--max-queue require the async "
                  "engine (--engine async)")
            return 1
        backend = args.backend
        if backend in ("auto", "per-layer"):
            print(f"(sync engine does not support --backend {backend}; "
                  "using goap)")
            backend = "goap"
        engine = AMCServeEngine(params, snn_config, masks=masks,
                                batch_size=args.batch, count_activity=True,
                                backend=backend, lsq_scales=lsq_scales,
                                quant_bits=quant_bits, device=args.device)
        with serving_heap():
            preds = engine.classify(iq)
    else:
        # host-side activity counting is a power-model instrument; per
        # batch it costs orders of magnitude more than the serving path
        # itself, so the fleet/deadline tier (which measures serving
        # latency) runs without it
        engine_kwargs = dict(
            backend=args.backend, max_batch=args.batch,
            max_delay_ms=args.max_delay_ms, workers=args.workers,
            max_queue=args.max_queue,
            count_activity=(args.replicas == 1 and args.deadline_ms is None),
            version_label=version_label, lsq_scales=lsq_scales,
            quant_bits=quant_bits, device=args.device)
        if args.replicas > 1:
            from repro_torch.fleet import FleetRouter, engine_factory

            engine = FleetRouter(
                engine_factory(params, snn_config, masks=masks,
                               **engine_kwargs),
                replicas=args.replicas,
                max_replicas=max(args.replicas, 8),
                default_priority=args.priority,
                default_deadline_ms=args.deadline_ms)
            print(f"fleet: {args.replicas} replicas, join-shortest-queue "
                  "dispatch"
                  + (f", max_queue={args.max_queue}/replica"
                     if args.max_queue else ""))
        else:
            engine = AsyncAMCServeEngine(params, snn_config, masks=masks,
                                         **engine_kwargs)
        if metrics_server is not None:
            from repro_torch.obs import (alert_health_check,
                                         engine_health_check,
                                         engine_ready_probe)

            # /readyz gates on the warm-up or first successful step;
            # /healthz degrades on firing page alerts or engine close
            metrics_server.add_ready_probe("engine",
                                           engine_ready_probe(engine))
            metrics_server.add_health_check("alerts", alert_health_check())
            metrics_server.add_health_check("engine",
                                            engine_health_check(engine))
        # autotune/per-layer reports exist on a single engine only; a
        # fleet's replicas tune independently behind the router
        if getattr(engine, "autotune", None) is not None:
            t = ", ".join(f"{k}={v:.1f}ms"
                          for k, v in engine.autotune.timings_ms.items())
            print(f"autotune[{t}] -> {engine.backend}")
        if getattr(engine, "perlayer", None) is not None:
            a = ", ".join(f"{k}={v}" for k, v in engine.assignment.items())
            print(f"per-layer autotune -> [{a}] (fused streaming plan)")
        if canary_loaded is not None:
            from repro_torch.deploy import canary_router

            clabel = canary_loaded.version.spec
            if clabel == version_label:
                print(f"canary {clabel} is the primary version; skipping "
                      "the split")
            else:
                engine.bind_version(
                    clabel, canary_loaded.params, canary_loaded.masks,
                    lsq_scales=canary_loaded.lsq_scales,
                    quant_bits=canary_loaded.version.quant_bits)
                engine.set_router(canary_router(version_label, clabel,
                                                args.canary_pct))
                print(f"canary: {clabel} at {args.canary_pct:.0f}% of "
                      "batches")
        with serving_heap():
            preds = _serve_async(engine, iq, args)
        for label, vstats in engine.version_stats().items():
            marker = "*" if label == engine.active_version else " "
            print(f"  {marker}{label:24s} backend={vstats.backend:9s} "
                  f"requests={vstats.requests:5d} "
                  f"batches={vstats.batches:4d} "
                  f"p99={vstats.p99_ms:.1f}ms")
        if args.replicas > 1:
            fs = engine.export_stats()
            print(f"fleet: {fs['n_replicas']} replicas  "
                  f"submitted={fs['n_submitted']} shed={fs['n_shed']} "
                  f"expired={fs['n_expired']}")
        if metrics_server is None or args.hold_s <= 0:
            # with a held metrics endpoint the engine stays open so
            # /readyz and /healthz reflect a live serving process; it
            # closes right before the endpoint does
            engine.close()
    st = engine.stats
    print(f"requests={st.requests} batches={st.batches} "
          f"backend={st.backend} "
          f"throughput={st.throughput_samples_per_s() / 1e3:.1f} kS/s "
          f"({st.throughput_fps():.0f} frames/s)")
    print(f"latency p50={st.p50_ms:.1f}ms p95={st.p95_ms:.1f}ms "
          f"p99={st.p99_ms:.1f}ms  mean queue depth "
          f"{st.mean_queue_depth():.1f}  padded {st.padded_frames}")
    print(f"activity: accum={st.accumulations} "
          f"fetched_bits={st.fetched_bits}")
    print(f"(untrained net) agreement with labels: "
          f"{float((preds == labels).mean()):.3f}")
    if args.trace_dump or args.perfetto_dump:
        from repro_torch.obs import get_tracer, write_perfetto

        dump = get_tracer().dump()
        if args.trace_dump:
            with open(args.trace_dump, "w") as f:
                json.dump(dump, f, indent=2)
            print(f"trace: {dump['n_completed']} of {dump['n_seen']} "
                  f"requests traced -> {args.trace_dump}")
        if args.perfetto_dump:
            doc = write_perfetto(args.perfetto_dump, dump)
            print(f"perfetto: {len(doc['traceEvents'])} events -> "
                  f"{args.perfetto_dump} (open in ui.perfetto.dev)")
    if alert_manager is not None:
        firing = alert_manager.firing()
        print(f"alerts: {len(firing)} firing, "
              f"{len(alert_manager.history)} total transitions"
              + (f" ({', '.join(a.name for a in firing)})" if firing else ""))
    if metrics_server is not None:
        # dumps are already on disk: a scraper ending the hold early still
        # finds the artifacts, and a scrape during it sees final totals
        if args.hold_s > 0:
            time.sleep(args.hold_s)
        if args.engine != "sync" and args.hold_s > 0:
            engine.close()  # was deferred through the hold window
        metrics_server.close()
    obs_stop.set()
    if obs_thread is not None:
        obs_thread.join(timeout=5.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
