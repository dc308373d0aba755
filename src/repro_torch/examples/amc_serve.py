"""Serving example: async streaming AMC classification (the paper's
deployment, production-tier edition).

Port of ``examples/amc_serve.py``.  Trains briefly so predictions are
meaningful, prunes to 50%, then serves a pile of I/Q requests through the
async tier — request queue, dynamic micro-batching (tail padded to fixed
bucket shapes), warmup-race backend autotuning, and Σ-Δ encoding fused
into the served step (replayed from a CUDA graph on the card) — reporting
throughput, latency percentiles, accuracy, and the activity counters that
drive the power model (accumulations + fetched bits, paper §V).

Run:  PYTHONPATH=src python -m repro_torch.examples.amc_serve [--requests 64]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.core.cost_model import PAPER_TABLE5, PowerModel
from repro_torch.data.radioml import MODULATIONS, generate_batch
from repro_torch.device import resolve_device
from repro_torch.serve import AsyncAMCServeEngine
from repro_torch.train.trainer import SNNTrainer, TrainerConfig

__all__ = ["main", "run"]

# the uncalibrated demo coefficients of the reference's example
POWER_MODEL = dict(c_acc=1e-9, c_bit=1e-10, c_util=0.3)


def run(args) -> dict:
    """Train, serve and report on ``args.device``; returns what it reports."""
    dev = resolve_device(args.device)
    print(f"pre-training {args.train_steps} steps at density {args.density}")
    trainer = SNNTrainer(SNN_CONFIG, TrainerConfig(
        total_steps=args.train_steps, batch_size=48, lr=2e-3,
        final_density=args.density, snr_db=10.0), device=dev)
    trainer.run()

    with AsyncAMCServeEngine(
            trainer.params, SNN_CONFIG, masks=trainer.masks,
            backend=args.backend, max_batch=args.max_batch,
            max_delay_ms=args.max_delay_ms, count_activity=True,
            device=dev) as engine:
        if engine.autotune is not None:
            timings = ", ".join(f"{k} {v:.1f}ms"
                                for k, v in engine.autotune.timings_ms.items())
            print(f"autotune raced [{timings}] -> pinned '{engine.backend}'")
        if engine.perlayer is not None:
            print(f"per-layer autotune -> {engine.assignment} "
                  f"(fused streaming plan {engine.plan.digest[:12]}…)")
        iq, labels, _ = generate_batch(seed=4242, batch=args.requests,
                                       snr_db=10.0)
        preds = engine.classify(iq)
        st = engine.stats

    acc = float((preds == labels).mean())
    where = "CPU" if dev.type == "cpu" else "card"
    print(f"served {st.requests} requests in {st.batches} micro-batches "
          f"({st.backend_batch_counts()}): "
          f"{st.throughput_samples_per_s() / 1e3:.1f} kS/s "
          f"({st.throughput_fps():.0f} frames/s, {where}), accuracy {acc:.3f}")
    print(f"latency p50 {st.p50_ms:.1f} ms / p95 {st.p95_ms:.1f} ms / "
          f"p99 {st.p99_ms:.1f} ms; mean queue depth "
          f"{st.mean_queue_depth():.1f}; {st.padded_frames} padded frames")
    print("sample predictions:",
          [MODULATIONS[p] for p in preds[:6]], "...")
    print(f"activity: {st.accumulations} accumulations, "
          f"{st.fetched_bits} fetched bits")
    # feed the activity into the paper-calibrated power model
    pm = PowerModel(**POWER_MODEL)
    watts = pm.predict(st.accumulations / max(st.wall_s, 1e-9),
                       st.fetched_bits / max(st.wall_s, 1e-9), 0.5)
    print(f"activity-model dynamic power (uncalibrated demo): {watts:.3f} W "
          f"(paper Table V at 50%: {PAPER_TABLE5[0.5][0]} W)")
    return {"params": trainer.params, "masks": trainer.masks, "iq": iq,
            "labels": labels, "predictions": preds, "accuracy": acc,
            "backend": engine.backend, "accumulations": st.accumulations,
            "fetched_bits": st.fetched_bits, "wall_s": st.wall_s,
            "watts": watts, "paper_watts": PAPER_TABLE5[0.5][0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=120)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--backend", default="auto",
                    help="'auto' races the candidate backends at bind time; "
                         "'per-layer' races them layer by layer and serves "
                         "the heterogeneous assignment through the fused "
                         "streaming plan")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
