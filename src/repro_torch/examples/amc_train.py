"""End-to-end AMC example: train the paper's 5-layer SNN for a few hundred
steps with the full recipe — Σ-Δ encoding, surrogate-grad BPTT, joint L1
pruning on the 20/60/20 schedule to the paper's best mixed-density config
(Table V: 25-20-15-20-25), 16-bit LSQ QAT, checkpoints — then evaluate
across SNR and report the compression numbers.

Port of ``examples/amc_train.py``; on the card the steps replay the
trainer's CUDA graph.

Run:  PYTHONPATH=src python -m repro_torch.examples.amc_train [--steps 300]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.models.snn import density_report
from repro_torch.train.trainer import SNNTrainer, TrainerConfig

__all__ = ["main", "run"]

# paper Table V best trade-off: per-layer densities 25-20-15-20-25 (%)
PER_LAYER = {"conv1": 0.25, "conv2": 0.20, "conv3": 0.15,
             "fc1": 0.20, "fc2": 0.25}


def run(args) -> dict:
    """Train, evaluate across SNR and resume on ``args.device``; returns
    what it reports."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = TrainerConfig(
            total_steps=args.steps, batch_size=args.batch, lr=2e-3,
            per_layer_density=PER_LAYER, use_lsq=True, quant_bits=16,
            ckpt_dir=ckpt_dir, ckpt_every=100, snr_db=10.0,
        )
        trainer = SNNTrainer(SNN_CONFIG, cfg, device=args.device)
        print(f"training {args.steps} steps (prune 20/60/20 to "
              f"{PER_LAYER}, LSQ 16-bit, ckpt every 100)")
        hist = trainer.run()
        print(f"final train loss {hist['loss'][-1]:.4f} "
              f"acc {hist['acc'][-1]:.3f}")
        densities = density_report(trainer.params, trainer.masks)
        print("densities:", {k: round(v, 3) for k, v in densities.items()})

        print("accuracy vs SNR (paper Fig. 8 protocol):")
        accs = {}
        for snr in (-20, -10, 0, 10, 18):
            accs[snr] = trainer.evaluate(n_batches=3, snr_db=float(snr))
            print(f"  {snr:+4d} dB: {accs[snr]:.3f}")
        # checkpoint restart proof
        step_before = trainer.step
        trainer2 = SNNTrainer(SNN_CONFIG, cfg, device=args.device)
        assert trainer2.resume() and trainer2.step == step_before
        same = torch.allclose(trainer.params["fc"][0]["w"],
                              trainer2.params["fc"][0]["w"])
        print(f"checkpoint resume at step {trainer2.step}: params match {same}")
        return {"history": hist, "densities": densities, "accuracy": accs,
                "resumed_step": trainer2.step, "resume_match": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
