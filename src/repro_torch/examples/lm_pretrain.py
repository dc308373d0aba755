"""LM pretraining example on an assigned architecture (reduced scale).

Port of ``examples/lm_pretrain.py``: the same train step the launcher runs
(AdamW, clipping, chunked cross-entropy, recomputed layer stacks) on a
synthetic Zipf token stream, with checkpoint/resume, then the proof that
the resume is bitwise identical: a fresh trainer resumed from the
checkpoint holds params equal bit for bit to the ones saved, and the two
trainers' next steps give identical losses.  Returns 1 if either fails.

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_pretrain
      [--arch llama3-8b] [--steps 60] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.launch.train import LMTrainer
from repro_torch.tree import tree_leaves

__all__ = ["main", "run"]


def run(args) -> dict:
    """The crash-restart proof on ``args.device``; returns what it reports."""
    cfg = reduced_config(args.arch)
    print(f"arch {args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"family={cfg.family}), {args.steps} steps")

    with tempfile.TemporaryDirectory() as d:
        tr = LMTrainer(cfg, lr=5e-3, batch=4, seq=32, ckpt_dir=d,
                       device=args.device)
        hist = tr.run(args.steps // 2, log_every=10, ckpt_every=10)
        mid_params = [p.detach().cpu().clone() for p in tree_leaves(tr.params)]

        # crash-restart: fresh trainer, resume from the checkpoint
        tr2 = LMTrainer(cfg, lr=5e-3, batch=4, seq=32, ckpt_dir=d,
                        device=args.device)
        assert tr2.resume(), "resume failed"
        same = all(torch.equal(a, b.cpu())
                   for a, b in zip(mid_params, tree_leaves(tr2.params)))
        print(f"resumed at step {tr2.step}; params bitwise equal: {same}")

        # both trainers take the same next steps -> identical trajectories
        h1 = tr.run(args.steps // 2, log_every=max(1, args.steps // 2))
        h2 = tr2.run(args.steps // 2, log_every=max(1, args.steps // 2))
        identical = h1["loss"][-1] == h2["loss"][-1]
        print(f"post-resume losses: original {h1['loss'][-1]:.6f} "
              f"vs resumed {h2['loss'][-1]:.6f} (identical: {identical})")
        print(f"loss {hist['loss'][0]:.3f} -> {h1['loss'][-1]:.3f}")
    return {"resumed_step": tr2.step, "params_equal": same,
            "losses_identical": identical, "first_loss": hist["loss"][0],
            "last_loss": h1["loss"][-1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    out = run(ap.parse_args(argv))
    return 0 if out["params_equal"] and out["losses_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
