"""Training entry point: ``python -m repro_torch.launch.train --arch saocds-amc``.

Trains the paper's SNN classifier end to end on the card (``--device
cpu`` for the CPU): Σ-Δ encoded synthetic RadioML, surrogate-gradient
BPTT, optional pruning (``--density``) and 16-bit LSQ (``--lsq``),
checkpointed every ``--ckpt-every`` steps and resumable (``--resume``),
with a straggler monitor flagging steps above 3x the trailing median.  On
the card each step replays the trainer's CUDA graph without waiting for
it; the median step time printed is the host's, step to step.
The language-model architectures of the reference's launcher wait for the
model zoo; any other ``--arch`` exits non-zero.
"""
from __future__ import annotations

import argparse
import statistics
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--density", type=float, default=None,
                    help="target weight density (pruning)")
    ap.add_argument("--lsq", action="store_true",
                    help="16-bit LSQ quantization-aware training")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    if args.arch != "saocds-amc":
        print(f"--arch {args.arch!r}: only saocds-amc trains in the port; the "
              "language-model zoo is not ported yet (ROADMAP Queue 1, the "
              "model zoo)", file=sys.stderr)
        return 2

    from repro_torch.configs.saocds_amc import CONFIG
    from repro_torch.train.trainer import SNNTrainer, TrainerConfig

    tcfg = TrainerConfig(
        total_steps=args.steps, batch_size=args.batch, lr=args.lr,
        final_density=args.density, use_lsq=args.lsq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    trainer = SNNTrainer(CONFIG, tcfg, device=args.device)
    if args.resume and trainer.resume():
        print(f"resumed at step {trainer.step}")
    hist = trainer.run()
    acc = trainer.evaluate(snr_db=10.0)
    step_ms = statistics.median(trainer.step_times) * 1e3
    print(f"final loss {hist['loss'][-1]:.4f}  acc@10dB {acc:.3f}  "
          f"step {step_ms:.3f} ms (median, host to host)  "
          f"stragglers {len(trainer.stragglers)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
