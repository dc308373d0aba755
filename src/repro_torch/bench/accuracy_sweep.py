"""Paper Fig. 8 + Table V accuracy: SNR sweep and compression retention.

Port of ``benchmarks/accuracy_sweep.py``:

* Fig. 8 trend: accuracy is near chance at very low SNR and rises past
  ~0 dB (the shape, not the paper's absolute numbers: synthetic
  generator, shorter training budget).
* Table V trend: the compressed (pruned + quantized) model's accuracy is
  measured against the original model's predictions (the paper's
  protocol): retention stays high at moderate density and collapses at
  extreme sparsity.

Trains one dense model (``steps`` steps of :class:`~repro_torch.train.
SNNTrainer`) on ``device`` (the card unless ``--device cpu``), then
derives pruned / quantized variants by masking and fake-quant (no
retraining, so the retention figures are a lower bound).  The init is
numpy-seeded, so the rows equal the reference's only on identical
params.

    python -m repro_torch.bench.accuracy_sweep [--steps 200] [--batch 48] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.data.radioml import generate_batch
from repro_torch.device import resolve_device
from repro_torch.models.graph import compile_snn
from repro_torch.train.lsq import lsq_fake_quant
from repro_torch.train.pruning import make_mask_pytree
from repro_torch.train.trainer import SNNTrainer, TrainerConfig

NAME = "accuracy_sweep"

SNRS = (-20.0, -10.0, 0.0, 10.0, 18.0)
DENSITIES = (1.0, 0.5, 0.25, 0.10, 0.05)


def _quant16(w: torch.Tensor) -> torch.Tensor:
    """16-bit fake-quant with the step set by the weight's own range."""
    return lsq_fake_quant(
        w, torch.clamp(w.abs().max() / (2**15 - 1), min=1e-9), 16)


def _eval(params, cfg, masks=None, quant=False, snr=10.0, n=128, seed=999,
          device=None):
    """(predictions, labels) of ``n`` fresh frames at ``snr`` dB through
    the ``dense`` backend on ``device``."""
    iq, labels, _ = generate_batch(seed, n, snr_db=snr)
    frames = torch.as_tensor(sigma_delta_encode_np(iq, cfg.timesteps))
    with torch.inference_mode():
        logits = compile_snn(cfg).apply_batch(
            params, frames, "dense", masks=masks,
            quant_fn=_quant16 if quant else None, device=device)
    return logits.argmax(-1).cpu().numpy(), labels


def run(steps: int = 200, batch: int = 48, device=None) -> dict:
    cfg = SNN_CONFIG
    dev = resolve_device(device)
    trainer = SNNTrainer(cfg, TrainerConfig(
        total_steps=steps, batch_size=batch, lr=2e-3, snr_db=10.0),
        device=dev)
    hist = trainer.run(steps)

    # Fig. 8: accuracy vs SNR (vs ground truth)
    snr_rows = []
    for snr in SNRS:
        preds, labels = _eval(trainer.params, cfg, snr=snr, device=dev)
        snr_rows.append({"snr_db": snr,
                         "accuracy": float((preds == labels).mean())})

    # Table V: retention vs the original model's predictions
    ref_preds, _ = _eval(trainer.params, cfg, snr=10.0, device=dev)
    dens_rows = []
    for d in DENSITIES:
        masks = None if d >= 1.0 else make_mask_pytree(trainer.params, d)
        preds, labels = _eval(trainer.params, cfg, masks=masks, quant=True,
                              snr=10.0, device=dev)
        dens_rows.append({
            "density": d,
            "retention_vs_original": float((preds == ref_preds).mean()),
            "accuracy_vs_labels": float((preds == labels).mean()),
        })
    return {"final_train_loss": hist["loss"][-1],
            "final_train_acc": hist["acc"][-1],
            "snr": snr_rows, "density": dens_rows, "steps": steps}


def format_table(res: dict) -> str:
    lines = [
        f"Fig. 8 / Table V accuracy (trained {res['steps']} steps; "
        f"train acc {res['final_train_acc']:.2f})",
        "  SNR sweep (vs labels):",
    ]
    for r in res["snr"]:
        lines.append(f"    {r['snr_db']:+6.0f} dB  acc {r['accuracy']:.3f}")
    lines.append("  density sweep at +10 dB (retention = agreement with "
                 "original model, paper's protocol):")
    for r in res["density"]:
        lines.append(f"    density {r['density']:.2f}  retention "
                     f"{r['retention_vs_original']:.3f}  "
                     f"acc {r['accuracy_vs_labels']:.3f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(format_table(run(args.steps, args.batch, device=args.device)))


if __name__ == "__main__":
    main()
