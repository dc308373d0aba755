"""Paper Table III: accumulation-count ratio vs spatial sparsity, L1-L4.

Port of ``benchmarks/table3_accum_ratio.py``.  Stream the same Σ-Δ
encoded RadioML frames through the network; per layer, count GOAP
accumulations with the kernel pruned to each density and report the
ratio to the dense count.  The paper finds the ratio tracks
(1 - sparsity) within ~1%: spatial sparsity converts one for one into
skipped accumulations, because an enable map's length does not depend on
which weights survive.  Layer 5 (FC2, 128x11) is excluded as in the
paper.

The conv stack streams on ``device`` (the card unless ``--device cpu``);
the counting is numpy.  The init is numpy-seeded (the reference's is a
jax key), so the rows equal the reference's only on identical weights.

    python -m repro_torch.bench.table3_accum_ratio [--n-samples 16] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.core.saocds import max_pool_spikes, pad_same, saocds_conv_layer
from repro_torch.core.sparse_format import coo_from_dense
from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.data.radioml import generate_batch
from repro_torch.device import resolve_device
from repro_torch.models.snn import init_snn

NAME = "table3_accum_ratio"

SPARSITIES = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
PAPER_TABLE3 = {  # sparsity -> ratios for L1..L4 (percent)
    0.0: (100.00, 100.00, 100.00, 100.00),
    0.1: (89.70, 89.73, 89.74, 90.00),
    0.2: (79.83, 79.96, 79.95, 79.96),
    0.3: (69.80, 69.65, 70.02, 70.13),
    0.4: (59.87, 59.92, 59.77, 59.85),
    0.5: (49.85, 49.91, 49.80, 50.10),
    0.6: (39.74, 39.03, 40.19, 40.14),
    0.7: (29.80, 30.39, 29.47, 29.97),
    0.8: (20.01, 19.72, 20.02, 20.07),
    0.9: (9.89, 9.44, 10.14, 9.79),
}


def _window_sums(frames: np.ndarray, kw: int) -> np.ndarray:
    """frames (N, IC, WIpad) -> P[N, IC, KW] where P[n, ic, ci] = number of
    ones in the enable map of a weight at (ic, ci)."""
    n, ic, wip = frames.shape
    oi = wip - kw + 1
    cs = np.concatenate(
        [np.zeros((n, ic, 1), frames.dtype), np.cumsum(frames, axis=2)], axis=2
    )
    return np.stack([cs[:, :, ci + oi] - cs[:, :, ci] for ci in range(kw)], axis=2)


def _prune_mask(w: np.ndarray, sparsity: float, rng) -> np.ndarray:
    """L1-magnitude pruning mask at the requested sparsity (``rng`` is
    unused, as in the reference)."""
    flat = np.abs(w).ravel()
    k = int(round(sparsity * flat.size))
    if k == 0:
        return np.ones_like(w, dtype=bool)
    thresh = np.partition(flat, k - 1)[k - 1]
    return np.abs(w) > thresh


def run(n_samples: int = 16, seed: int = 0, device=None) -> dict:
    cfg = SNN_CONFIG
    dev = resolve_device(device)
    params = init_snn(seed, cfg)
    iq, _, _ = generate_batch(seed, n_samples, snr_db=10.0)
    frames = sigma_delta_encode_np(iq, cfg.timesteps)
    # flatten (B, T) into one stream of (IC, W) frames, propagated DENSE
    stream = frames.reshape(-1, *frames.shape[2:]).astype(np.float32)

    rng = np.random.default_rng(seed)
    layer_inputs = []        # per conv layer: padded input frames (N, IC, WIpad)
    x = torch.as_tensor(stream, device=dev)
    with torch.inference_mode():
        for layer in params["conv"]:
            w = layer["w"].detach().cpu().numpy()
            padded = pad_same(x, w.shape[0])
            layer_inputs.append(padded.cpu().numpy())
            out, _ = saocds_conv_layer(padded, coo_from_dense(w),
                                       layer["lif"].to(dev))
            x = max_pool_spikes(out, cfg.pool)
        fc_input = x.reshape(x.shape[0], -1).cpu().numpy()  # (N, 1024)

    ratios = {s: [] for s in SPARSITIES}
    for li, layer in enumerate(params["conv"]):
        w = layer["w"].detach().cpu().numpy()
        kw = w.shape[0]
        # em[ic, ci] = total ones inside the enable map of a weight at
        # (ic, ci), summed over the whole frame stream
        em = _window_sums(layer_inputs[li], kw).sum(axis=0)   # (IC, KW)
        dense = float(em.sum() * w.shape[2])                  # every slot x OC
        for s in SPARSITIES:
            keep = _prune_mask(w, s, rng)                     # (KW, IC, OC)
            accum = float((keep * em.T[:, :, None]).sum())
            ratios[s].append(accum / dense)

    # L4 = FC1 with the weight-mask method: accum = sum over active inputs
    # of surviving weights in their rows
    w_fc = params["fc"][0]["w"].detach().cpu().numpy()      # (1024, 128)
    act_counts = fc_input.sum(axis=0)                        # per-input activations
    dense_fc = float((act_counts[:, None] * np.ones_like(w_fc)).sum())
    for s in SPARSITIES:
        keep = _prune_mask(w_fc, s, rng)
        accum = float((act_counts[:, None] * keep).sum())
        ratios[s].append(accum / dense_fc)

    rows = []
    for s in SPARSITIES:
        got = [r * 100 for r in ratios[s]]
        rows.append({
            "sparsity": s,
            "ratios_pct": got,
            "paper_pct": PAPER_TABLE3[s],
            "max_err_vs_linear": max(abs(g - (1 - s) * 100) for g in got),
        })
    return {"rows": rows, "n_frames": int(stream.shape[0])}


def format_table(res: dict) -> str:
    lines = [
        f"Table III — accumulation ratio vs spatial sparsity "
        f"({res['n_frames']} frames; paper row in [])",
        f"  {'sparsity':>8s} {'L1':>7s} {'L2':>7s} {'L3':>7s} {'L4':>7s}"
        f"   {'max |err| vs (1-s)':>18s}",
    ]
    for r in res["rows"]:
        got = "".join(f"{g:7.2f}" for g in r["ratios_pct"])
        pap = "/".join(f"{p:.1f}" for p in r["paper_pct"])
        lines.append(f"  {r['sparsity']:8.1f}{got}   "
                     f"{r['max_err_vs_linear']:6.2f}%   [{pap}]")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-samples", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(format_table(run(args.n_samples, args.seed, device=args.device)))


if __name__ == "__main__":
    main()
