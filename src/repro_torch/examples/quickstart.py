"""Quickstart: the paper's pipeline through the unified SNNProgram API.

Port of ``examples/quickstart.py``:

1. generate synthetic RadioML I/Q frames,
2. Σ-Δ encode them into binary spike frames,
3. compile the SNNConfig into an ``SNNProgram`` (one model definition),
4. run it through interchangeable execution backends — ``dense``
   (training oracle), ``goap`` (the accelerator's sparsity-aware
   dataflow), and ``stream`` (the faithful Algorithm-2 emulator with the
   paper's iteration counters),
5. verify all backends agree and report the paper's event counts.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.api import compile_plan, compile_snn, init_snn, stream_totals
from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.core.cost_model import bits_fetched, goap_conv_counts, sw_conv_counts
from repro_torch.core.saocds import pad_same
from repro_torch.core.sparse_format import coo_from_dense
from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.data.radioml import MODULATIONS, generate_batch
from repro_torch.device import resolve_device
from repro_torch.train.pruning import make_mask_pytree

__all__ = ["main", "run"]


def run(args) -> dict:
    """The quickstart on ``args.device``; returns what it reports."""
    dev = resolve_device(args.device)
    cfg = SNN_CONFIG
    program = compile_snn(cfg)
    print(f"SNN: convs {cfg.conv_specs}, FCs {cfg.fc_specs}, "
          f"T={cfg.timesteps} timesteps, {len(MODULATIONS)} classes")
    print("layer graph:", " -> ".join(s.name for s in program.layers))

    # 1-2. data -> spikes
    iq, labels, snrs = generate_batch(seed=0, batch=8, snr_db=10.0)
    frames = sigma_delta_encode_np(iq, cfg.timesteps)     # (B, T, 2, 128)
    print(f"I/Q {iq.shape} -> spike frames {frames.shape} "
          f"(density {frames.mean():.2f})")
    frames_d = torch.as_tensor(frames, device=dev)

    # 3. dense forward (the differentiable training backend)
    params = init_snn(0, cfg)
    dense_logits = program.apply_batch(params, frames_d, "dense", device=dev)

    # 4. prune to 50%; the same program now runs the accelerator dataflow
    masks = make_mask_pytree(params, 0.5)
    masked_logits = program.apply_batch(params, frames_d, "dense",
                                        masks=masks, device=dev)
    goap_logits = program.apply_batch(params, frames_d, "goap", masks=masks,
                                      device=dev)

    # 5. every backend computes exactly the masked dense result
    err = float((goap_logits - masked_logits).abs().max())
    print(f"GOAP backend == masked dense backend: max err {err:.2e}")
    assert err < 1e-3

    # the streaming emulator returns the paper's Tables I/III counters
    _, counters = program.apply(params, frames_d[0], "stream", masks=masks,
                                return_counters=True, device=dev)
    totals = stream_totals(counters)
    print(f"stream schedule: {totals['compute_iters']} compute + "
          f"{totals['extra_iters']} extra + {totals['empty_iters']} empty "
          f"iterations/timestep, {float(totals['accumulations']):.0f} gated "
          f"accumulations for one sample")

    # 6. the plan compiler precomputes every bind-time artifact once into
    # a content-hashed ExecutionPlan; its fused streaming executor threads
    # all layers through one loop over timesteps — the software form of the
    # paper's control-free inter-layer pipeline (§III-C.4).  Layers can
    # even mix backends per layer:
    plan = compile_plan(program, params, masks=masks,
                        assignment={"conv1": "goap"}, default_backend="dense",
                        device=dev)
    fused_logits, _ = plan.run_streaming(frames_d[0])
    err_fused = float((fused_logits - goap_logits[0]).abs().max())
    print(f"fused streaming plan {plan.digest[:12]}… "
          f"(assignment {plan.assignment}): max err vs layer-by-layer "
          f"{err_fused:.2e}")
    assert compile_plan(program, params, masks=masks,
                        assignment={"conv1": "goap"},
                        default_backend="dense", device=dev) is plan  # cache hit

    # paper Table I-style counts on this batch's first conv layer
    kw, ic, oc = cfg.conv_specs[0]
    coo = coo_from_dense((params["conv"][0]["w"] * masks["conv"][0]).numpy())
    f0 = pad_same(torch.as_tensor(frames[0]), coo.kw).numpy()
    sw = sw_conv_counts(f0, (kw, ic, oc))
    gp = goap_conv_counts(f0, coo)
    print(f"layer-1 events for one sample: SW accum={sw.accumulations} "
          f"bits={bits_fetched(sw)}  vs  GOAP accum={gp.accumulations} "
          f"bits={bits_fetched(gp)} "
          f"({bits_fetched(gp) / bits_fetched(sw) * 100:.1f}% traffic)")
    preds = goap_logits.argmax(-1).cpu().numpy()
    print("predictions:", preds)
    return {"params": params, "masks": masks, "frames": frames,
            "dense_logits": dense_logits.cpu().numpy(),
            "goap_logits": goap_logits.cpu().numpy(), "goap_err": err,
            "fused_err": err_fused, "stream_totals": {
                k: float(v) for k, v in totals.items()},
            "sw": sw, "goap": gp, "predictions": preds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
