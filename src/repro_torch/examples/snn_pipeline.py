"""The paper's inter-layer streaming as pipeline parallelism.

Port of ``examples/snn_pipeline.py``.  The SAOCDS accelerator instantiates
each SNN layer as its own hardware stage with activations streamed stage
to stage (paper §III).  This example maps that structure onto devices: a
4-stage :func:`~repro_torch.distributed.pipeline.spmd_pipeline` (conv1 |
conv2 | conv3 | FC head) where microbatches of spike frames flow from
stage to stage on a fixed tick schedule — bubbles included as explicit
no-op slots, the paper's precomputed empty/extra iterations.

Every stage is built from the same shared ``LayerSpec`` graph that the
single-device forward executes (``compile_snn`` -> ``SNNProgram``): the
pipeline partitions the graph (``conv_block(i)`` / ``head_layers()``) and
runs each slice through the ``dense`` backend — no layer is re-implemented
here.  The stages run on four cards when four are present, else on one
card four times (each stage on a CUDA stream of its own), or on the CPU
with ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.snn_pipeline [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.api import compile_snn, init_snn
from repro_torch.configs.saocds_amc import CONFIG as SNN_CONFIG
from repro_torch.data.pipeline import sigma_delta_encode_np
from repro_torch.data.radioml import generate_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.pipeline import (spmd_pipeline, stack_stage_params,
                                              stage_index)

__all__ = ["main", "pipeline_logits", "run", "stage_devices"]

N_STAGES = 4


def stage_devices(device: torch.device):
    """Every local card when there are at least four, else ``device`` four
    times."""
    if device.type == "cuda" and torch.cuda.device_count() >= N_STAGES:
        return [torch.device("cuda", i) for i in range(N_STAGES)]
    return [device] * N_STAGES


def pipeline_logits(cfg, params, frames: np.ndarray, devices) -> torch.Tensor:
    """(n_micro, T, 2, W) spike frames, one microbatch a frame, through the
    4-stage pipeline on ``devices`` -> (n_micro, n_classes) logits."""
    program = compile_snn(cfg)

    # heterogeneous stages share one fixed-width buffer — the software
    # analogue of the accelerator's fixed inter-layer stream width.
    # buffer: (T, C_max, W_max) with C_max=64, W_max=128
    t, cmax, wmax = cfg.timesteps, 64, cfg.input_width

    def conv_stage(li):
        # the (Conv1dLIF, MaxPool) slice of the shared layer graph
        block = program.conv_block(li)
        conv = block[0]
        w_in = cfg.input_width // (cfg.pool ** li)

        def fn(p, buf):   # buf (T, Cmax, Wmax)
            x = buf[:, : conv.ic, : w_in]
            out = program.run_layers(block, p, x, device=buf.device)
            pad_c, pad_w = cmax - out.shape[1], wmax - out.shape[2]
            return torch.nn.functional.pad(out, (0, pad_w, 0, pad_c))

        return fn

    def head_stage(p, buf):
        # FC1 -> FC2 -> readout slice of the same graph
        w_in = cfg.input_width // (cfg.pool ** len(cfg.conv_specs))
        x = buf[:, : cfg.conv_specs[-1][2], : w_in]
        logits = program.run_layers(program.head_layers(), p, x,
                                    device=buf.device)
        out = torch.zeros((t, cmax, wmax), dtype=torch.float32,
                          device=buf.device)
        out[0, 0, : cfg.n_classes] = logits
        return out

    stages = [conv_stage(0), conv_stage(1), conv_stage(2), head_stage]

    def stage_fn(stage_params, buf):
        # each stage runs its own slice (the reference selects among all
        # four by jax.lax.axis_index)
        return stages[stage_index()](stage_params, buf)

    mbs = torch.as_tensor(np.pad(
        frames, ((0, 0), (0, 0), (0, cmax - frames.shape[2]), (0, 0))),
        device=devices[0])                                    # fixed buffer
    # every stage holds the FULL param tree here (stage_fn selects); a
    # stacked per-stage tree is the memory-lean option for big models
    stacked = stack_stage_params([params] * N_STAGES)
    out = spmd_pipeline(stage_fn, stacked, mbs, devices)
    return out[:, 0, 0, : cfg.n_classes]


def run(args) -> dict:
    """The 4-stage pipeline against the single-device ``dense`` forward on
    ``args.device``; returns both logits, the error and the seconds."""
    dev = resolve_device(args.device)
    cfg = SNN_CONFIG
    params = init_snn(0, cfg)
    devices = stage_devices(dev)

    # data: 8 microbatches of one sample each
    iq, labels, _ = generate_batch(seed=7, batch=8, snr_db=10.0)
    frames = sigma_delta_encode_np(iq, cfg.timesteps).astype(np.float32)

    t0 = time.perf_counter()
    pipe_logits = pipeline_logits(cfg, params, frames, devices).cpu().numpy()
    seconds = time.perf_counter() - t0

    ref_logits = compile_snn(cfg).apply_batch(params, frames, "dense",
                                              device=dev).cpu().numpy()
    err = float(np.abs(pipe_logits - ref_logits).max())
    print(f"4-stage pipeline vs single-device forward: max err {err:.2e}")
    assert err < 1e-3
    print(f"ticks executed: {8 + N_STAGES - 1} (8 microbatches + 3 bubble "
          f"slots, the paper's precomputed schedule) on "
          f"{[str(d) for d in devices]} in {seconds:.3f} s")
    print("predictions:", pipe_logits.argmax(-1), "labels:", labels)
    return {"params": params, "frames": frames, "pipe_logits": pipe_logits,
            "ref_logits": ref_logits, "max_err": err, "seconds": seconds,
            "devices": [str(d) for d in devices]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
