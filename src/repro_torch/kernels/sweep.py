"""Time launch plans of the conv and FC kernels on the card.

    PYTHONPATH=src python -m repro_torch.kernels.sweep [--seed 0]

At the shapes the layer-by-layer path gives the kernels on the paper model
(batch 64, T = 8, masks at density 0.5, binary X' and spikes), it times
each conv layer's kernel over strip widths and rows per thread, and each
FC layer's kernel over batch rows and output tiles, by CUDA-graph replay
(:func:`repro_torch.kernels.timing.graph_ms`), beside ``torch.matmul`` of
the same dense product.  Every plan's output is first held bit for bit to
the in-order version.  Prints one JSON line per plan, the planner's own
choice marked ``"default": true``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.core.sparse_format import block_sparse_from_dense
from repro_torch.kernels import goap_conv, wm_fc
from repro_torch.kernels.timing import graph_ms

# (kw, ic, oc, W) of the paper's convs and (IN, OUT) of its FCs
CONVS = [(11, 2, 16, 128), (11, 16, 32, 64), (5, 32, 64, 32)]
FCS = [(1024, 128), (128, 11)]
ROWS = 64 * 8            # batch 64 x T 8, folded by the layer-by-layer path
STRIPS = (32, 64, 128, 256)
ROWS_PER_THREAD = (8, 4, 2)
FC_TILES = ((8, 32), (16, 32), (32, 32), (16, 16), (32, 16), (8, 64),
            (16, 64), (8, 128))


def sweep_conv(rng, device):
    for layer, (kw, ic, oc, w) in enumerate(CONVS):
        k = ((rng.random((kw, ic, oc)) < 0.5)
             * rng.normal(size=(kw, ic, oc))).astype(np.float32)
        bs = block_sparse_from_dense(k, block_oc=8, block_k=32)
        blocks = torch.as_tensor(bs.blocks, device=device)
        cols = torch.as_tensor(bs.block_cols, device=device)
        x = torch.as_tensor((rng.random((bs.padded_k, ROWS * w)) < 0.5)
                            .astype(np.float32), device=device)
        shape = (*blocks.shape, x.shape[0], x.shape[1])
        want = goap_conv.goap_conv_block_sparse_inorder(blocks, cols, x)
        dense = goap_conv.dense_of_blocks(blocks, cols, x.shape[0])
        base = dict(kernel="goap_conv_block_sparse", layer=f"conv{layer + 1}",
                    shape=list(shape))
        print(json.dumps({**base, "library": "torch.matmul",
                          "ms": graph_ms(lambda: torch.matmul(dense, x))}))
        n_sms = goap_conv._n_sms(device)
        default = goap_conv.plan_goap_conv_launch(*shape, n_sms=n_sms)
        for strip in STRIPS:
            for rb in ROWS_PER_THREAD:
                try:
                    plan = goap_conv.plan_goap_conv_launch(
                        *shape, n_sms=n_sms, strip=strip, rows_per_thread=rb)
                except ValueError:
                    continue
                got = goap_conv._launch(blocks, cols, x, plan)
                if not torch.equal(got, want):
                    raise AssertionError(f"conv{layer + 1} {plan} differs "
                                         "from the in-order version")
                print(json.dumps({**base, "plan": dataclasses.asdict(plan),
                                  "default": plan == default,
                                  "ms": graph_ms(lambda: goap_conv._launch(
                                      blocks, cols, x, plan))}))


def sweep_fc(rng, device):
    for layer, (din, dout) in enumerate(FCS):
        s = torch.as_tensor((rng.random((ROWS, din)) < 0.5).astype(np.float32),
                            device=device)
        w = torch.as_tensor(((rng.random((din, dout)) < 0.5)
                             * rng.normal(size=(din, dout))).astype(np.float32),
                            device=device)
        want = wm_fc.wm_fc_matmul_inorder(s, w)
        base = dict(kernel="wm_fc_matmul", layer=f"fc{layer + 1}",
                    shape=[ROWS, din, dout])
        print(json.dumps({**base, "library": "torch.matmul",
                          "ms": graph_ms(lambda: torch.matmul(s, w))}))
        default = wm_fc.plan_wm_fc_launch(ROWS, din, dout)
        for rows, out_tile in FC_TILES:
            try:
                plan = wm_fc.plan_wm_fc_launch(ROWS, din, dout, rows=rows,
                                               out_tile=out_tile)
            except ValueError:
                continue
            got = wm_fc._launch(s, w, plan)
            if not torch.equal(got, want):
                raise AssertionError(f"fc{layer + 1} {plan} differs from the "
                                     "in-order version")
            print(json.dumps({**base, "plan": dataclasses.asdict(plan),
                              "default": plan == default,
                              "ms": graph_ms(lambda: wm_fc._launch(s, w, plan))}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    sweep_conv(rng, device)
    sweep_fc(rng, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
