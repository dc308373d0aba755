"""Time launch plans of the kernels on the card.

    PYTHONPATH=src python -m repro_torch.kernels.sweep [--seed 0]
        [--kernels conv fc fused bf16 lif]

At the shapes the layer-by-layer path gives the kernels on the paper model
(batch 64, T = 8, masks at density 0.5, binary X' and spikes), it times
each conv layer's kernel over strip widths and rows per thread, and each
FC layer's kernel over batch rows and output tiles, by CUDA-graph replay
(:func:`repro_torch.kernels.timing.graph_ms`), beside ``torch.matmul`` of
the same dense product.  The whole-network kernel is timed on the served
paper model's Σ-Δ frames at batch 64 and 1 over every cluster size,
thread count and FC residency the planner can lay out.  Every plan's output is first held bit
for bit to the in-order version (the plain version for the whole-network
kernel).  Prints one JSON line per plan, the planner's own choice marked
``"default": true``.  ``--kernels bf16`` times the three bf16 forms at the
same shapes with bf16 weights: the conv over its strip widths, the FC
over its row tiles, output tiles and warps a block, each plan held bit
for bit to the plain version and printed with its ratio to
``torch.matmul`` in bf16 on the same operands (``library_ms``); then the
LIF (also alone: ``--kernels lif``) on the layer-by-layer path's layouts
(the FCs' and the convs' per-channel parameters, no v0) over every plan
of ``plan_lif_bf16_launch``, beside the f32 form and an empty kernel's
launch (the floor).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.core.sparse_format import block_sparse_from_dense
from repro_torch.kernels import goap_conv, lif_update, stream_fused, wm_fc
from repro_torch.kernels.timing import graph_ms, launch_floor_ms

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


def sweep_fused(rng, device, batches=(64, 1)):
    from repro_torch.api import (SNNConfig, compile_plan, compile_snn, init_snn,
                                 make_mask_pytree)
    from repro_torch.data.pipeline import sigma_delta_encode_batch

    cfg = SNNConfig()
    params = init_snn(0, cfg)
    plan = compile_plan(compile_snn(cfg), params,
                        masks=make_mask_pytree(params, 0.5),
                        assignment="cuda_fused", device=device)
    stack = plan.fused_stack()
    n_fc = len(cfg.fc_specs)
    for b in batches:
        iq = rng.normal(size=(b, cfg.conv_specs[0][1], cfg.input_width))
        frames = sigma_delta_encode_batch(
            torch.as_tensor(iq.astype(np.float32), device=device), cfg.timesteps)
        want = stream_fused.stream_fused_forward_ref(stack, frames)
        default = stream_fused.launch_plan(stack, b, device)
        base = dict(kernel="stream_fused_forward", batch=b)
        for c in stream_fused.CLUSTERS:
            plans = set()
            for resident in (None, (True,) * n_fc, (False,) * n_fc):
                for threads in stream_fused.THREAD_COUNTS:
                    try:
                        plans.add(stream_fused.plan_stream_fused_launch(
                            stack, b, n_sms=goap_conv._n_sms(device), cluster=c,
                            threads=threads, fc_resident=resident,
                            active_clusters=stream_fused._active_clusters))
                    except ValueError:
                        continue
            for launch in sorted(plans, key=lambda p: (p.fc_resident, p.threads)):
                got = stream_fused.stream_fused_forward(stack, frames, plan=launch)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"fused C={c} {launch.fc_resident} "
                                         "differs from the plain version")
                print(json.dumps({**base, "plan": dict(
                    cluster=launch.cluster, threads=launch.threads,
                    smem_bytes=launch.smem_bytes,
                    fc_resident=launch.fc_resident, positions=launch.positions,
                    ctas_per_sm=launch.ctas_per_sm, waves=launch.waves,
                    max_active_clusters=stream_fused.max_active_clusters(launch)),
                    "default": launch == default,
                    "ms": graph_ms(lambda: stream_fused.stream_fused_forward(
                        stack, frames, plan=launch))}))


FC_BF16_PLANS = [(rows, out_tile, split) for rows in (16, 32)
                 for out_tile in (16, 32, 64) for split in (8, 4, 2, 1)]


def sweep_bf16(rng, device):
    bf16 = torch.bfloat16
    n_sms = goap_conv._n_sms(device)
    for layer, (kw, ic, oc, w) in enumerate(CONVS):
        k = ((rng.random((kw, ic, oc)) < 0.5)
             * rng.normal(size=(kw, ic, oc))).astype(np.float32)
        bs = block_sparse_from_dense(k, block_oc=8, block_k=32)
        blocks = torch.as_tensor(bs.blocks, device=device).to(bf16)
        cols = torch.as_tensor(bs.block_cols, device=device)
        x = torch.as_tensor(rng.random((bs.padded_k, ROWS * w)) < 0.5,
                            device=device).to(bf16)
        shape = (*blocks.shape, *x.shape)
        want = goap_conv.goap_conv_block_sparse_bf16_ref(blocks, cols, x)
        dense = goap_conv.dense_of_blocks(blocks, cols, x.shape[0])
        library_ms = graph_ms(lambda: torch.matmul(dense, x))
        default = goap_conv.plan_goap_conv_bf16_launch(*shape, n_sms=n_sms)
        base = dict(kernel="goap_conv_block_sparse_bf16", layer=f"conv{layer + 1}",
                    shape=list(shape))
        for strip in goap_conv.BF16_STRIPS:
            try:
                plan = goap_conv.plan_goap_conv_bf16_launch(*shape, n_sms=n_sms,
                                                            strip=strip)
            except ValueError:
                continue
            _bf16_row(lambda: goap_conv._launch_bf16(blocks, cols, x, plan), want,
                      {**base, "plan": dataclasses.asdict(plan),
                       "default": plan == default}, library_ms)
    for layer, (din, dout) in enumerate(FCS):
        s = torch.as_tensor(rng.random((ROWS, din)) < 0.5, device=device).to(bf16)
        w = torch.as_tensor((rng.random((din, dout)) < 0.5)
                            * rng.normal(size=(din, dout)), device=device).to(bf16)
        want = wm_fc.wm_fc_matmul_bf16_ref(s, w)
        library_ms = graph_ms(lambda: torch.matmul(s, w))
        default = wm_fc.plan_wm_fc_bf16_launch(ROWS, din, dout)
        base = dict(kernel="wm_fc_matmul_bf16", layer=f"fc{layer + 1}",
                    shape=[ROWS, din, dout])
        plans = {default}
        for rows, out_tile, split in FC_BF16_PLANS:
            try:
                plans.add(wm_fc.plan_wm_fc_bf16_launch(
                    ROWS, din, dout, rows=rows, out_tile=out_tile,
                    split=min(split, default.split)))
            except ValueError:
                continue
        for plan in sorted(plans, key=dataclasses.astuple):
            _bf16_row(lambda: wm_fc._launch_bf16(s, w, plan), want,
                      {**base, "plan": dataclasses.asdict(plan),
                       "default": plan == default}, library_ms)
    sweep_lif(rng, device)


def lif_layouts():
    """(layer, T, N, C, inner) of the LIF on the layer-by-layer path at batch
    64: the FCs' (C = OUT, inner = 1; the bf16 model's served LIFs) and the
    convs' (C = OC, inner = W; f32 on the served path)."""
    fcs = [(f"fc{i + 1}", 8, 64 * dout, dout, 1) for i, (_, dout) in enumerate(FCS)]
    convs = [(f"conv{i + 1}", 8, 64 * oc * w, oc, w)
             for i, (_, _, oc, w) in enumerate(CONVS)]
    return fcs + convs


def sweep_lif(rng, device):
    """The bf16 LIF over every plan :func:`plan_lif_bf16_launch` can lay out
    on each layout (v0 None, per-channel parameters), each held bit for bit
    to the plain version; the f32 form's one launch beside it; the launch
    floor (an empty kernel) on its own line."""
    n_sms = goap_conv._n_sms(device)
    print(json.dumps({"kernel": "launch_floor", "threads": 32,
                      "ms": launch_floor_ms(device)}))
    for layer, t, n, c, inner in lif_layouts():
        cur = rng.normal(size=(t, n))
        params = (rng.uniform(0.5, 0.99, c), rng.uniform(0.5, 1.5, c),
                  rng.uniform(0.3, 1.2, c))
        base = dict(layer=layer, shape=[t, n], channels=c, inner=inner)

        def operands(dtype):
            return [torch.as_tensor(a, device=device).to(dtype)
                    for a in (cur, *params)]

        f32 = operands(torch.float32)
        got = lif_update.lif_update_fused(f32[0], None, *f32[1:], inner=inner)
        want = lif_update.lif_update_fused_ref(f32[0], None, *f32[1:], inner=inner)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"lif f32 {layer} differs from the plain version")
        print(json.dumps({"kernel": "lif_update_fused", **base,
                          "ms": graph_ms(lambda: lif_update.lif_update_fused(
                              f32[0], None, *f32[1:], inner=inner))}))
        bf = operands(torch.bfloat16)
        want = lif_update.lif_update_fused_ref(bf[0], None, *bf[1:], inner=inner)
        default = lif_update.plan_lif_bf16_launch(t, n, c, inner, n_sms)
        plans = set()
        for k in lif_update.K_CHOICES:
            for threads in lif_update.THREAD_CHOICES:
                try:
                    plans.add(lif_update.plan_lif_bf16_launch(
                        t, n, c, inner, n_sms, k=k, threads=threads))
                except ValueError:
                    continue
        for plan in sorted(plans, key=dataclasses.astuple):
            _bf16_row(lambda: lif_update._launch_bf16(bf[0], None, *bf[1:], inner,
                                                      plan),
                      want, {"kernel": "lif_update_fused_bf16", **base,
                             "plan": dataclasses.asdict(plan),
                             "default": plan == default})


def _bf16_row(run, want, row, library_ms=None):
    """Hold ``run()`` bit for bit to ``want``, then print its device ms,
    beside ``library_ms`` and the ratio of the two where there is one."""
    got = run()
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(g.view(torch.int16), w.view(torch.int16))
               for g, w in zip(outs, wants)):
        raise AssertionError(f"{row} differs from the plain version")
    ms = graph_ms(run)
    if library_ms is not None:
        row = {**row, "library": "torch.matmul bf16", "library_ms": library_ms,
               "ratio": ms / library_ms}
    print(json.dumps({**row, "ms": ms}))


SWEEPS = {"conv": sweep_conv, "fc": sweep_fc, "fused": sweep_fused,
          "bf16": sweep_bf16, "lif": sweep_lif}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", nargs="+", choices=sorted(SWEEPS),
                    default=[k for k in SWEEPS if k != "lif"])   # bf16 runs lif
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    for name in args.kernels:
        SWEEPS[name](rng, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
