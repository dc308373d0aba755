"""Pipeline-parallel production dry-run: the paper's inter-layer streaming
at pod scale.

Port of ``repro/launch/pp_dryrun.py``.  The SAOCDS accelerator streams
activations layer to layer through per-layer hardware stages (paper
§III).  This script maps the same structure onto a production pod:
llama3-8b's 32 layers become 8 pipeline stages of 4 layers on a
(stage=8, data=2, model=16) = 256-chip mesh, scheduled by the port's
:func:`~repro_torch.distributed.pipeline.spmd_pipeline` (the fixed tick
schedule with explicit bubble slots), with the TP/DP specs of
:func:`~repro_torch.distributed.sharding.partition_params` inside each
stage.

Everything runs on meta tensors.  One stage pass (4 layers on one
microbatch) is counted once with ``FlopCounterMode``; the pipeline then
runs its schedule over the 8 "meta" stages with a stage function that
charges one such pass per call, so the record's FLOPs are
``stage calls x stage pass + embedding and head``, and the number of
calls checks the schedule (``ticks x stages``).  Per-device numbers
divide by the chip count (each device runs its stage on every tick); the
collective term counts the stage-to-stage handoffs (each device sends its
sequence-sharded slice of a microbatch every tick) and the FSDP gathers
of the stage weights.

Usage: python -m repro_torch.launch.pp_dryrun [--arch llama3-8b]
Writes experiments/dryrun/pp/<arch>__prefill_pp.json.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

__all__ = ["run", "main"]


def run(arch: str = "llama3-8b", n_micro: int = 16, seq: int = 4096,
        batch: int = 32) -> dict:
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.pipeline import spmd_pipeline
    from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                                  PartitionSpec, named_tree,
                                                  partition_params)
    from repro_torch.launch.dryrun import _nbytes, _shard_bytes, param_collectives
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.steps import _param_shapes
    from repro_torch.models.layers import mask_vocab_pad, rms_norm
    from repro_torch.models.lm import _block_apply, _stack_layout, unstack
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch)
    if cfg.family != "dense":
        raise ValueError("the PP dry-run targets the dense decoder archs")
    n_stages = 8
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")
    per_stage = cfg.n_layers // n_stages
    mesh = Mesh((n_stages, 2, 16), ("stage", "data", "model"))
    chips = mesh.size
    mb = batch // n_micro

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    # parameter shapes: the layer stack regrouped (stages, per_stage, ...)
    shapes = _param_shapes(cfg, torch.bfloat16)
    (kind, _), = _stack_layout(cfg)
    stack_sd = tree_map(lambda x: meta((n_stages, per_stage)
                                       + tuple(x.shape[1:]), x.dtype),
                        shapes["stacks"][0])
    # TP specs of the inner (per_stage, ...) tree, the stage axis prepended
    inner_specs = partition_params(
        tree_map(lambda x: meta(tuple(x.shape[1:]), x.dtype), stack_sd),
        mesh, head_dim=cfg.hd)
    stack_specs = tree_map(lambda s: PartitionSpec("stage", *s), inner_specs,
                           is_leaf=lambda x: isinstance(x, PartitionSpec))
    emb_sd = shapes["emb"]
    emb_specs = partition_params(emb_sd, mesh, head_dim=cfg.hd)
    tokens = meta((n_micro, mb, seq), torch.int32)

    def stage_body(p_stage, x):
        for layer_p in unstack(p_stage, per_stage):
            x, _ = _block_apply(cfg, kind, layer_p, x, None)
        return x

    rec = {"arch": arch, "mesh": dict(mesh.shape), "n_micro": n_micro,
           "microbatch_rows": mb, "seq": seq,
           "ticks": n_micro + n_stages - 1,
           "bubble_fraction": (n_stages - 1) / (n_micro + n_stages - 1)}
    t0 = time.perf_counter()
    x_mb = meta((mb, seq, cfg.d_model), torch.bfloat16)
    one_stage = tree_map(lambda x: meta(tuple(x.shape[1:]), x.dtype), stack_sd)
    tracker = MemTracker()
    with torch.no_grad(), FlopCounterMode(display=False) as fc, tracker:
        stage_body(one_stage, x_mb)
    stage_flops = fc.get_total_flops()
    stage_peak = tracker.get_tracker_snapshot("peak").get(
        torch.device("meta"), {}).get("Total", 0)

    calls = []

    def stage_fn(p_stage, x):
        calls.append(x.shape)
        return torch.empty_like(x)          # one stage pass, charged below

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        x = emb_sd["tok"][tokens.long()]              # (n_micro, mb, S, d)
        y = spmd_pipeline(stage_fn, stack_sd, x, ["meta"] * n_stages,
                          collect="stack")
        y = rms_norm(y[:, :, -1:], shapes["final_norm"], cfg.norm_eps)
        logits = mask_vocab_pad(y @ emb_sd["unemb"], cfg)   # (n_micro, mb, 1, V)
    rec["count_s"] = round(time.perf_counter() - t0, 2)
    rec["stage_calls"] = len(calls)
    if len(calls) != rec["ticks"] * n_stages:
        raise AssertionError(f"{len(calls)} stage calls; the schedule has "
                             f"{rec['ticks']} ticks of {n_stages} stages")
    dot_flops = (len(calls) * stage_flops + fc.get_total_flops()) / chips

    stack_sh = named_tree(stack_specs, mesh)
    emb_sh = named_tree(emb_specs, mesh)
    arg_b = (_shard_bytes(stack_sd, stack_sh) + _shard_bytes(emb_sd, emb_sh)
             + _nbytes(tokens.shape, tokens.dtype))
    out_b = _shard_bytes([logits], [NamedSharding(
        mesh, PartitionSpec(None, None, None, "model"))])
    # a stage pass's temporaries, split over the stage's data x model
    stage_in = _nbytes(x_mb.shape, x_mb.dtype) + sum(
        _nbytes(t.shape, t.dtype) for t in tree_leaves(one_stage))
    temp_b = max(stage_peak - stage_in, 0) / (2 * 16)
    live = arg_b + out_b + temp_b
    rec["memory"] = {"argument_bytes": arg_b, "output_bytes": out_b,
                     "temp_bytes": temp_b, "peak_live_bytes": live,
                     "fits_80g_hbm": bool(live < HW["hbm_bytes"])}
    handoff = _nbytes((mb, seq, cfg.d_model), torch.bfloat16) / 16
    coll, wire = param_collectives(stack_sd, stack_sh, "prefill")
    coll += rec["ticks"] * handoff
    wire += rec["ticks"] * handoff
    rec["counts"] = {"dot_flops": dot_flops, "bytes_accessed": arg_b + out_b,
                     "collective_bytes": coll, "wire_bytes": wire}
    rec["terms_s"] = {
        "compute": dot_flops / HW["peak_flops_bf16"],
        "memory": (arg_b + out_b) / HW["hbm_bw"],
        "collective": coll / HW["link_bw"],
    }
    rec["ok"] = True
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--n-micro", type=int, default=16)
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    rec = run(args.arch, n_micro=args.n_micro)
    out = pathlib.Path(args.out) / "pp"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{args.arch}__prefill_pp.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    print(json.dumps({k: rec[k] for k in
                      ("arch", "ok", "ticks", "bubble_fraction", "terms_s")},
                     default=str))
    return 0 if rec.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
