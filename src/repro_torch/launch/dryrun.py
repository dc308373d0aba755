"""Multi-pod dry-run: every (arch x shape) cell on the production meshes,
counted on meta tensors, with its roofline terms.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell for 256 or 512 placeholder TPU devices and reads the compiled XLA
program.  The port has no such program, so it counts (per device, for one
step of the cell):

* **dot FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the
  cell's step run whole on meta tensors (the backward and its
  recomputation included), divided by the chip count, as if the SPMD
  partitioning split the work evenly;
* **argument / output bytes**: each leaf's shard under the cell's spec
  tree (:mod:`repro_torch.distributed.sharding`); the memory term reads
  each argument once and writes each output once, a floor;
* **collective bytes**: the parameter traffic the spec tree implies: the
  bf16 weights all-gathered over the FSDP axis for each pass (forward,
  and again for the backward's recomputation), and the f32 gradients
  reduce-scattered over it (all-reduced where a weight is not FSDP
  sharded) and all-reduced over ``pod``; ring-model wire bytes as the
  reference's HLO analysis counts them.  Activation collectives (TP
  all-reduces, sequence-parallel gathers, MoE exchanges) are not counted;
* **temporary bytes**: the peak of live tensors during the meta step
  beyond its arguments
  (``torch.distributed._tools.mem_tracker.MemTracker``), divided by the
  chip count: the layout ``act_pspec`` gives the activations when the
  batch and sequence divide the mesh.

``peak_live_bytes = argument + output + temp - alias`` (the donated
state), as the reference sums XLA's memory analysis; ``fits_80g_hbm``
holds it to :data:`~repro_torch.launch.mesh.HW`'s 80 GB.

Usage:
    # one cell (this is what the sweep spawns)
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
    # full sweep (subprocess per cell, resumable)
    python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

__all__ = ["run_cell", "count_cell", "main"]

_RESULTS_DEFAULT = "experiments/dryrun"


def _json_default(o):
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    return str(o)


def _nbytes(shape, dtype) -> int:
    import torch

    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _shard_bytes(tree, shardings) -> int:
    """Per-device bytes of ``tree``'s leaves under their shardings."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(tree)
    shards = tree_leaves(shardings,
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    if len(leaves) != len(shards):
        raise ValueError(f"{len(leaves)} leaves for {len(shards)} shardings")
    return sum(_nbytes(s.shard_shape(t.shape), t.dtype)
               for t, s in zip(leaves, shards))


def _ring(kind: str, r: float, g: int) -> float:
    """Ring-model wire bytes of a collective returning ``r`` bytes over a
    group of ``g`` (the reference's ``hlo_analysis`` model)."""
    if g <= 1:
        return 0.0
    return {"all-gather": r * (g - 1) / g, "all-reduce": 2 * r * (g - 1) / g,
            "reduce-scatter": r * (g - 1)}[kind]


def param_collectives(params, param_shardings, kind: str):
    """(collective bytes, wire bytes) per device per step of the parameter
    traffic the specs imply (see the module docstring)."""
    import torch

    from repro_torch.distributed.sharding import NamedSharding, _axis_size
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    shards = tree_leaves(param_shardings,
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    coll = wire = 0.0
    for p, s in zip(leaves, shards):
        mesh, spec = s.mesh, tuple(s.spec)
        axes = {a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        model_n = _axis_size(mesh, "model") if "model" in axes else 1
        data_n = mesh.shape.get("data", 1)
        pod_n = mesh.shape.get("pod", 1)
        fsdp = "data" in axes
        gathered = _nbytes(p.shape, torch.bfloat16) / model_n
        if fsdp:
            passes = 2 if kind == "train" else 1
            coll += passes * gathered
            wire += passes * _ring("all-gather", gathered, data_n)
        if kind != "train":
            continue
        grad = _nbytes(p.shape, torch.float32) / model_n
        if fsdp:
            shard = grad / data_n
            coll += shard
            wire += _ring("reduce-scatter", shard, data_n)
            dp_rest = pod_n
        else:
            shard = grad
            dp_rest = data_n * pod_n
        if dp_rest > 1:
            coll += shard
            wire += _ring("all-reduce", shard, dp_rest)
    return coll, wire


def count_cell(plan):
    """Run ``plan``'s step on its meta arguments: (CellCounts, memory
    record) per device."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import HW
    from repro_torch.launch.roofline import CellCounts
    from repro_torch.tree import tree_leaves

    chips = plan.mesh.size
    grad = torch.enable_grad() if plan.kind == "train" else torch.no_grad()
    tracker = MemTracker()
    with grad, FlopCounterMode(display=False) as flops, tracker:
        out = plan.fn(*plan.args)
    peak = max(tracker.get_tracker_snapshot("peak")
               .get(torch.device("meta"), {}).get("Total", 0), 0)
    args_global = sum(_nbytes(t.shape, t.dtype) for t in tree_leaves(plan.args))
    arg_b = sum(_shard_bytes(a, s) for a, s in zip(plan.args,
                                                   plan.in_shardings))
    out_b = sum(_shard_bytes(o, s) for o, s in zip(out, plan.out_shardings))
    alias_b = sum(_shard_bytes(plan.args[i], plan.in_shardings[i])
                  for i in plan.donate_argnums)
    temp_b = max(peak - args_global, 0) / chips
    params = plan.args[0]["params"] if plan.kind == "train" else plan.args[0]
    param_sh = (plan.in_shardings[0]["params"] if plan.kind == "train"
                else plan.in_shardings[0])
    coll, wire = param_collectives(params, param_sh, plan.kind)
    counts = CellCounts(dot_flops=flops.get_total_flops() / chips,
                        bytes_accessed=float(arg_b + out_b),
                        collective_bytes=coll, wire_bytes=wire)
    live = arg_b + out_b + temp_b - alias_b
    memory = {"argument_bytes": arg_b, "output_bytes": out_b,
              "temp_bytes": temp_b, "alias_bytes": alias_b,
              "peak_live_bytes": live,
              "fits_80g_hbm": bool(live < HW["hbm_bytes"])}
    return counts, memory


def run_cell(arch: str, shape: str, mesh_kind: str,
             kv_int8: bool = False) -> dict:
    """Build and count one cell on one production mesh; the record."""
    import torch

    from repro_torch.configs.registry import SHAPES, cell_applicable, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.launch.steps import build_cell

    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "torch": torch.__version__, "ok": False}
    ok, why = cell_applicable(arch, shape)
    if not ok:
        rec.update(skipped=True, reason=why, ok=True)
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size
    rec["chips"] = chips
    rec["mesh_shape"] = dict(mesh.shape)
    rec["kv_int8"] = kv_int8
    t0 = time.perf_counter()
    plan = build_cell(arch, shape, mesh, kv_int8=kv_int8)
    rec["build_s"] = round(time.perf_counter() - t0, 2)
    t1 = time.perf_counter()
    counts, rec["memory"] = count_cell(plan)
    rec["count_s"] = round(time.perf_counter() - t1, 2)
    rec["counts"] = dataclasses.asdict(counts)
    rec["roofline"] = roofline_terms(get_config(arch), SHAPES[shape], counts,
                                     chips)
    rec["ok"] = True
    return rec


def _cell_path(out: pathlib.Path, mesh: str, arch: str, shape: str) -> pathlib.Path:
    return out / mesh / f"{arch}__{shape}.json"


def _sweep(out: pathlib.Path, meshes, timeout: int, force: bool) -> int:
    from repro_torch.configs.registry import all_cells

    src = str(pathlib.Path(__file__).resolve().parents[2])
    failures = 0
    todo = []
    for mesh in meshes:
        for arch, shape, ok, why in all_cells():
            todo.append((mesh, arch, shape, ok, why))
    print(f"sweep: {len(todo)} cells -> {out}")
    for i, (mesh, arch, shape, ok, why) in enumerate(todo):
        path = _cell_path(out, mesh, arch, shape)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.exists() and not force:
            continue
        if not ok:
            path.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh,
                "ok": True, "skipped": True, "reason": why,
            }, indent=1))
            continue
        print(f"[{i + 1}/{len(todo)}] {mesh:6s} {arch} x {shape} ...",
              flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, "--mesh", mesh,
             "--out", str(out)],
            capture_output=True, text=True, timeout=timeout,
            env={**os.environ, "PYTHONPATH": src},
        )
        dt = time.perf_counter() - t0
        if proc.returncode != 0 or not path.exists():
            failures += 1
            path.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                "error": proc.stderr[-4000:], "wall_s": round(dt, 1),
            }, indent=1))
            last = proc.stderr.strip().splitlines()[-1][:200] \
                if proc.stderr.strip() else "no stderr"
            print(f"    FAILED ({dt:.0f}s): {last}")
        else:
            rec = json.loads(path.read_text())
            r = rec.get("roofline", {})
            print(f"    ok ({dt:.0f}s) bottleneck={r.get('bottleneck')} "
                  f"terms={ {k: f'{v:.2e}' for k, v in r.get('terms_s', {}).items()} }")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="sweep every cell in subprocesses")
    ap.add_argument("--out", default=_RESULTS_DEFAULT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--kv-int8", action="store_true",
                    help="decode cells: int8-quantized KV cache")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    if args.all:
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        return 1 if _sweep(out, meshes, args.timeout, args.force) else 0

    if not (args.arch and args.shape and args.mesh in ("single", "multi")):
        ap.error("one cell needs --arch, --shape and --mesh single|multi")
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, kv_int8=args.kv_int8)
    except Exception:
        rec = {
            "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
            "ok": False, "error": traceback.format_exc()[-4000:],
        }
    path = _cell_path(out, args.mesh, args.arch, args.shape)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=_json_default))
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "ok") if k in rec}))
    if not rec.get("ok"):
        print(rec.get("error", ""), file=sys.stderr)
    return 0 if rec.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
