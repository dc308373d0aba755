#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold it to itself.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the repository's ``src/`` beside this
file; exits non-zero without them.  In order, it

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` and prints the
   seconds and ``ptxas``'s register/spill report;
3. turns TF32 off for matmul and cuDNN and asserts it;
4. holds every kernel against its plain PyTorch version on the card, at
   the shapes the served paper model gives it (``SNNConfig()``, masks at
   density 0.5, batch 64): logits and currents within 1e-5, spikes and
   counters exactly; the whole-network kernel's logits bit for bit, at
   batch 64 in both input modes and at batch 1.  The per-layer kernels are checked on every call the
   plan's layer-by-layer path makes, on the operands that path gives them,
   and the conv and FC kernels must also equal an in-order eager version
   of their arithmetic bit for bit;
5. runs the main path's two paths, each with every launch count set to 0
   just before it and read just after: an
   ``AsyncAMCServeEngine(backend="cuda_fused")`` answers 256 submitted
   requests, which must launch the whole-network kernel and nothing else;
   then the same plan runs one batch layer by layer, which must launch
   each per-layer kernel and not the whole-network one.  The engine's
   predictions must equal the plain-torch ``goap`` backend's on the
   card; the layer-by-layer logits must equal the fused kernel's exactly
   and give the ``goap`` backend's predictions;
6. times each kernel's device time (``ms``) and that of the one PyTorch
   call that computes the same function (``library_ms``) the same way (the
   whole-network kernel also at batch 1, ``ms_batch1``, each beside the
   thread-block-cluster launch the planner chose, ``plan``): 20
   back-to-back calls captured into one CUDA graph, replayed 10 times
   between two CUDA events, the median replay divided by 20; beside them
   a single
   call between two events (``call_ms``, host work included), the plain
   version the same way (``plain_ms``) and the bound.  It then splits one
   served batch's step (host to host) into its Σ-Δ encode and its fused
   kernel, and times one layer-by-layer batch host to host beside the
   sum of its kernels' ``ms``;
7. prints one JSON line of per-kernel results, and last
   ``{"ok": true, "device": {...}}``.

Any mismatch or exception ends the run with a non-zero exit code.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
import typing

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet).  The 67 TFLOP/s f32 rate of the CUDA
# cores counts a fused multiply-add as two operations; the kernels here do
# separate adds, multiplies and compares, one f32 instruction each, so their
# operations peak at half that rate.
PEAK_F32_INSTRUCTIONS = 67e12 / 2
PEAK_BYTES = 3.35e12
BATCH = 64
REQUESTS = 256
SEED = 0
DENSITY = 0.5
ATOL = 1e-5


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_timer(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median host-to-host milliseconds of ``fn(); torch.cuda.synchronize()``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32_INSTRUCTIONS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Check:
    """Collects per-call comparisons of a kernel against its plain version."""

    def __init__(self, name: str):
        self.name = name
        self.max_abs_err = 0.0
        self.inorder_max_abs_err = None

    def equal(self, got, want, what: str) -> None:
        """Bit-for-bit equality with the in-order version."""
        import torch

        if got.shape != want.shape or not torch.equal(got, want):
            err = (float((got - want).abs().max())
                   if got.shape == want.shape else float("inf"))
            raise AssertionError(f"{self.name} {what}: not bit-equal to the "
                                 f"in-order version (max |err| {err})")
        self.inorder_max_abs_err = 0.0
        print(f"  {self.name} {what}: bit-equal to the in-order version")

    def close(self, got, want, atol: float, what: str) -> None:
        import torch

        if got.shape != want.shape:
            raise AssertionError(f"{self.name} {what}: shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{self.name} {what}: non-finite output")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        if err > atol:
            raise AssertionError(f"{self.name} {what}: max |err| {err} > {atol}")
        print(f"  {self.name} {what}: max |err| {err:.3e} (atol {atol})")


class Timers(typing.NamedTuple):
    """The three clocks of a run (``repro_torch.kernels.timing``'s on the
    card, host stand-ins when rehearsing on a CPU)."""
    call: typing.Callable      # one call between CUDA events (call_ms)
    graph: typing.Callable     # device time per call, CUDA-graph replay (ms)
    host: typing.Callable      # host to host, ending in a synchronise


def check_kernels(plan, iq, frames_b, timers):
    """Phase 4 and 6: each kernel against its plain version, then timed.

    ``ms`` and ``library_ms`` are device times by CUDA-graph replay;
    ``call_ms`` and ``plain_ms`` are single calls between CUDA events,
    host work included (the plain versions are host-driven loops).
    Returns per-kernel rows (without launch counts)."""
    import torch

    from repro_torch.core.encoder import normalize_iq
    from repro_torch.kernels import stream_fused_forward, stream_fused_forward_ref

    stack = plan.fused_stack()
    analog = normalize_iq(iq)
    rows = []

    # -- stream_fused_forward, both input modes, at the served batch and at
    #    batch 1 (the lone-request bucket), each with the planner's launch --
    chk = Check("stream_fused_forward")
    work = {}
    for encode, x in ((False, frames_b), (True, analog), (False, frames_b[:1])):
        got_l, got_a = stream_fused_forward(stack, x, encode=encode)
        want_l, want_a = stream_fused_forward_ref(
            stack, x, encode=encode,
            work=work if x is frames_b and not encode else None)
        torch.cuda.synchronize()
        what = f"encode={encode} batch {x.shape[0]}"
        chk.close(got_l, want_l, ATOL, f"logits {what}")
        chk.close(got_a, want_a, 0.0, f"conv_accs {what}")
        n_same = int((got_l == want_l).all(-1).sum())
        print(f"  stream_fused_forward {what}: {n_same}/{x.shape[0]} "
              "samples with bit-equal logits")
        if n_same != x.shape[0]:
            raise AssertionError(f"stream_fused_forward {what}: logits not "
                                 "bit-equal to the plain version")
    operands = [frames_b]
    for layer in stack.layers:
        for f in ("w_cm", "counts", "lif", "w"):
            if hasattr(layer, f):
                operands.append(torch.as_tensor(getattr(layer, f)))
    n_b = nbytes(*operands) + 4 * frames_b.shape[0] * (stack.n_classes + stack.n_convs)
    n_ops = work["conv_adds"] + work["fc_adds"] + 4 * work["lif_updates"]
    b_ms, b_by = bound_ms(n_b, n_ops)
    one = frames_b[:1]
    rows.append(dict(
        name="stream_fused_forward", route="cuda",
        source="src/repro_torch/csrc/stream_fused.cu",
        replaces="src/repro/kernels/stream_fused.py:210",
        max_abs_err=chk.max_abs_err,
        ms=timers.graph(lambda: stream_fused_forward(stack, frames_b)),
        call_ms=timers.call(lambda: stream_fused_forward(stack, frames_b)),
        plain_ms=timers.call(lambda: stream_fused_forward_ref(stack, frames_b)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        plan=fused_plan(stack, frames_b),
        ms_batch1=timers.graph(lambda: stream_fused_forward(stack, one)),
        plan_batch1=fused_plan(stack, one)))

    # -- the per-layer kernels, on the plan's layer-by-layer path ----------
    checks, calls = check_per_layer(plan, frames_b)
    for name, kernel in PER_LAYER.items():
        plain = _plain(name)
        records = calls[name]
        b_ms, b_by = bound_ms(sum(c["bytes"] for c in records),
                              sum(c["ops"] for c in records))

        def total(clock, fn_of):
            return sum(clock(fn_of(c)) for c in records)

        def launch(c):
            return lambda: _kernel(name)(*c["args"], **c["kwargs"])

        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{kernel}.cu",
            replaces=REPLACES[name], max_abs_err=checks[name].max_abs_err,
            inorder_max_abs_err=checks[name].inorder_max_abs_err,
            ms=total(timers.graph, launch), call_ms=total(timers.call, launch),
            plain_ms=total(timers.call, lambda c: lambda: plain(*c["args"])),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=(None if records[0]["library"] is None else
                        total(timers.graph, lambda c: c["library"]))))
    return rows


def fused_plan(stack, frames):
    """The launch the planner gives the whole-network kernel for this batch,
    and how many such clusters the card holds at once."""
    from repro_torch.kernels.stream_fused import launch_plan, max_active_clusters

    plan = launch_plan(stack, frames.shape[0], frames.device)
    return dict(cluster=plan.cluster, threads=plan.threads,
                smem_bytes=plan.smem_bytes, fc_resident=plan.fc_resident,
                fc_rows=plan.fc_rows, waves=plan.waves,
                active_clusters=(max_active_clusters(plan)
                                 if frames.device.type == "cuda" else None))


# per-layer kernel -> its CUDA source's stem
PER_LAYER = {"goap_conv_block_sparse": "goap_conv", "wm_fc_matmul": "wm_fc",
             "lif_update_fused": "lif_update"}
REPLACES = {"goap_conv_block_sparse": "src/repro/kernels/goap_conv.py:55",
            "wm_fc_matmul": "src/repro/kernels/wm_fc.py:40",
            "lif_update_fused": "src/repro/kernels/lif_update.py:46"}
# per output of each per-layer kernel: its tolerance against the plain version
OUTPUT_ATOL = {"goap_conv_block_sparse": (ATOL,), "wm_fc_matmul": (ATOL,),
               "lif_update_fused": (0.0, ATOL)}    # spikes exactly, v_fin
# kernels held bit for bit to an in-order eager version of their arithmetic
INORDER = ("goap_conv_block_sparse", "wm_fc_matmul")


def _kernel(name):
    from repro_torch import kernels

    return kernels.KERNELS[name]


def _plain(name):
    from repro_torch import kernels

    return getattr(kernels, name + "_ref")


def _inorder(name):
    from repro_torch import kernels

    return getattr(kernels, name + "_inorder")


def check_per_layer(plan, frames_b):
    """Run the plan's layer-by-layer path once with every per-layer kernel
    call held against its plain version on the operands the path gave it.

    The calls go through ``repro_torch.kernels.ops``, whose wrappers
    (``goap_conv_op``, ``wm_fc_op``, ``lif_op``) the path's cells call;
    each kernel there is replaced by a checking shim for this one run.
    Returns ({kernel: Check}, {kernel: [call records]})."""
    import torch

    from repro_torch.kernels import ops

    checks = {name: Check(name) for name in PER_LAYER}
    calls = {name: [] for name in PER_LAYER}

    def checked(name, kernel):
        def call(*args, **kwargs):
            got = kernel(*args, **kwargs)
            want = _plain(name)(*args)
            torch.cuda.synchronize()
            outs = got if isinstance(got, tuple) else (got,)
            wants = want if isinstance(want, tuple) else (want,)
            what = f"call {len(calls[name])}"
            for i, (g, w, atol) in enumerate(zip(outs, wants, OUTPUT_ATOL[name])):
                checks[name].close(g, w, atol, f"{what} output {i} {tuple(g.shape)}")
            if name in INORDER:
                checks[name].equal(got, _inorder(name)(*args), what)
            ops_needed, library = per_layer_work(name, args)
            calls[name].append(dict(args=args, kwargs=kwargs, ops=ops_needed,
                                    library=library, bytes=nbytes(*args, *outs)))
            return got
        return call

    saved = {name: getattr(ops, name) for name in PER_LAYER}
    for name, kernel in saved.items():
        setattr(ops, name, checked(name, kernel))
    try:
        plan.bound.batch(frames_b)
    finally:
        for name, kernel in saved.items():
            setattr(ops, name, kernel)
    missing = [name for name, c in calls.items() if not c]
    if missing:
        raise AssertionError(f"the layer-by-layer path never called {missing}")
    return checks, calls


def per_layer_work(name, args):
    """(operations these inputs need, one PyTorch call computing the same
    function or None) for one call of a per-layer kernel."""
    import torch

    if name == "goap_conv_block_sparse":
        from repro_torch.kernels.goap_conv import dense_of_blocks

        blocks, cols, x = args
        dense = dense_of_blocks(blocks, cols, x.shape[0])
        adds = (dense != 0).sum(0).double() @ x.sum(1).double()
        return float(adds), lambda: torch.matmul(dense, x)
    if name == "wm_fc_matmul":
        s, w = args
        adds = (s != 0).sum(0).double() @ (w != 0).sum(1).double()
        return float(adds), lambda: torch.matmul(s, w)
    # LIF: multiply, add, multiply, subtract per neuron and timestep
    return 4.0 * args[0].numel(), None


def expect_launches(counts, launched, path: str) -> None:
    """Every kernel in ``launched`` ran on ``path``, and no other did."""
    wrong = {name: n for name, n in counts.items()
             if (n > 0) != (name in launched)}
    if wrong:
        raise AssertionError(f"{path}: launches {counts}; expected exactly "
                             f"{sorted(launched)} to launch")


def run_main_path(params, masks, cfg, iq, frames_b, device):
    """Phase 5, two paths, each with the launch counts set to 0 just
    before it and read just after: the engine serves REQUESTS frames (the
    whole-network kernel), then the same plan runs one batch layer by
    layer (the per-layer kernels).  Returns (predictions, engine stats,
    engine, layered logits, {path: launches})."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    with AsyncAMCServeEngine(params, cfg, masks, backend="cuda_fused",
                             max_batch=BATCH, device=device) as engine:
        futures = [engine.submit(frame) for frame in iq]
        preds = np.array([f.result(timeout=600) for f in futures])
        stats = engine.stats.summary()
    torch.cuda.synchronize()
    served = launch_counts()
    print(f"main path, served: {len(preds)} requests in "
          f"{time.perf_counter() - t0:.3f} s; launches {served}")
    expect_launches(served, {"stream_fused_forward"}, "served path")

    reset_launch_counts()
    layered = engine.plan.bound.batch(frames_b)
    torch.cuda.synchronize()
    per_layer = launch_counts()
    print(f"main path, layer by layer: one batch of {frames_b.shape[0]}; "
          f"launches {per_layer}")
    expect_launches(per_layer, set(PER_LAYER), "layer-by-layer path")
    return preds, stats, engine, layered, {"served": served,
                                           "layered": per_layer}


def run(device, timers: Timers, seed: int = SEED):
    """Phases 3-7 on ``device``; returns the kernels JSON object."""
    import numpy as np
    import torch

    from repro_torch.api import (SNNConfig, compile_plan, compile_snn, init_snn,
                                 make_mask_pytree)
    from repro_torch.data.pipeline import (sigma_delta_encode_batch,
                                           sigma_delta_encode_np)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    cfg = SNNConfig()
    params = init_snn(seed, cfg)
    masks = make_mask_pytree(params, DENSITY)
    rng = np.random.default_rng(seed)
    iq = rng.normal(size=(REQUESTS, cfg.conv_specs[0][1], cfg.input_width)
                    ).astype(np.float32)
    program = compile_snn(cfg)
    plan = compile_plan(program, params, masks=masks, assignment="cuda_fused",
                        device=device)

    iq_b = iq[:BATCH]
    iq_dev = torch.as_tensor(iq_b, device=device)
    frames_b = sigma_delta_encode_batch(iq_dev, cfg.timesteps)   # (B,T,C,W)

    print("phase: kernels against their plain versions")
    rows = check_kernels(plan, iq_dev, frames_b, timers)

    print("phase: main path")
    preds, stats, engine, layered, launches = run_main_path(
        params, masks, cfg, iq, frames_b, device)
    goap_plan = compile_plan(program, params, masks=masks, assignment="goap",
                             device=device)
    goap_logits = [goap_plan.bound.batch(torch.as_tensor(chunk, device=device))
                   for chunk in np.split(sigma_delta_encode_np(iq, cfg.timesteps),
                                         REQUESTS // BATCH)]
    want = np.concatenate([lg.argmax(-1).cpu().numpy() for lg in goap_logits])
    n_diff = int((preds != want).sum())
    print(f"  engine predictions vs plain goap backend: {n_diff} of "
          f"{len(preds)} differ")
    if n_diff:
        raise AssertionError(f"{n_diff} served predictions differ from the "
                             "plain goap backend")
    # the layer-by-layer path against the fused kernel and the goap backend
    fused = plan.batch(frames_b)
    if not (torch.isfinite(layered).all() and layered.shape == (BATCH, cfg.n_classes)):
        raise AssertionError("layered path gave malformed logits")
    diff = float((layered - fused).abs().max())
    n_pred = int((layered.argmax(-1).cpu().numpy() != want[:BATCH]).sum())
    print(f"  cuda_fused layered vs fused logits: max |diff| {diff:.3e} "
          f"(must be 0); vs plain goap: max |diff| "
          f"{float((layered - goap_logits[0]).abs().max()):.3e}, "
          f"{n_pred} of {BATCH} predictions differ")
    if diff != 0.0 or n_pred:
        raise AssertionError("the layer-by-layer path disagrees with the fused "
                             "kernel or the plain goap backend")
    print(f"  engine stats: {json.dumps(stats)}")
    # where one served batch's time goes (timed after the count was read)
    split = {
        "step_ms": timers.call(lambda: engine.step(iq_b)),
        "encode_ms": timers.call(lambda: sigma_delta_encode_batch(iq_dev,
                                                                  cfg.timesteps)),
        "fused_kernel_ms": timers.call(lambda: plan.batch(frames_b)),
    }
    print(f"serve_step {json.dumps(split)}")
    # one layer-by-layer batch host to host (no graph), beside the device
    # time of the kernels it launches: the rest is X' construction, layout
    # copies and launch overhead on the host
    kernels_ms = sum(row["ms"] for row in rows if row["name"] in PER_LAYER)
    layered_ms = timers.host(lambda: plan.bound.batch(frames_b))
    print("layered_step " + json.dumps({
        "step_ms": layered_ms, "kernels_ms": kernels_ms,
        "kernels_share": kernels_ms / layered_ms}))
    for row in rows:
        # each kernel's count from the path that launches it, and both paths'
        path = "served" if row["name"] == "stream_fused_forward" else "layered"
        row["launches"] = launches[path][row["name"]]
        row["launches_by_path"] = {p: c[row["name"]] for p, c in launches.items()}
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "inorder_max_abs_err", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "plan", "ms_batch1",
            "plan_batch1")
    return {"kernels": [{k: row.get(k) for k in keys} for row in rows]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = nvidia_smi()
    print(card)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s")
    for line in build.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "build seconds")):
            print("  " + line.strip())
    from repro_torch.kernels.timing import call_ms, graph_ms

    device = torch.device("cuda", 0)
    result = run(device, Timers(call_ms, graph_ms, host_timer))
    for row in result["kernels"]:
        print(f"  {row['name']}: {row['ms']:.4f} ms (one call "
              f"{row['call_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.6f} by {row['bound_by']}, library "
              f"{row['library_ms']}), launches {row['launches']}")
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
