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
7. drives the paper's measurement plane at the same width, each path
   with the launch counts set to 0 just before it and read just after:
   - ``stream``: the Algorithm-2 interpreter (plain torch, no kernel) on
     the 64 frames; its per-conv counters must equal the whole-network
     kernel's ``conv_accs`` exactly, its logits the same backend's on the
     CPU within 1e-5, its predictions the kernel's; prints the batch's
     host-to-host ms;
   - ``gauges``: an ``AsyncAMCServeEngine(backend="cuda_fused")`` with
     its live Tables I/III gauges (the default) serves the 256 requests;
     every layer's ``repro_activity_accumulations_total`` must equal the
     ``stream`` counters summed over the same real frames, and the Table
     I schedule gauges the ``stream`` backend's static counts; prints
     the served step's ms with gauges on and off;
   - ``fixed``: the integer tier serves 64 requests through
     ``backend="fixed"`` with LSQ step sizes at 16 and 8 bits; the
     served step's int32 logits must be bit-equal to the numpy
     ``GoldenNet.forward_iq`` on the same I/Q; prints the step's ms;
8. trains the paper model on the card (``train``: ``SNNTrainer`` at full
   width, batch 64, Table V's 25-20-15-20-25 per-layer densities, 16-bit
   LSQ, ``prune_every=10``, 40 steps, checkpoints in a temporary
   directory) and gates four things: one training step on the card
   against the same step on the CPU from the same state and batch (loss
   within 1e-4, clipped gradients within 1e-3 in relative norm); a
   trainer resumed from the step-20 checkpoint equal to the one that ran
   on, bit for bit, after 20 more steps; the trained, pruned, quantized
   model served to 256 requests through ``AsyncAMCServeEngine(backend=
   "cuda_fused", lsq_scales=...)``, launching the whole-network kernel and
   nothing else, with the plain ``goap`` backend's predictions; every
   loss finite.  Prints ``train_phase`` with the median step ms (host to
   host), its host part (RadioML generation and Σ-Δ encoding), the card's
   busy ms and operations a step (``torch.profiler``), the first and last
   10 steps' mean loss and both accuracies;
9. races the backends as a user's default engine does
   (``autotune_phase``: ``AsyncAMCServeEngine(params, cfg, masks)`` with
   ``backend="auto"`` races dense, goap, cuda and cuda_fused on the
   batch-64 bucket; ``cuda`` and ``cuda_fused`` must be timed and raise
   nothing, the race must launch all four kernels, and the 256 served
   requests only the winner's, with the ``goap`` backend's predictions;
   each candidate's race time stands beside its step on the race's
   all-zero probe and on real frames);
10. races them layer by layer (``per_layer_phase``: ``backend=
    "per-layer"``; every weighted layer times cuda and cuda_fused without
    error, and the winning assignment serves the 256 requests with
    ``goap``'s predictions and only its kernels);
11. runs the synchronous ``AMCServeEngine(backend="cuda_fused")`` on the
    256 frames (``sync_phase``: predictions equal to the auto engine's;
    p50/p99, fps, and the auto engine's ``export_stats()``);
12. profiles the ``cuda`` plan's layer steps and makes a disk-tier round
    trip of the plan cache in a temporary directory (``plan_phase``: a
    fresh cache loads every layer's artifacts, 5 for ``fixed`` and 3 for
    ``cuda_fused``, and builds none);
13. prints the paper's Tables I, II, III and IV-V and Fig. 8 with Table V
    retention at the reference scripts' defaults, with the seconds each
    took (``paper_phase``; Table I must match the paper);
14. prints the whole run's seconds, one JSON line of per-kernel results,
    the card, and last ``{"ok": true, "device": {...}}``.

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
# the train phase: steps in all, the step of the resume checkpoint, and its
# gates on one step, card against CPU
TRAIN_STEPS = 40
TRAIN_RESUME_AT = 20
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3


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

    from repro_torch.plan import PlanCache, set_default_cache

    # plans stay in memory: nothing is written outside the checkout and
    # the temporary directories (plan_phase makes its own disk cache)
    set_default_cache(PlanCache(disk_dir=""))
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
    result = {"kernels": [{k: row.get(k) for k in keys} for row in rows]}

    print("phase: stream")
    stream_plan = run_stream_phase(program, params, masks, plan, frames_b,
                                   device, timers)
    print("phase: gauges")
    run_gauges_phase(params, masks, cfg, iq, preds, stream_plan, device, timers)
    print("phase: fixed")
    run_fixed_phase(params, masks, cfg, iq, device, timers)
    print("phase: train")
    paths = {"trained": run_train_phase(cfg, device, timers, seed)}
    print("phase: autotune")
    auto_preds, auto_stats, auto_paths = run_autotune_phase(
        params, masks, cfg, iq, want, device, timers)
    paths.update(auto_paths)
    print("phase: per-layer")
    paths.update(run_per_layer_phase(params, masks, cfg, iq, want, device))
    print("phase: sync")
    run_sync_phase(params, masks, cfg, iq, auto_preds, auto_stats, device)
    print("phase: plan")
    run_plan_phase(program, params, masks, frames_b, device)
    print("phase: paper")
    run_paper_phase(device)
    for row in result["kernels"]:
        for path, counts in paths.items():
            row["launches_by_path"][path] = counts[row["name"]]
    return result


def run_stream_phase(program, params, masks, plan, frames_b, device, timers):
    """The ``stream`` backend on the card: counters equal to the fused
    kernel's ``conv_accs``, logits to the CPU run's, predictions to the
    kernel's.  Returns the stream plan."""
    import torch

    from repro_torch.api import compile_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    stream = compile_plan(program, params, masks=masks, assignment="stream",
                          device=device)
    reset_launch_counts()
    logits, accs = stream.batch_counters(frames_b)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  stream path: one batch of {frames_b.shape[0]}; launches {counts}")
    expect_launches(counts, set(), "stream path")
    fused_logits, conv_accs = plan.batch_counters(frames_b)
    for name, acc in accs.items():
        if not torch.equal(acc, conv_accs[name]):
            raise AssertionError(f"stream counters of {name} differ from the "
                                 "fused kernel's conv_accs")
    cpu = compile_plan(program, params, masks=masks, assignment="stream",
                       device="cpu")
    cpu_logits, cpu_accs = cpu.batch_counters(frames_b.cpu())
    err = float((logits.cpu() - cpu_logits).abs().max())
    n_pred = int((logits.argmax(-1) != fused_logits.argmax(-1)).sum())
    same_cpu = all(torch.equal(accs[n].cpu(), cpu_accs[n]) for n in accs)
    print(f"  stream counters equal the fused kernel's conv_accs on "
          f"{len(accs)} convs x {frames_b.shape[0]} frames; totals "
          f"{ {n: float(a.double().sum()) for n, a in accs.items()} }")
    print(f"  stream logits vs the CPU stream run: max |err| {err:.3e} (atol "
          f"{ATOL}); counters equal: {same_cpu}; predictions vs cuda_fused: "
          f"{n_pred} of {frames_b.shape[0]} differ")
    if err > ATOL or not same_cpu or n_pred:
        raise AssertionError("the stream backend on the card disagrees with "
                             "its CPU run or the fused kernel")
    line = {"batch": frames_b.shape[0],
            "step_ms": timers.host(lambda: stream.batch_counters(frames_b)),
            "slots_per_timestep": stream_slots(params, masks)}
    print(f"stream_phase {json.dumps(line)}")
    return stream


def stream_slots(params, masks) -> int:
    """Slot steps one timestep of the stream interpreter walks (all convs):
    the longest output channel's schedule entries, per conv."""
    from repro_torch.core.saocds import channel_slots
    from repro_torch.core.sparse_format import build_schedule, coo_from_dense

    total = 0
    for layer, mask in zip(params["conv"], masks["conv"]):
        coo = coo_from_dense((layer["w"] * mask).numpy())
        total += channel_slots(build_schedule(coo), coo.oc).n_slots
    return total


def run_gauges_phase(params, masks, cfg, iq, want_preds, stream, device, timers):
    """The served path with live gauges: the registry's totals equal the
    ``stream`` counters over the real frames."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine
    from repro_torch.data.pipeline import sigma_delta_encode_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import metrics
    from repro_torch.obs.activity import static_schedule_counts

    registry = metrics.MetricsRegistry()
    old = metrics.set_default_registry(registry)
    try:
        reset_launch_counts()
        with AsyncAMCServeEngine(params, cfg, masks, backend="cuda_fused",
                                 max_batch=BATCH, device=device,
                                 name="gauges") as engine:
            futures = [engine.submit(frame) for frame in iq]
            preds = np.array([f.result(timeout=600) for f in futures])
            padded = engine.stats.padded_frames
            torch.cuda.synchronize()
            counts = launch_counts()
            print(f"  gauged served path: {len(preds)} requests, {padded} "
                  f"padded rows; launches {counts}")
            expect_launches(counts, {"stream_fused_forward"},
                            "gauged served path")
            # the served step with gauges on and off, in turns (on, off,
            # off, on) on two engines bound to the same weights
            iq_b = iq[:BATCH]
            with AsyncAMCServeEngine(params, cfg, masks, backend="cuda_fused",
                                     max_batch=BATCH, device=device,
                                     name="ungauged",
                                     activity_gauges=False) as plain:
                steps = [(on, timers.call(lambda: e.serve_step(iq_b)))
                         for on, e in ((True, engine), (False, plain),
                                       (False, plain), (True, engine))]
    finally:
        metrics.set_default_registry(old)
    gauges_on = [ms for on, ms in steps if on]
    gauges_off = [ms for on, ms in steps if not on]
    if not np.array_equal(preds, want_preds):
        raise AssertionError("the gauged engine's predictions differ")
    _, accs = stream.batch_counters(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=device), cfg.timesteps))
    totals = {}
    for name, acc in accs.items():
        want = float(acc.double().sum())
        got = registry.value("repro_activity_accumulations_total",
                             engine="gauges", layer=name)
        totals[name] = got
        if got != want:
            raise AssertionError(f"gauge {name}: {got} != stream {want}")
    frames = registry.value("repro_activity_frames_total", engine="gauges")
    if frames != len(iq):
        raise AssertionError(f"gauges counted {frames} frames, not {len(iq)}")
    schedule = static_schedule_counts(stream)
    for layer, table in schedule.items():
        for key, val in table.items():
            got = registry.value("repro_activity_schedule", layer=layer,
                                 counter=key)
            if got != val:
                raise AssertionError(f"schedule gauge {layer}.{key}: {got} "
                                     f"!= stream {val}")
    print(f"  gauges equal the stream counters over {len(iq)} real frames: "
          f"{totals}; Table I gauges equal: {schedule}")
    print("gauges_phase " + json.dumps({
        "requests": len(iq), "padded": padded, "accumulations_total": totals,
        "step_ms_gauges_on": gauges_on, "step_ms_gauges_off": gauges_off}))


def run_fixed_phase(params, masks, cfg, iq, device, timers):
    """The integer tier served with LSQ step sizes at 16 and 8 bits; the
    served step's int32 logits bit-equal to the numpy golden."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine
    from repro_torch.fixed import FixedQuantFn, build_golden
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.lsq import init_lsq_scales

    iq_b = iq[:BATCH]
    line = {"requests": len(iq_b)}
    for bits in (16, 8):
        scales = init_lsq_scales(params, bits)
        reset_launch_counts()
        with AsyncAMCServeEngine(params, cfg, masks, backend="fixed",
                                 max_batch=BATCH, lsq_scales=scales,
                                 quant_bits=bits, device=device,
                                 name=f"fixed{bits}") as engine:
            futures = [engine.submit(frame) for frame in iq_b]
            preds = np.array([f.result(timeout=600) for f in futures])
            logits = engine.step(iq_b)
            torch.cuda.synchronize()
            counts = launch_counts()
            step_ms = timers.call(lambda: engine.step(iq_b))
        print(f"  fixed path, {bits} bits: {len(preds)} requests; launches "
              f"{counts}")
        expect_launches(counts, set(), f"fixed path ({bits} bits)")
        golden = build_golden(cfg, params, masks=masks,
                              quant_fn=FixedQuantFn(scales, bits))
        want = np.stack([golden.forward_iq(f) for f in iq_b])
        n_same = int((logits == want).all(-1).sum())
        print(f"  fixed {bits} bits: int32 logits bit-equal to the golden "
              f"for {n_same} of {len(iq_b)} frames (max |logit| "
              f"{int(np.abs(want).max())}); served predictions equal the "
              f"golden's: {bool((preds == want.argmax(-1)).all())}")
        if logits.dtype != np.int32 or n_same != len(iq_b) or \
                not (preds == want.argmax(-1)).all():
            raise AssertionError(f"fixed tier at {bits} bits disagrees with "
                                 "the golden")
        line[f"step_ms_{bits}"] = step_ms
    print(f"fixed_phase {json.dumps(line)}")


def train_config(cfg, **overrides):
    """The train phase's ``TrainerConfig``: batch 64, Table V's per-layer
    densities 25-20-15-20-25, 16-bit LSQ, masks recomputed every 10 steps
    (the ramp runs from step 8 and freezes at step 32 of 40), Σ-Δ OSR =
    the model's T."""
    from repro_torch.configs.saocds_amc import DENSITY_CONFIGS
    from repro_torch.train import TrainerConfig

    return TrainerConfig(
        total_steps=TRAIN_STEPS, batch_size=BATCH, snr_db=10.0,
        osr=cfg.timesteps,
        per_layer_density=DENSITY_CONFIGS["saocds-25-20-15-20-25"],
        prune_every=10, use_lsq=True, quant_bits=16, **overrides)


def check_step_against_cpu(cfg, device) -> dict:
    """Gate 1: one training step on the card and on the CPU from the same
    trainer state (the numpy-seeded init, masks at the final densities)
    and the same batch: the loss within TRAIN_LOSS_ATOL, the clipped
    gradients (every param leaf) within TRAIN_GRAD_RTOL in relative norm.
    The LSQ step sizes' gradients are printed beside them."""
    import torch

    from repro_torch.train import SNNTrainer, make_mask_pytree
    from repro_torch.tree import tree_leaves, tree_map

    tcfg = train_config(cfg)
    cpu = SNNTrainer(cfg, tcfg, device="cpu")
    card = SNNTrainer(cfg, tcfg, device=device)
    masks = make_mask_pytree(cpu.params, tcfg.per_layer_density)
    frames, labels, _ = cpu._batch(SEED, tcfg.snr_db)
    got = card._gradients(card.params, card.lsq_scales,
                          tree_map(lambda m: m.to(device), masks),
                          frames.to(device), labels.to(device))
    want = cpu._gradients(cpu.params, cpu.lsq_scales, masks, frames, labels)

    def rel(a, b):
        a = torch.cat([x.cpu().reshape(-1) for x in tree_leaves(a)]).double()
        b = torch.cat([x.reshape(-1) for x in tree_leaves(b)]).double()
        return float((a - b).norm() / b.norm())

    line = {"loss_card": float(got[0]), "loss_cpu": float(want[0]),
            "loss_abs_diff": abs(float(got[0]) - float(want[0])),
            "grad_rel_diff": rel(got[2], want[2]),
            "lsq_grad_rel_diff": rel(got[3], want[3]),
            "grad_norm_card": float(got[4]), "grad_norm_cpu": float(want[4])}
    print(f"  one step, card vs CPU: {json.dumps(line)}")
    if not (line["loss_abs_diff"] <= TRAIN_LOSS_ATOL
            and line["grad_rel_diff"] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"the training step on the card differs from the "
                             f"CPU's: {line}")
    return line


def profile_steps(step, steps: int = 3) -> dict:
    """Device busy time and device operations per training step, by
    ``torch.profiler`` over ``steps`` calls of ``step`` (each one whole
    step, host to host): the union of the intervals in which a kernel or
    copy ran on the card, per step.  ``None`` where the profiler saw no
    device activity (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"profiled_step_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3 / steps if spans else None,
            "device_ops_per_step": len(spans) / steps if spans else None}


def run_train_phase(cfg, device, timers, seed: int = SEED) -> dict:
    """Phase 8: train the model on the card, resume bit for bit, serve the
    trained model through the whole-network kernel.  Returns the served
    path's launch counts."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine, compile_plan, compile_snn
    from repro_torch.data.pipeline import sigma_delta_encode_np
    from repro_torch.data.radioml import generate_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import SNNTrainer, mask_density
    from repro_torch.train.lsq import make_serving_quant_fn
    from repro_torch.tree import tree_leaves

    line = {"steps": TRAIN_STEPS, "batch": BATCH,
            "one_step": check_step_against_cpu(cfg, device)}
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # gate 2: A trains to the checkpoint and on; B resumes from a copy
        # of that checkpoint and trains the same steps one at a time, timed
        dir_a, dir_b = f"{work}/a", f"{work}/b"
        a = SNNTrainer(cfg, train_config(cfg, ckpt_dir=dir_a,
                                         ckpt_every=TRAIN_RESUME_AT),
                       device=device)
        first = a.run(steps=TRAIN_RESUME_AT, log_every=1)
        shutil.copytree(dir_a, dir_b)
        b = SNNTrainer(cfg, train_config(cfg, ckpt_dir=dir_b), device=device)
        if not b.resume() or b.step != TRAIN_RESUME_AT:
            raise AssertionError(f"resume from step {TRAIN_RESUME_AT} failed")
        b.ckpt = None   # B's steps are timed: no saves among them
        rest = a.run(steps=TRAIN_STEPS - TRAIN_RESUME_AT, log_every=1)
        step_ms, b_losses = [], []
        for _ in range(TRAIN_STEPS - TRAIN_RESUME_AT):
            t0 = time.perf_counter()
            b_losses += b.run(steps=1, log_every=1)["loss"]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        state_a, state_b = tree_leaves(a._state_tree()), tree_leaves(b._state_tree())
        n_diff = sum(not torch.equal(x, y) for x, y in zip(state_a, state_b))
        print(f"  resume: {len(state_a)} leaves (params, opt, masks, LSQ); "
              f"{n_diff} differ bit for bit after {TRAIN_STEPS} steps")
        if len(state_a) != len(state_b) or n_diff:
            raise AssertionError("the resumed trainer differs from the one "
                                 "that ran on")
        # where a step's time goes on the card (B trains on, A is kept)
        line["profile"] = profile_steps(lambda: b.run(steps=1, log_every=1))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    losses = first["loss"] + rest["loss"]
    # gate 4: every loss finite
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses + b_losses + [
                line["one_step"]["loss_card"], line["one_step"]["loss_cpu"]]):
        raise AssertionError(f"non-finite or missing losses: {losses}")

    # the host part of a step: generate and encode one batch (numpy)
    def host_part():
        iq, _, _ = generate_batch(seed, BATCH, 10.0, frame_len=cfg.input_width)
        sigma_delta_encode_np(iq, cfg.timesteps)

    frames, labels_dev, _ = a._batch(seed, 10.0)
    warm = step_ms[3:]
    line.update({
        "step_ms_median": statistics.median(warm),
        "step_ms_min": min(warm), "step_ms_max": max(warm),
        "host_ms": timers.host(host_part),
        # the training step alone (forward, backward, clip, AdamW, LSQ)
        # between two CUDA events, on a batch already on the card
        "train_step_call_ms": timers.call(lambda: a._train_step(
            a.params, a.opt_state, a.lsq_scales, a.masks, frames, labels_dev)),
        "loss_first10": statistics.mean(losses[:10]),
        "loss_last10": statistics.mean(losses[-10:]),
        "mask_density": mask_density(a.masks),
    })
    # the rest of the step: issuing the step's ops, and the card's work
    line["step_minus_host_ms"] = line["step_ms_median"] - line["host_ms"]
    busy = line["profile"]["device_busy_ms"]
    line["device_idle_share"] = (None if busy is None
                                 else 1.0 - busy / line["step_ms_median"])

    # gate 3: the trained model served through the whole-network kernel
    iq, labels, _ = generate_batch(seed + 1, REQUESTS, 10.0,
                                   frame_len=cfg.input_width)
    reset_launch_counts()
    with AsyncAMCServeEngine(a.params, cfg, a.masks, backend="cuda_fused",
                             lsq_scales=a.lsq_scales, quant_bits=16,
                             max_batch=BATCH, device=device,
                             name="trained") as engine:
        futures = [engine.submit(frame) for frame in iq]
        preds = np.array([f.result(timeout=600) for f in futures])
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  trained model served: {len(preds)} requests; launches {counts}")
    expect_launches(counts, {"stream_fused_forward"}, "trained served path")
    goap = compile_plan(compile_snn(cfg), a.params, masks=a.masks,
                        assignment="goap",
                        quant_fn=make_serving_quant_fn(a.lsq_scales, 16),
                        device=device)
    want = np.concatenate([
        goap.bound.batch(torch.as_tensor(chunk, device=device)).argmax(-1).cpu().numpy()
        for chunk in np.split(sigma_delta_encode_np(iq, cfg.timesteps),
                              REQUESTS // BATCH)])
    n_diff = int((preds != want).sum())
    print(f"  trained served predictions vs plain goap backend: {n_diff} of "
          f"{len(preds)} differ")
    if n_diff:
        raise AssertionError(f"{n_diff} trained served predictions differ from "
                             "the plain goap backend")
    line.update({"served_requests": len(preds),
                 "served_accuracy": float((preds == labels).mean()),
                 "evaluate_accuracy": a.evaluate(snr_db=10.0),
                 "served_launches": counts})
    line["card"] = nvidia_smi() if device.type == "cuda" else "cpu"
    print(f"train_phase {json.dumps(line)}")
    return counts


def kernels_of(plan) -> set:
    """The kernels a plan's preferred batch launches."""
    if plan.fused_stack() is not None:
        return {"stream_fused_forward"}
    out = set()
    for lp in plan.layers:
        if lp.backend in ("cuda", "cuda_fused"):
            out |= {"lif_update_fused", "goap_conv_block_sparse"
                    if lp.spec.kind == "conv_lif" else "wm_fc_matmul"}
    return out


def serve_all(engine, iq):
    import numpy as np

    futures = [engine.submit(frame) for frame in iq]
    return np.array([f.result(timeout=600) for f in futures])


def check_race_errors(errors, what: str) -> None:
    """A kernel that fails to build or launch must not hide in the race:
    the race records it and serves another backend, so fail here."""
    bad = {k: v for k, v in errors.items() if k in ("cuda", "cuda_fused")}
    if bad:
        raise AssertionError(f"{what}: a kernel backend raised: {bad}")


def run_autotune_phase(params, masks, cfg, iq, want, device, timers):
    """The default engine (``backend="auto"``) races dense, goap, cuda and
    cuda_fused on the batch-64 bucket, then serves the 256 requests with
    the winner.  Two launch windows: the race (every kernel) and the
    served requests (the winner's kernels and no other).  Beside each
    candidate's race time: its step on the race's all-zero probe and on
    real frames, on one stopwatch.  Returns (predictions, engine's
    ``export_stats()``, {path: launches})."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine, compile_plan, compile_snn
    from repro_torch.data.pipeline import sigma_delta_encode_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    engine = AsyncAMCServeEngine(params, cfg, masks, max_batch=BATCH,
                                 device=device, name="auto")
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    race = launch_counts()
    try:
        report = engine.autotune.summary()
        print(f"  race: {json.dumps(report)}; launches {race}")
        check_race_errors(report["errors"], "autotune race")
        if report["fell_back"] or not {"cuda", "cuda_fused"} <= set(
                report["timings_ms"]):
            raise AssertionError(f"autotune race did not time both kernel "
                                 f"backends: {report}")
        expect_launches(race, set(PER_LAYER) | {"stream_fused_forward"},
                        "autotune race")
        reset_launch_counts()
        preds = serve_all(engine, iq)
        torch.cuda.synchronize()
        served = launch_counts()
        stats = engine.export_stats()
    finally:
        engine.close()
    print(f"  auto engine served {len(preds)} requests with "
          f"{engine.backend!r}; launches {served}")
    expect_launches(served, kernels_of(engine.plan), "auto served path")
    n_diff = int((preds != want).sum())
    print(f"  auto engine predictions vs plain goap backend: {n_diff} of "
          f"{len(preds)} differ")
    if n_diff:
        raise AssertionError(f"{n_diff} auto-served predictions differ from "
                             "the plain goap backend")
    # each candidate's step on the race's probe and on real frames
    program = compile_snn(cfg)
    iq_dev = torch.as_tensor(iq[:BATCH], device=device)
    zeros = torch.zeros_like(iq_dev)
    steps = {}
    with torch.inference_mode():
        for name, race_ms in report["timings_ms"].items():
            plan = compile_plan(program, params, masks=masks, assignment=name,
                                device=device)
            batch = plan.batch if name == "cuda_fused" else plan.bound.batch

            def step(x, batch=batch):
                return batch(sigma_delta_encode_batch(x, cfg.timesteps))

            steps[name] = {"race_ms": race_ms,
                           "zero_probe_ms": timers.host(lambda: step(zeros)),
                           "real_frames_ms": timers.host(lambda: step(iq_dev))}
    print("autotune_phase " + json.dumps({
        "choice": report["choice"], "batch_shape": report["batch_shape"],
        "startup_s": startup_s,
        "steps": steps, "launches_race": race, "launches_served": served,
        "served": {k: stats[k] for k in ("requests", "throughput_fps",
                                         "p50_ms", "p99_ms")}}))
    return preds, stats, {"auto_race": race, "auto_served": served}


def run_per_layer_phase(params, masks, cfg, iq, want, device):
    """``backend="per-layer"``: every weighted layer races the candidates on
    its own input shape (cuda and cuda_fused must both be timed, without
    error), then the winning assignment serves the 256 requests.  Returns
    {path: launches}."""
    import torch

    from repro_torch.api import AsyncAMCServeEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    engine = AsyncAMCServeEngine(params, cfg, masks, backend="per-layer",
                                 max_batch=BATCH, device=device,
                                 name="per-layer")
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    race = launch_counts()
    try:
        report = engine.perlayer.summary()
        print(f"  per-layer race: {json.dumps(report)}; launches {race}")
        for layer, errors in report["errors"].items():
            check_race_errors(errors, f"per-layer race, {layer}")
            if not {"cuda", "cuda_fused"} <= set(report["timings_ms"][layer]):
                raise AssertionError(f"per-layer race, {layer}: a kernel "
                                     "backend was not timed")
        if report["fell_back"]:
            raise AssertionError(f"per-layer race fell back: {report}")
        if "cuda" in report["assignment"].values():
            # cuda and cuda_fused time one cell: a kernel win is cuda_fused
            raise AssertionError("per-layer race assigned cuda beside "
                                 f"cuda_fused: {report['assignment']}")
        expect_launches(race, set(PER_LAYER) | (
            {"stream_fused_forward"} & kernels_of(engine.plan)),
            "per-layer race")
        reset_launch_counts()
        preds = serve_all(engine, iq)
        torch.cuda.synchronize()
        served = launch_counts()
    finally:
        engine.close()
    expect_launches(served, kernels_of(engine.plan), "per-layer served path")
    n_diff = int((preds != want).sum())
    print(f"  per-layer engine served {len(preds)} requests with "
          f"{engine.assignment}; launches {served}; {n_diff} predictions "
          "differ from the plain goap backend")
    if n_diff:
        raise AssertionError(f"{n_diff} per-layer-served predictions differ "
                             "from the plain goap backend")
    print("per_layer_phase " + json.dumps({
        "assignment": report["assignment"], "startup_s": startup_s,
        "timings_ms": report["timings_ms"],
        "priors": report["priors"], "launches_race": race,
        "launches_served": served,
        "served": {k: engine.stats.summary()[k] for k in (
            "requests", "throughput_fps", "p50_ms", "p99_ms")}}))
    return {"per_layer_race": race, "per_layer_served": served}


def run_sync_phase(params, masks, cfg, iq, auto_preds, auto_stats, device):
    """The synchronous engine (host Σ-Δ encode, the whole-network kernel)
    classifies the 256 frames in chunks of 64; its predictions must equal
    the auto engine's."""
    import torch

    from repro_torch.serve import AMCServeEngine

    engine = AMCServeEngine(params, cfg, masks, backend="cuda_fused",
                            batch_size=BATCH, device=device)
    preds = engine.classify(iq)
    torch.cuda.synchronize()
    n_diff = int((preds != auto_preds).sum())
    st = engine.stats
    print(f"  sync engine: {len(preds)} frames; {n_diff} predictions differ "
          "from the auto engine's")
    if n_diff:
        raise AssertionError("the sync engine's predictions differ from the "
                             "auto engine's")
    print("sync_phase " + json.dumps({
        "requests": st.requests, "batches": st.batches,
        "throughput_fps": st.throughput_fps(), "p50_ms": st.p50_ms,
        "p99_ms": st.p99_ms, "auto_export_stats": auto_stats}))


def run_plan_phase(program, params, masks, frames_b, device):
    """``profile_layer_steps`` of the ``cuda`` plan at batch 64, and a
    disk-tier round trip in a temporary directory: a fresh cache on the
    same directory loads every layer's artifacts and builds none."""
    import shutil
    import tempfile

    import torch

    from repro_torch.api import compile_plan
    from repro_torch.fixed import serving_quant_fn
    from repro_torch.models.graph import artifact_build_count
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.plan import PlanCache
    from repro_torch.plan.streaming import profile_layer_steps

    cuda_plan = compile_plan(program, params, masks=masks, assignment="cuda",
                             device=device)
    layer_ms = profile_layer_steps(cuda_plan, frames_b.transpose(0, 1),
                                   registry=MetricsRegistry())
    print(f"  cuda plan, one layer's T steps at batch {frames_b.shape[0]} "
          f"(ms): {json.dumps(layer_ms)}")
    line = {"layer_step_ms": layer_ms, "disk": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    try:
        # fixed stores an artifact for every weighted layer (5), cuda_fused
        # for the convs (3: COO, schedule, block-sparse tiles)
        n_conv = len(program.cfg.conv_specs)
        for backend, layers in (("fixed", n_conv + len(program.cfg.fc_specs)),
                                ("cuda_fused", n_conv)):
            def build(cache):
                return compile_plan(program, params, masks=masks,
                                    assignment=backend, cache=cache,
                                    quant_fn=serving_quant_fn(
                                        None, 16, assignment=backend),
                                    device=device)

            cold = build(PlanCache(work))
            built = artifact_build_count()
            warm_cache = PlanCache(work)
            warm = build(warm_cache)
            hits = warm_cache.stats["layer_disk_hits"]
            rebuilt = artifact_build_count() - built
            same = bool(torch.equal(cold.bound.batch(frames_b),
                                    warm.bound.batch(frames_b)))
            line["disk"][backend] = {"layer_disk_hits": hits,
                                     "artifacts_built": rebuilt,
                                     "logits_equal": same}
            print(f"  disk round trip, {backend}: {hits} layers from disk, "
                  f"{rebuilt} artifacts built; logits equal: {same}")
            if hits != layers or rebuilt or warm.digest != cold.digest or not same:
                raise AssertionError(f"disk round trip of {backend} failed: "
                                     f"{line['disk'][backend]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("plan_phase " + json.dumps(line))


def run_paper_phase(device):
    """The paper's Tables I, II, III and IV-V and Fig. 8 with Table V
    retention, at the reference scripts' defaults (the accuracy sweep
    trains 200 steps at batch 48 on the card); Table I must match."""
    from repro_torch.bench import (accuracy_sweep, table1_goap_vs_sw,
                                   table2_coo_overhead, table3_accum_ratio,
                                   table45_perf_model)

    runs = ((table1_goap_vs_sw, {}), (table2_coo_overhead, {}),
            (table3_accum_ratio, {"n_samples": 16, "device": device}),
            (table45_perf_model, {}),
            (accuracy_sweep, {"steps": 200, "batch": 48, "device": device}))
    line = {}
    for module, kwargs in runs:
        t0 = time.perf_counter()
        res = module.run(**kwargs)
        line[module.NAME] = {"seconds": time.perf_counter() - t0}
        print(module.format_table(res))
        if module is table1_goap_vs_sw:
            line[module.NAME]["match"] = res["exact"]["match"]
            if not res["exact"]["match"]:
                raise AssertionError("Table I does not match the paper")
        if module is accuracy_sweep:
            line[module.NAME].update(
                snr={r["snr_db"]: r["accuracy"] for r in res["snr"]},
                retention={r["density"]: r["retention_vs_original"]
                           for r in res["density"]},
                final_train_loss=res["final_train_loss"])
    line["card"] = nvidia_smi() if device.type == "cuda" else "cpu"
    print("paper_phase " + json.dumps(line))


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
    t_start = t0 = time.perf_counter()
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
    print(f"chip_smoke: {time.perf_counter() - t_start:.3f} s in all")
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
