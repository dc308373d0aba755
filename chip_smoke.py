#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and hold it to itself.

    python3 chip_smoke.py [--parent DIR]

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
   batch 64 in both input modes and at batch 1, with the planner's f32
   layout and with the bit layout forced.  The same on the O'Shea-2018
   SNN at its published widths (``OSHEA``: 2 x 1,024 samples, seven
   convs of 64 channels, FC 512-128-128-24, 24 classes; masks at density
   0.2), which the planner holds in the bit layout: batch 64 and 1, both
   input modes.  The per-layer kernels are checked on every call the
   plan's layer-by-layer path makes, on the operands that path gives them,
   and the conv and FC kernels must also equal an in-order eager version
   of their arithmetic bit for bit;
5. runs the main path's two paths, each with every launch count set to 0
   just before it and read just after: an
   ``AsyncAMCServeEngine(backend="cuda_fused")`` answers 256 submitted
   requests, which must launch the whole-network kernel and nothing else,
   by CUDA-graph replay alone (one eager launch per captured bucket, the
   warm-up before its capture, and one launch per replay);
   then the same plan runs one batch layer by layer, which must launch
   each per-layer kernel and not the whole-network one.  The engine's
   predictions must equal the plain-torch ``goap`` backend's on the
   card; the layer-by-layer logits must equal the fused kernel's exactly
   and give the ``goap`` backend's predictions.  Then the O'Shea-2018
   SNN is served the same way (launch counts set to 0 just before it):
   256 requests, the whole-network kernel alone by replay alone, each
   captured bucket's launch noted in the bit layout, predictions equal
   to the layered ``cuda`` path's;
6. times each kernel's device time (``ms``) and that of the one PyTorch
   call that computes the same function (``library_ms``) the same way (the
   whole-network kernel also at batch 1, ``ms_batch1``, each beside the
   thread-block-cluster launch the planner chose, ``plan``; on the paper
   model also the bit layout's, ``ms_bits``, ``ms_bits_batch1`` and
   ``plan_bits``; its O'Shea-2018 row names ``model``): 20
   back-to-back calls captured into one CUDA graph, replayed 10 times
   between two CUDA events, the median replay divided by 20; beside them
   a single
   call between two events (``call_ms``, host work included), the plain
   version the same way (``plain_ms``) and the bound.  It then splits one
   served batch's step (host to host) into its Σ-Δ encode and its fused
   kernel, and times one layer-by-layer batch host to host beside the
   sum of its kernels' ``ms``;
7. drives the paper's SNN with bf16 weights (``bf16_phase``:
   ``init_snn(0, SNNConfig(), dtype=torch.bfloat16)``, density-0.5 masks
   in bf16, batch 64, the 256 requests): the three bf16 kernel forms
   (``goap_conv_block_sparse_bf16``, ``wm_fc_matmul_bf16``,
   ``lif_update_fused_bf16``) bit-equal to their plain versions on the
   served path's operands (the count of differing elements printed; the
   conv's cast to bf16, a form the served conv never reaches) and within
   1 bf16 ulp on random normal operands at the reference's test shapes
   and at the edges of the kernels' tiling (``BF16_FC_SHAPES``,
   ``BF16_GOAP_TILES``), then timed like the f32 kernels (the bound over
   the bf16 tensor-core peak for the two products; each form's row with
   its launch plans, and a ``bf16_kernel`` line with its ratio to the
   library call and its per-launch times); a captured
   ``AsyncAMCServeEngine(backend="cuda")`` serves the 256 requests with 0
   failed, by graph replay alone, launching the bf16 FC and LIF forms and
   the f32 conv and LIF (launches counted per replay), with the card's
   layered ``cuda`` predictions;
   ``dense``, ``goap``, ``stream``, ``cuda`` and ``cuda_fused`` on the card
   against the same backend on the CPU on 64 frames (predictions equal,
   logits within 1 bf16 ulp, bf16 on the layered paths, f32 from the fused
   kernel); the fused kernel on the bf16 weights bit-equal to the f32
   model on their upcast, under another plan digest; and an engine for
   each of those backends and for the default race (``auto``, the kernel
   backends timed without error), each serving one batch by graph replay
   with its plan's predictions.  Prints ``bf16_phase``.  Then
   (``operands_phase``) one eager layer-by-layer batch of the ``cuda``
   plan on the bf16 and the f32 model, in a process of its own: its
   device kernels by ``torch.profiler``, and the device ms of one replay
   of the same batch captured in a CUDA graph (median of 20); with
   ``--parent DIR`` (an unpacked earlier tree of the repository, e.g.
   ``git archive HEAD~``) the same for that tree's package, in turns
   (parent, this, this, parent), and the kernels this tree saves;
8. drives the paper's measurement plane at the same width, each path
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
9. trains the paper model on the card (``train``: ``SNNTrainer`` at full
   width, batch 64, Table V's 25-20-15-20-25 per-layer densities, 16-bit
   LSQ, ``prune_every=10``, 40 steps, checkpoints in a temporary
   directory; every step replayed from the trainer's CUDA graph) and
   gates five things: one training step on the card against the same
   step on the CPU from the same state and batch (loss within 1e-4,
   clipped gradients within 1e-3 in relative norm); eight captured steps
   against eight eager ones from one state (``prune_every=2`` over an
   8-step schedule, so reprunes fall inside: every leaf of params,
   optimizer state, masks and LSQ scales and every loss equal, one
   capture for the one variant, a params tree read before the steps
   unchanged after them, ``evaluate()`` and its logits equal captured,
   eager and through the ``dense`` plan), each trainer's step then timed
   (each step waited for, and back to back) and profiled in turns; a
   trainer resumed from the step-20 checkpoint equal to the one that ran
   on, bit for bit, after 20 more steps; the trained, pruned, quantized
   model served to 256 requests through ``AsyncAMCServeEngine(backend=
   "cuda_fused", lsq_scales=...)``, launching the whole-network kernel and
   nothing else, with the plain ``goap`` backend's predictions; every
   loss finite.  Prints ``train_phase`` with the median step ms (host to
   host), its host part (RadioML generation and Σ-Δ encoding), the card's
   busy ms and operations a step (``torch.profiler``), the first and last
   10 steps' mean loss and both accuracies; then ``compression_phase``:
   ``compressed_psum`` of the trained model's clipped gradients over a
   world-size-1 NCCL group (a ``FileStore`` rendezvous in a temporary
   directory) equal to the dequantized ``ef_compress`` codes, with the
   compression ratio;
10. races the backends as a user's default engine does
   (``autotune_phase``: ``AsyncAMCServeEngine(params, cfg, masks)`` with
   ``backend="auto"`` races dense, goap, cuda and cuda_fused on the
   batch-64 bucket; ``cuda`` and ``cuda_fused`` must be timed and raise
   nothing, the race must launch all four f32 kernel forms, and the 256 served
   requests only the winner's, with the ``goap`` backend's predictions;
   each candidate's race time stands beside its step on the race's
   all-zero probe and on real frames);
11. races them layer by layer (``per_layer_phase``: ``backend=
    "per-layer"``; every weighted layer times cuda and cuda_fused without
    error, and the winning assignment serves the 256 requests with
    ``goap``'s predictions and only its kernels);
12. runs the synchronous ``AMCServeEngine(backend="cuda_fused")`` on the
    256 frames (``sync_phase``: predictions equal to the auto engine's;
    p50/p99, fps, and the auto engine's ``export_stats()``);
13. profiles the ``cuda`` plan's layer steps and makes a disk-tier round
    trip of the plan cache in a temporary directory (``plan_phase``: a
    fresh cache loads every layer's artifacts, 5 for ``fixed`` and 3 for
    ``cuda_fused``, and builds none);
14. prints the paper's Tables I, II, III and IV-V and Fig. 8 with Table V
    retention at the reference scripts' defaults, with the seconds each
    took (``paper_phase``; Table I must match the paper);
15. runs ``python -m repro_torch.launch.eval`` in process at full width
    (``robustness_phase``: the default suite's 5 channel scenarios x SNRs
    -10, 0, 10, 18 dB x ``cuda_fused,cuda,goap``, 64 frames a cell, plus
    the clean section): exit 0, logits within 1e-5 and predictions equal
    across the backends on all 24 x 64 frames, each kernel launched as
    many times as the cells require, and for one cell of each of the 7
    named scenarios the card's impaired frames equal to the CPU's within
    1e-5; prints the accuracy surface and the wall seconds per backend;
16. drives the model lifecycle (``lifecycle_phase``): two versions
    published to a registry in a temporary directory, 512 requests
    served through ``cuda_fused`` while the engine hot-swaps from v1 to
    v2, no failed request, the requests after the swap served by v2 with
    the plain ``goap`` backend's predictions on v2's weights, v2's plan
    reloaded by a fresh registry from the disk tier without building an
    artifact, then three canary-monitor rounds on ``urban_fading``
    frames; prints the swap's report;
17. holds the served step captured in CUDA graphs against the same step
    run op by op (``capture_phase``): for ``cuda_fused`` with gauges on
    and off, ``cuda``, ``fixed`` (16-bit LSQ) and ``goap``, every bucket
    captured at warm-up, every bucket's replay bit-equal to the eager
    step on the same frames (logits, and counters with gauges), 20
    replays launching exactly 20 times what the capture recorded; prints
    the step host to host, captured and eager, in turns;
18. runs the serving CLI in process (``serve_cli_phase``: ``python -m
    repro_torch.launch.serve --arch saocds-amc --batch 64 --requests 512
    --replicas 2 --metrics-port 0 --slo default --trace-dump ...
    --perfetto-dump ... --hold-s 5``): during the hold ``/readyz`` answers
    200, ``/metrics`` counts the 512 requests across both replicas, and
    ``/healthz``, ``/timeseries`` and ``/alerts`` parse; every trace runs
    submit -> complete with admits on both replicas, the Perfetto dump
    validates, no request failed, and the CLI's predictions equal the
    plain ``goap`` backend's; then one replica serves the same requests
    in two windows, one with tracing, ``/metrics`` and the SLOs and one
    without, each printed (``cli_window``: frames/s, p50/p99, the
    collector's passes and the SLO thread's longest sweep) and each
    failing the phase unless it served all of its requests within 120 s;
19. serves the 256 requests data-parallel (``mesh_phase``:
    ``AsyncAMCServeEngine(mesh=serve_mesh())`` over every local card,
    ``backend="auto"``, batch 64): predictions equal to the unsharded
    engine's and ``goap``'s, buckets aligned to the mesh, every batch by
    graph replay on every card, only the winner's kernels (the fused one
    when ``cuda_fused`` wins); prints the sharded step beside the
    unsharded one, host to host;
20. runs the 4-stage SNN pipeline of ``repro_torch.examples.snn_pipeline``
    on the card (``pipeline_phase``): logits within 1e-5 of the
    unpipelined ``dense`` forward and of the same pipeline on the CPU;
    prints its seconds;
21. runs the five SNN examples in process on the card with tiny budgets
    (``examples_phase``; each must return 0);
22. runs the language-model zoo (``zoo_phase``, with the launch counts set
    to 0 just before it and read just after: it must launch none of the
    seven kernel forms).  All 10 architectures at their reduced configs, the
    same params on the card and on the CPU: the card's
    ``lm_forward`` / ``whisper_forward`` logits within 1e-4 of the CPU's,
    one ``LMTrainer`` step's loss within 1e-5 relative of the CPU's, and
    ``prefill(t[:-1]) + decode(t[-1])`` equal to ``forward(t)``'s last
    logits within 2e-2 (MoE at capacity factor 8.0).  qwen1.5-0.5b at
    full width: ``launch.train.main(["--arch", "qwen1.5-0.5b", "--scale",
    "full", "--steps", "4", "--batch", "4", "--seq", "256"])`` exits 0
    with a finite loss; a trainer at that size is timed (median step ms
    host to host, each step waited for), profiled (the card's busy share
    of a step, ``torch.profiler``) and its peak memory read
    (``torch.cuda.max_memory_allocated``); ``launch.serve.generate`` on
    its params (batch 4, prompt 64, 32 new tokens) gives tokens/s; the
    prefill/decode gate holds at full width.  mamba2-780m at full width:
    ``lm_forward`` at batch 2 x seq 256, timed, and the same gate.  Prints
    ``zoo_phase`` with every number beside the card's name and power
    limit.  Its full-width trainer and generation run op by op
    (``capture=False``): the eager baseline of the cells phase;
23. runs the zoo's production cells (``cells_phase``, with the launch
    counts set to 0 just before it and read just after: it must launch
    none of the seven kernel forms), each step captured in a CUDA graph and
    held bit for bit to the same step op by op: the qwen1.5-0.5b train
    cell (``train_4k``'s seq 4096, global batch cut to 4, a 1-card mesh;
    3 steps: loss, gradient norm, params and moments), the mamba2-780m
    ``long_500k`` decode cell at its published shape (16 steps: logits
    and state), the qwen1.5-0.5b ``prefill_32k`` cell at batch 1 (logits
    and state; seq cut to 8,192 if its capture took over 30 s); then
    ``LMTrainer`` at the zoo phase's size captured, op by op, and captured
    without recomputation, and ``Generator`` captured against op by op
    (tokens equal); the dry-runs ``run_cell("mamba2-780m", "long_500k",
    "multi")``, ``run_cell("qwen1.5-0.5b", "train_4k", "single")`` and
    ``pp_dryrun.run()`` in process; ``streaming_roofline(SNNConfig(),
    batch=64)``'s target beside the fused kernel's frames/s.  Prints
    ``cells_phase`` with step ms captured and eager, idle shares, peak
    memory, counted TFLOP/s, tokens/s, beside the card's name and power
    limit;
24. prints the whole run's seconds, one JSON line of per-kernel results,
    the card, and last ``{"ok": true, "device": {...}}``.

Any mismatch or exception ends the run with a non-zero exit code.
"""
from __future__ import annotations

import contextlib
import json
import os
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
# dense bf16 rate of the tensor cores (a multiply-add counts two)
PEAK_BF16_FLOPS = 989e12
BATCH = 64
REQUESTS = 256
SEED = 0
DENSITY = 0.5
# the O'Shea-2018 SNN (arXiv:1712.04578, Table III) at its published
# widths, and its masks' density
OSHEA = dict(conv_specs=((3, 2, 64),) + ((3, 64, 64),) * 6, pool=2,
             fc_specs=((512, 128), (128, 128), (128, 24)), input_width=1024,
             timesteps=8, n_classes=24)
OSHEA_DENSITY = 0.2
ATOL = 1e-5
# the train phase: steps in all, the step of the resume checkpoint, and its
# gates on one step, card against CPU
TRAIN_STEPS = 40
TRAIN_RESUME_AT = 20
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# the captured-against-eager gate: steps from one state (a schedule of that
# many steps, masks recomputed every 2, so reprunes fall inside), then
# steps timed one at a time and back to back
CAPTURE_GATE_STEPS = 8
STEP_TIMING_STEPS = 5


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
    """Bytes of the tensors given (None, as a LIF's absent v0, is none)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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


def check_fused(chk, stack, x, encode: bool, plan=None, work=None) -> None:
    """The whole-network kernel on ``x`` (with ``plan``, default the
    planner's) against its plain version: logits and counters bit for bit."""
    import torch

    from repro_torch.kernels import stream_fused_forward, stream_fused_forward_ref

    got_l, got_a = stream_fused_forward(stack, x, encode=encode, plan=plan)
    want_l, want_a = stream_fused_forward_ref(stack, x, encode=encode, work=work)
    torch.cuda.synchronize()
    what = (f"encode={encode} batch {x.shape[0]}"
            + ("" if plan is None else f" {plan.spikes} layout"))
    chk.close(got_l, want_l, ATOL, f"logits {what}")
    chk.close(got_a, want_a, 0.0, f"conv_accs {what}")
    n_same = int((got_l == want_l).all(-1).sum())
    print(f"  {chk.name} {what}: {n_same}/{x.shape[0]} "
          "samples with bit-equal logits")
    if n_same != x.shape[0]:
        raise AssertionError(f"{chk.name} {what}: logits not "
                             "bit-equal to the plain version")


def fused_row(stack, iq, frames_b, timers, model: str) -> dict:
    """Phase 4 and 6 for the whole-network kernel on ``stack``: both input
    modes at the served batch and at batch 1 (the lone-request bucket),
    each with the planner's launch, then timed, with its bound."""
    import torch

    from repro_torch.core.encoder import normalize_iq
    from repro_torch.kernels import stream_fused_forward, stream_fused_forward_ref

    analog = normalize_iq(iq)
    chk = Check("stream_fused_forward" + ("" if model == "paper" else f" ({model})"))
    work = {}
    check_fused(chk, stack, frames_b, False, work=work)
    for encode, x in ((True, analog), (False, frames_b[:1]), (True, analog[:1])):
        check_fused(chk, stack, x, encode)
    operands = [frames_b]
    for layer in stack.layers:
        for f in ("w_cm", "counts", "lif", "w"):
            if hasattr(layer, f):
                operands.append(torch.as_tensor(getattr(layer, f)))
    n_b = nbytes(*operands) + 4 * frames_b.shape[0] * (stack.n_classes + stack.n_convs)
    n_ops = work["conv_adds"] + work["fc_adds"] + 4 * work["lif_updates"]
    b_ms, b_by = bound_ms(n_b, n_ops)
    one = frames_b[:1]
    return dict(
        name="stream_fused_forward", model=model, route="cuda",
        source="src/repro_torch/csrc/stream_fused.cu",
        replaces="src/repro/kernels/stream_fused.py:210",
        max_abs_err=chk.max_abs_err,
        ms=timers.graph(lambda: stream_fused_forward(stack, frames_b)),
        call_ms=timers.call(lambda: stream_fused_forward(stack, frames_b)),
        plain_ms=timers.call(lambda: stream_fused_forward_ref(stack, frames_b)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        plan=fused_plan(stack, frames_b),
        ms_batch1=timers.graph(lambda: stream_fused_forward(stack, one)),
        plan_batch1=fused_plan(stack, one))


def bits_plan(stack, batch: int, device):
    """The planner's launch for ``batch`` with the bit layout forced, the
    card's occupancy asked as :func:`launch_plan` asks it."""
    from repro_torch.kernels import stream_fused as sf

    on_card = device.type == "cuda"
    return sf.plan_stream_fused_launch(
        stack, batch, n_sms=sf._n_sms(device) if on_card else sf.N_SMS,
        active_clusters=sf._active_clusters if on_card else None,
        spikes="bits")


def oshea_model(device, seed: int = SEED) -> dict:
    """The O'Shea-2018 SNN at its published widths: config, params,
    masks, its ``cuda_fused`` plan, REQUESTS seeded I/Q frames and the
    first BATCH of them on the card and Σ-Δ-encoded."""
    import numpy as np
    import torch

    from repro_torch.api import (SNNConfig, compile_plan, compile_snn, init_snn,
                                 make_mask_pytree)
    from repro_torch.data.pipeline import sigma_delta_encode_batch

    cfg = SNNConfig(**OSHEA).validate()
    params = init_snn(seed, cfg)
    masks = make_mask_pytree(params, OSHEA_DENSITY)
    iq = np.random.default_rng(seed + 1).normal(
        size=(REQUESTS, cfg.conv_specs[0][1], cfg.input_width)).astype(np.float32)
    iq_dev = torch.as_tensor(iq[:BATCH], device=device)
    return dict(cfg=cfg, params=params, masks=masks, iq=iq, iq_dev=iq_dev,
                frames_b=sigma_delta_encode_batch(iq_dev, cfg.timesteps),
                plan=compile_plan(compile_snn(cfg), params, masks=masks,
                                  assignment="cuda_fused", device=device))


def check_kernels(plan, iq, frames_b, timers, oshea):
    """Phase 4 and 6: each kernel against its plain version, then timed;
    the whole-network kernel on the paper model (in both layouts) and on
    ``oshea`` (:func:`oshea_model`).

    ``ms`` and ``library_ms`` are device times by CUDA-graph replay;
    ``call_ms`` and ``plain_ms`` are single calls between CUDA events,
    host work included (the plain versions are host-driven loops).
    Returns per-kernel rows (without launch counts)."""
    from repro_torch.kernels import stream_fused_forward

    stack = plan.fused_stack()
    rows = [fused_row(stack, iq, frames_b, timers, "paper")]
    # the bit layout on the paper model, which the planner keeps in f32
    chk = Check("stream_fused_forward")
    one = frames_b[:1]
    bits = {x.shape[0]: bits_plan(stack, x.shape[0], x.device)
            for x in (frames_b, one)}
    for x in (frames_b, one):
        check_fused(chk, stack, x, False, plan=bits[x.shape[0]])
    b64, b1 = bits[frames_b.shape[0]], bits[1]
    rows[0].update(
        ms_bits=timers.graph(lambda: stream_fused_forward(stack, frames_b,
                                                          plan=b64)),
        ms_bits_batch1=timers.graph(lambda: stream_fused_forward(stack, one,
                                                                 plan=b1)),
        plan_bits=fused_plan(stack, frames_b, b64))
    o_stack = oshea["plan"].fused_stack()
    rows.append(fused_row(o_stack, oshea["iq_dev"], oshea["frames_b"], timers,
                          "oshea2018"))
    if rows[-1]["plan"]["spikes"] != "bits":
        raise AssertionError("the planner did not hold the O'Shea-2018 SNN "
                             "in the bit layout")

    # -- the per-layer kernels, on the plan's layer-by-layer path ----------
    checks, calls = check_per_layer(plan, frames_b)
    floor_ms = launch_floor(frames_b.device)
    for name, kernel in PER_LAYER.items():
        plain = _plain(name)
        records = calls[name]
        b_ms, b_by = bound_ms(sum(c["bytes"] for c in records),
                              sum(c["ops"] for c in records))

        def total(clock, fn_of):
            return sum(clock(fn_of(c)) for c in records)

        def launch(c):
            return lambda: _kernel(name)(*c["args"], **c["kwargs"])

        per_ms = [timers.graph(launch(c)) for c in records]
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{kernel}.cu",
            replaces=REPLACES[name], max_abs_err=checks[name].max_abs_err,
            inorder_max_abs_err=checks[name].inorder_max_abs_err,
            ms=sum(per_ms), per_launch_ms=per_ms, launch_floor_ms=floor_ms,
            call_ms=total(timers.call, launch),
            plain_ms=total(timers.call, lambda c: lambda: plain(
                *c["args"], **plain_kwargs(name, c["kwargs"]))),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=(None if records[0]["library"] is None else
                        total(timers.graph, lambda c: c["library"])),
            note=LIF_BOUND_NOTE if name == "lif_update_fused" else None))
    return rows


def launch_floor(device):
    """Device ms of one replayed launch of an empty kernel of ours (one
    block of 32 threads): the fixed cost under every launch's ``ms``
    (None off the card)."""
    from repro_torch.kernels.timing import launch_floor_ms

    return launch_floor_ms(device) if device.type == "cuda" else None


# what the LIF forms' bound counts
LIF_BOUND_NOTE = ("ms sums a batch's launches (per_launch_ms); bound: the "
                  "currents in, the spikes and final membrane out, the C-long "
                  "per-channel alpha, theta and v_th (and v0 where one is "
                  "given; none on the layered path)")


def fused_plan(stack, frames, plan=None):
    """The launch the planner gives the whole-network kernel for this batch
    (or ``plan``), and how many such clusters the card holds at once."""
    from repro_torch.kernels.stream_fused import launch_plan, max_active_clusters

    if plan is None:
        plan = launch_plan(stack, frames.shape[0], frames.device)
    return dict(spikes=plan.spikes, cluster=plan.cluster, threads=plan.threads,
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


def plain_kwargs(name, kwargs):
    """The keywords a kernel call passes on to its plain version: the LIF's
    channel layout (``inner``); the conv's block sizes are its operands'
    shapes there."""
    return kwargs if name.startswith("lif_update_fused") else {}


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
            want = _plain(name)(*args, **plain_kwargs(name, kwargs))
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
    # LIF: multiply, add, compare, subtract per neuron and timestep; its
    # bytes (nbytes of the call) are the currents, the C-long parameters,
    # v0 where one is given, the spikes and the final membrane
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
        graphs = engine.get_version(engine.active_version).graphs
        captured = len(graphs.shapes()) if graphs is not None else 0
        replays = graphs.replays if graphs is not None else 0
    torch.cuda.synchronize()
    served = launch_counts()
    print(f"main path, served: {len(preds)} requests in "
          f"{time.perf_counter() - t0:.3f} s; launches {served}; "
          f"{captured} graphs captured, {replays} replays")
    expect_launches(served, {"stream_fused_forward"}, "served path")
    # served only by graph replay: one eager launch per captured shape
    # (the warm-up before its capture), every other launch a replay's
    if graphs is None or served["stream_fused_forward"] != captured + replays:
        raise AssertionError("the served cuda_fused step did not run by "
                             "graph replay alone")

    reset_launch_counts()
    layered = engine.plan.bound.batch(frames_b)
    torch.cuda.synchronize()
    per_layer = launch_counts()
    print(f"main path, layer by layer: one batch of {frames_b.shape[0]}; "
          f"launches {per_layer}")
    expect_launches(per_layer, set(PER_LAYER), "layer-by-layer path")
    return preds, stats, engine, layered, {"served": served,
                                           "layered": per_layer}


def run_oshea_main_path(oshea, device) -> dict:
    """Phase 5 on the O'Shea-2018 SNN, with the launch counts set to 0 just
    before it and read just after: the engine serves its REQUESTS frames
    by graph replay of the whole-network kernel alone, each captured
    bucket's launch noted in the bit layout, with the layered ``cuda``
    path's predictions.  Returns the launches."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine, compile_plan, compile_snn
    from repro_torch.data.pipeline import sigma_delta_encode_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import step_launches

    cfg, iq = oshea["cfg"], oshea["iq"]
    reset_launch_counts()
    t0 = time.perf_counter()
    with AsyncAMCServeEngine(oshea["params"], cfg, oshea["masks"],
                             backend="cuda_fused", max_batch=BATCH,
                             device=device) as engine:
        futures = [engine.submit(frame) for frame in iq]
        preds = np.array([f.result(timeout=600) for f in futures])
        ver = engine.get_version(engine.active_version)
        graphs = ver.graphs
        captured = len(graphs.shapes()) if graphs is not None else 0
        replays = graphs.replays if graphs is not None else 0
        noted = ({s[0]: step_launches(ver, s) for s in graphs.shapes()}
                 if graphs is not None else {})
    torch.cuda.synchronize()
    served = launch_counts()
    print(f"O'Shea-2018 path, served: {len(preds)} requests in "
          f"{time.perf_counter() - t0:.3f} s; launches {served}; "
          f"{captured} graphs captured, {replays} replays; noted "
          + json.dumps({b: [(ln.spikes, ln.cluster, ln.waves) for ln in n]
                        for b, n in sorted(noted.items())}))
    expect_launches(served, {"stream_fused_forward"}, "O'Shea-2018 served path")
    if graphs is None or served["stream_fused_forward"] != captured + replays:
        raise AssertionError("the served O'Shea-2018 step did not run by "
                             "graph replay alone")
    if not noted or any(len(n) != 1 or n[0].spikes != "bits"
                        for n in noted.values()):
        raise AssertionError("a captured O'Shea-2018 bucket did not note "
                             "one bit-layout launch")
    layered = compile_plan(compile_snn(cfg), oshea["params"], masks=oshea["masks"],
                           assignment="cuda", device=device)
    want = np.concatenate([
        layered.bound.batch(sigma_delta_encode_batch(
            torch.as_tensor(chunk, device=device), cfg.timesteps)
        ).argmax(-1).cpu().numpy()
        for chunk in np.split(iq, REQUESTS // BATCH)])
    n_diff = int((preds != want).sum())
    print(f"  O'Shea-2018 engine predictions vs the layered cuda path: "
          f"{n_diff} of {len(preds)} differ")
    if n_diff:
        raise AssertionError(f"{n_diff} served O'Shea-2018 predictions differ "
                             "from the layered cuda path")
    return served


def run(device, timers: Timers, seed: int = SEED,
        parent: typing.Optional[pathlib.Path] = None):
    """Phases 3-23 on ``device`` (``parent``: an earlier tree the operands
    phase also probes); returns the kernels JSON object."""
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

    oshea = oshea_model(device, seed)
    print("phase: kernels against their plain versions")
    rows = check_kernels(plan, iq_dev, frames_b, timers, oshea)

    print("phase: main path")
    preds, stats, engine, layered, launches = run_main_path(
        params, masks, cfg, iq, frames_b, device)
    launches["oshea"] = run_oshea_main_path(oshea, device)
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
        path = ("oshea" if row.get("model") == "oshea2018" else
                "served" if row["name"] == "stream_fused_forward" else "layered")
        row["launches"] = launches[path][row["name"]]
        row["launches_by_path"] = {p: c[row["name"]] for p, c in launches.items()}
    keys = ("name", "model", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "inorder_max_abs_err", "ms",
            "per_launch_ms", "launch_floor_ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "plan", "ms_batch1",
            "plan_batch1", "ms_bits", "ms_bits_batch1", "plan_bits", "note")
    result = {"kernels": [{k: row.get(k) for k in keys} for row in rows]}

    print("phase: bf16")
    bf16_rows, bf16_served = run_bf16_phase(device, timers, seed)
    for row in bf16_rows:
        row["launches"] = bf16_served[row["name"]]
        row["launches_by_path"] = {p: c[row["name"]] for p, c in launches.items()}
    result["kernels"] += [{k: row.get(k) for k in keys} for row in bf16_rows]
    if device.type == "cuda":     # each probe is a process of its own on the card
        print("phase: operands")
        run_operands_phase(parent)
    print("phase: stream")
    stream_plan = run_stream_phase(program, params, masks, plan, frames_b,
                                   device, timers)
    print("phase: gauges")
    run_gauges_phase(params, masks, cfg, iq, preds, stream_plan, device, timers)
    print("phase: fixed")
    run_fixed_phase(params, masks, cfg, iq, device, timers)
    print("phase: train")
    paths = {"bf16": bf16_served}
    paths["trained"], trained = run_train_phase(cfg, device, timers, seed)
    print("phase: compression")
    run_compression_phase(trained, device)
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
    print("phase: robustness")
    paths["robustness"] = run_robustness_phase(device)
    print("phase: lifecycle")
    paths["lifecycle"] = run_lifecycle_phase(device)
    print("phase: capture")
    paths["capture"] = run_capture_phase(params, masks, cfg, iq, device,
                                         timers)
    print("phase: serve_cli")
    paths["serve_cli"] = run_serve_cli_phase(cfg, device)
    print("phase: mesh")
    paths["mesh"] = run_mesh_phase(params, masks, cfg, iq, preds, want,
                                   device, timers)
    print("phase: pipeline")
    run_pipeline_phase(device)
    print("phase: examples")
    run_examples_phase(device)
    print("phase: zoo")
    paths["zoo"] = run_zoo_phase(device, seed)["launches"]
    print("phase: cells")
    fused_ms = next(row["ms"] for row in rows
                    if row.get("model") == "paper")
    paths["cells"] = run_cells_phase(device, fused_ms, seed)["launches"]
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

    return TrainerConfig(**{
        "total_steps": TRAIN_STEPS, "batch_size": BATCH, "snr_db": 10.0,
        "osr": cfg.timesteps,
        "per_layer_density": DENSITY_CONFIGS["saocds-25-20-15-20-25"],
        "prune_every": 10, "use_lsq": True, "quant_bits": 16, **overrides})


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


def step_ms(trainer, steps: int) -> dict:
    """A trainer's step host to host: each step waited for (median ms),
    and ``steps`` steps back to back with one wait at the end (ms a step),
    as ``launch.train`` runs them."""
    import torch

    waited = []
    for _ in range(steps):
        t0 = time.perf_counter()
        trainer.run(steps=1, log_every=1)
        torch.cuda.synchronize()
        waited.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    trainer.run(steps=steps, log_every=steps)
    torch.cuda.synchronize()
    return {"step_ms_waited": statistics.median(waited),
            "step_ms_back_to_back": (time.perf_counter() - t0) * 1e3 / steps}


def check_capture_against_eager(cfg, device) -> dict:
    """Gate 5: CAPTURE_GATE_STEPS steps captured and as many op by op,
    from one state (Table V densities, 16-bit LSQ, masks recomputed every
    2 steps over a schedule of that length, so the reprunes fall inside):
    every leaf of params, optimizer state, masks and LSQ scales
    ``torch.equal``, the losses equal; one capture for the one variant
    across the reprunes; a params tree read before the steps unchanged
    after them; ``evaluate()`` equal, its logits bit for bit, captured,
    eager and through the ``dense`` plan.  Then each trainer's step timed
    and profiled in turns."""
    import numpy as np
    import torch

    from repro_torch.api import compile_snn
    from repro_torch.train import SNNTrainer
    from repro_torch.tree import tree_leaves

    tcfg = train_config(cfg, total_steps=CAPTURE_GATE_STEPS, prune_every=2)
    cap = SNNTrainer(cfg, tcfg, device=device)
    eager = SNNTrainer(cfg, tcfg, device=device, capture=False)
    if not cap.capture or eager.capture:
        raise AssertionError("the trainer does not capture by default on "
                             "the card")
    before = cap.params
    before_copy = [x.clone() for x in tree_leaves(before)]
    seconds = {}
    t0 = time.perf_counter()
    h_cap = cap.run(steps=CAPTURE_GATE_STEPS, log_every=1)
    torch.cuda.synchronize()
    seconds["captured_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_eager = eager.run(steps=CAPTURE_GATE_STEPS, log_every=1)
    torch.cuda.synchronize()
    seconds["eager_steps"] = time.perf_counter() - t0
    # the first captured step: warm-ups, capture and one replay
    seconds["first_captured_step"] = cap.step_times[0]
    t0 = time.perf_counter()
    reprunes = [s for s in range(CAPTURE_GATE_STEPS)
                if s % 2 == 0 and s < 0.8 * CAPTURE_GATE_STEPS]
    leaves_c = tree_leaves(cap._state_tree())
    leaves_e = tree_leaves(eager._state_tree())
    n_diff = sum(not torch.equal(x, y) for x, y in zip(leaves_c, leaves_e))
    unchanged = all(torch.equal(x, y) for x, y in
                    zip(tree_leaves(before), before_copy))
    moved = not all(torch.equal(x, y) for x, y in
                    zip(tree_leaves(cap.params), before_copy))
    frames, _ = cap._host_batch(10_000, 10.0)
    logits_c = cap._eval_logits(frames, True)
    logits_e = eager._eval_logits(frames, True)
    logits_plan = compile_snn(cfg).apply_batch(
        cap.params, frames, "dense", masks=cap.masks, device=device
    ).cpu().numpy()
    acc_c, acc_e = cap.evaluate(snr_db=10.0), eager.evaluate(snr_db=10.0)
    seconds["evaluate"] = time.perf_counter() - t0
    line = {"steps": CAPTURE_GATE_STEPS, "reprune_steps": reprunes,
            "leaves": len(leaves_c), "leaves_differ": n_diff,
            "losses_captured": h_cap["loss"], "losses_eager": h_eager["loss"],
            "train_captures": cap._steps.captures,
            "train_variants": [list(map(str, k)) for k in cap._steps.keys()],
            "read_tree_unchanged": unchanged, "params_moved": moved,
            "evaluate_captured": acc_c, "evaluate_eager": acc_e,
            "eval_logits_equal": bool(np.array_equal(logits_c, logits_e)),
            "eval_equal_to_plan": bool(np.array_equal(logits_c, logits_plan)),
            "eval_captures": cap._evals.captures}
    print(f"  captured vs eager: {json.dumps(line)}")
    if (len(leaves_c) != len(leaves_e) or n_diff
            or h_cap["loss"] != h_eager["loss"]
            or len(h_cap["loss"]) != CAPTURE_GATE_STEPS):
        raise AssertionError("the captured training steps differ from the "
                             "eager ones")
    if cap._steps.captures != 1 or len(cap._steps.keys()) != 1:
        raise AssertionError("the train step was captured more than once "
                             "for its one variant")
    if not (unchanged and moved):
        raise AssertionError("a params tree read before a step changed after "
                             "it, or the steps did not move the params")
    if not (acc_c == acc_e and line["eval_logits_equal"]
            and line["eval_equal_to_plan"]):
        raise AssertionError("the captured evaluate() differs from the eager "
                             "one or from the dense plan")
    # where a step's time goes, captured and eager in turns
    t0 = time.perf_counter()
    timed = {}
    for mode, tr in (("captured", cap), ("eager", eager),
                     ("eager", eager), ("captured", cap)):
        t = step_ms(tr, STEP_TIMING_STEPS)
        for k, v in t.items():
            timed.setdefault(mode, {}).setdefault(k, []).append(v)
    seconds["timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for mode, tr in (("captured", cap), ("eager", eager)):
        prof = profile_steps(lambda: tr.run(steps=1, log_every=1))
        busy = prof["device_busy_ms"]
        waited = statistics.median(timed[mode]["step_ms_waited"])
        prof["device_idle_share"] = None if busy is None else 1.0 - busy / waited
        timed[mode]["profile"] = prof
    seconds["profile"] = time.perf_counter() - t0
    if cap._steps.captures != 1:
        raise AssertionError("the timed steps captured the step again")
    line["timed"] = timed
    line["seconds"] = seconds
    line["card"] = nvidia_smi()
    print(f"  step timing: {json.dumps(timed)} ({line['card']})")
    return line


def run_train_phase(cfg, device, timers, seed: int = SEED):
    """Phase 8: train the model on the card (captured steps), hold
    captured steps to eager ones, resume bit for bit, serve the trained
    model through the whole-network kernel.  Returns the served path's
    launch counts and the trained trainer."""
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
            "one_step": check_step_against_cpu(cfg, device),
            "captured_vs_eager": check_capture_against_eager(cfg, device)}
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
    return counts, a


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


# the robustness phase: launch.eval's arguments (one batch of 64 frames per
# cell and backend)
EVAL_ARGS = ["--suite", "default", "--snr=-10,0,10,18", "--frames", "64",
             "--backend", "cuda_fused,cuda,goap", "--seed", str(SEED),
             "--density", str(DENSITY)]
# the lifecycle phase: requests in all, in waves WAVE_GAP_S apart; the
# hot-swap starts at wave SWAP_WAVE, the waves go on while it binds and
# flips, and the last LATE_WAVES waves wait for its end
LIFECYCLE_REQUESTS = 512
WAVE = 16
WAVE_GAP_S = 0.008
SWAP_WAVE = 8
LATE_WAVES = 4


def run_robustness_phase(device) -> dict:
    """``repro_torch.launch.eval.main`` at full width: the default suite (5
    scenarios) x 4 SNRs x ``cuda_fused,cuda,goap``, 64 frames a cell, fresh
    weights (seed 0, density 0.5), in process.  Gates: exit 0; logits
    within 1e-5 across the backends; their predictions equal on every frame
    of every cell (clean section included); each kernel launched as the
    cells require; and, for one cell of each of the 7 named scenarios, the
    card's impaired frames equal to the CPU's within 1e-5.  Returns the
    window's launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import SNNConfig
    from repro_torch.channel import SCENARIOS, apply_scenario_np
    from repro_torch.data.radioml import generate_batch
    from repro_torch.eval import robustness, stable_cell_seed
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import eval as launch_eval

    # every batch's logits per backend, in call order: the report keeps
    # only accuracies and the largest difference, and the gate is on
    # every frame
    logits_by = {}
    backend_step = robustness._backend_step

    def recording_step(program, params, model_cfg, backend, *args):
        step = backend_step(program, params, model_cfg, backend, *args)

        def recorded(iq):
            logits = step(iq)
            logits_by.setdefault(backend, []).append(logits)
            return logits
        return recorded

    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    out = pathlib.Path(work) / "robustness_report.json"
    robustness._backend_step = recording_step
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = launch_eval.main(EVAL_ARGS + ["--out", str(out)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        report = json.loads(out.read_text())
    finally:
        robustness._backend_step = backend_step
        shutil.rmtree(work, ignore_errors=True)
    # per cell: one whole-network launch (cuda_fused), and per weighted
    # layer one conv or FC launch and one LIF launch (cuda)
    n_cells = (len(report["scenarios"]) + 1) * len(report["config"]["snr_grid"])
    cfg = SNNConfig()
    n_conv, n_fc = len(cfg.conv_specs), len(cfg.fc_specs)
    want_counts = {**{k: 0 for k in counts},
                   "stream_fused_forward": n_cells,
                   "goap_conv_block_sparse": n_conv * n_cells,
                   "wm_fc_matmul": n_fc * n_cells,
                   "lif_update_fused": (n_conv + n_fc) * n_cells}
    print(f"  launch.eval exit {rc}; {n_cells} cells x "
          f"{report['config']['frames_per_cell']} frames; launches {counts} "
          f"(cells require {want_counts})")
    if rc != 0:
        raise AssertionError(f"launch.eval exited {rc}")
    if counts != want_counts:
        raise AssertionError(f"robustness window launched {counts}, not "
                             f"{want_counts}")
    if (sorted(report["wall_s_by_backend"]) != sorted(logits_by)
            or len(logits_by) != 3):
        raise AssertionError("a backend is missing from the evaluation")
    agreement = report["agreement"]
    if not agreement["max_abs_logit_diff"] <= ATOL:
        raise AssertionError(f"backends disagree: {agreement}")
    primary = logits_by["cuda_fused"]
    n_frames = sum(len(lg) for lg in primary)
    n_diff = {b: int(sum((lg.argmax(-1) != p.argmax(-1)).sum()
                         for lg, p in zip(lgs, primary)))
              for b, lgs in logits_by.items()}
    max_diff = {b: float(max(np.abs(lg - p).max() for lg, p in zip(lgs, primary)))
                for b, lgs in logits_by.items()}
    print(f"  predictions over {n_frames} frames differing from cuda_fused's: "
          f"{n_diff}; max |dlogit| against cuda_fused's {max_diff}")
    if (n_frames != n_cells * report["config"]["frames_per_cell"]
            or any(n_diff.values())):
        raise AssertionError(f"backend predictions differ: {n_diff}")

    # the channel on the card against the CPU, one cell per scenario
    channel_err = {}
    for name, sc in SCENARIOS.items():
        seed = stable_cell_seed(name, 0.0)
        iq, _, snrs = generate_batch(seed, 64, snr_db=0.0,
                                     apply_channel=False)
        card = apply_scenario_np(sc, iq, snrs, seed, device=device)
        cpu = apply_scenario_np(sc, iq, snrs, seed, device="cpu")
        channel_err[name] = float(np.abs(card - cpu).max())
    print(f"  impaired frames, card vs CPU (max |err|): {channel_err}")
    if not all(np.isfinite(e) and e <= ATOL for e in channel_err.values()):
        raise AssertionError(f"the channel on the card disagrees with the "
                             f"CPU's: {channel_err}")
    print("robustness_phase " + json.dumps({
        "seconds": seconds, "cells": n_cells,
        "surface": report["surface"], "clean": {
            snr: cell["accuracy"]["cuda_fused"]
            for snr, cell in report["clean"].items()},
        "wall_s_by_backend": report["wall_s_by_backend"],
        "max_abs_logit_diff": agreement["max_abs_logit_diff"],
        "max_abs_logit_diff_vs_cuda_fused": max_diff,
        "channel_card_vs_cpu": channel_err, "launches": counts,
        "card": nvidia_smi()}))
    return counts


def run_lifecycle_phase(device) -> dict:
    """Publish v1 (seed 0) and v2 (seed 1) at density 0.5 to a registry in a
    temporary directory (publishing v1 again must return v1), serve v1 with
    ``AsyncAMCServeEngine(backend="cuda_fused")``, submit 512 requests in
    waves of 16, 8 ms apart, and hot-swap to v2 from the registry from the
    ninth wave on, while the waves go on.
    Gates: no failed request; each served by v1 or v2 (by its trace); each
    submitted after the swap's drain barrier served by v2 with the plain
    goap backend's predictions on v2's weights; the whole window launches
    the whole-network kernel and nothing else; and a fresh registry and
    plan cache on the same directories reload v2's plan from the disk tier
    without building an artifact.  Then a canary monitor runs three rounds
    on urban_fading frames.  Returns the window's launches."""
    import collections
    import concurrent.futures
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import (AsyncAMCServeEngine, SNNConfig, compile_plan,
                                 compile_snn, init_snn, make_mask_pytree)
    from repro_torch.channel import make_frame_source
    from repro_torch.data.pipeline import sigma_delta_encode_np
    from repro_torch.deploy import (CanaryMonitor, ModelRegistry,
                                    MonitorConfig, canary_router,
                                    hot_swap_from_registry)
    from repro_torch.fixed import serving_quant_fn
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.graph import artifact_build_count
    from repro_torch.obs.trace import TraceLog
    from repro_torch.plan import PlanCache, default_cache, set_default_cache

    cfg = SNNConfig()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_lifecycle_"))
    root, plans = str(work / "registry"), str(work / "plans")
    old_cache = default_cache()
    set_default_cache(PlanCache(plans))
    t_phase = time.perf_counter()
    try:
        registry = ModelRegistry(root, device=device)
        published = {}
        for label, seed in (("production", 0), ("staging", 1)):
            params = init_snn(seed, cfg)
            t0 = time.perf_counter()
            v = registry.publish("amc", params, cfg,
                                 masks=make_mask_pytree(params, DENSITY),
                                 assignment="cuda_fused", alias=label)
            published[v.spec] = time.perf_counter() - t0
        params = init_snn(0, cfg)
        again = registry.publish("amc", params, cfg,
                                 masks=make_mask_pytree(params, DENSITY),
                                 assignment="cuda_fused")
        print(f"  published {published} (seconds); v1 again -> {again.spec}")
        if again.version != 1 or registry.versions("amc") != [1, 2]:
            raise AssertionError("publishing v1 again minted a version")

        v1 = registry.load("amc@production")
        log = TraceLog(capacity=2 * LIFECYCLE_REQUESTS)
        rng = np.random.default_rng(SEED)
        iq = rng.normal(size=(LIFECYCLE_REQUESTS, cfg.conv_specs[0][1],
                              cfg.input_width)).astype(np.float32)
        reset_launch_counts()
        engine = AsyncAMCServeEngine(v1.params, cfg, v1.masks,
                                     backend="cuda_fused", max_batch=BATCH,
                                     device=device, name="lifecycle",
                                     version_label=v1.version.spec)
        try:
            sent = []    # (future, trace, submitted after the swap returned)
            waves = np.split(iq, LIFECYCLE_REQUESTS // WAVE)
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                swap = None
                for i, wave in enumerate(waves):
                    if i == SWAP_WAVE:
                        swap = pool.submit(hot_swap_from_registry, engine,
                                           registry, "amc@staging")
                    if i == len(waves) - LATE_WAVES:
                        report = swap.result(timeout=600)
                    after = swap is not None and swap.done()
                    for frame in wave:
                        trace = log.begin()
                        sent.append((engine.submit(frame, trace=trace), trace,
                                     after))
                    time.sleep(WAVE_GAP_S)
                results = np.array([f.result(timeout=600) for f, _, _ in sent])
            torch.cuda.synchronize()
            counts = launch_counts()
            # each request's version, from its trace's step event
            tags = [next((e.attrs["version"] for e in trace.events
                          if e.name == "jit-step-start"), None)
                    for _, trace, _ in sent]
            served = dict(collections.Counter(tags))
            late = np.array([after for _, _, after in sent])
            print(f"  {len(results)} requests, 0 failed; served by {served}; "
                  f"{int(late.sum())} submitted after the swap; launches "
                  f"{counts}")
            print(f"  swap {json.dumps(report.summary())}")
            if set(tags) - {"amc@1", "amc@2"} or not late.any():
                raise AssertionError(f"requests served by {served}")
            if any(t != "amc@2" for t, a in zip(tags, late) if a):
                raise AssertionError("a request submitted after the swap was "
                                     "served by v1")
            expect_launches(counts, {"stream_fused_forward"},
                            "lifecycle served path")

            # the canary monitor: v1 (the old production) as a 25% canary
            # beside v2, shadow-evaluated on urban_fading frames
            engine.set_router(canary_router("amc@2", "amc@1", 25.0))
            monitor = CanaryMonitor(
                engine, baseline="amc@2", canary="amc@1",
                config=MonitorConfig(snr_bins=(-10.0, 0.0, 10.0, 18.0),
                                     frames_per_bin=16, min_rounds=2,
                                     score="agreement"),
                frame_source=make_frame_source("urban_fading",
                                               frame_len=cfg.input_width,
                                               device=device),
                registry=registry, canary_spec="amc@1")
            decisions = [monitor.step() for _ in range(3)]
            after_monitor = engine.classify(iq[:BATCH])
            monitor_summary = monitor.summary()
        finally:
            engine.close()
        print(f"  canary monitor decisions {decisions}: "
              f"{monitor_summary['reason']}")

        # v2's predictions by the plain goap backend, for the late requests
        v2 = registry.load("amc@staging")
        program = compile_snn(cfg)
        goap = compile_plan(program, v2.params, masks=v2.masks,
                            assignment="goap", device=device)
        frames = torch.as_tensor(sigma_delta_encode_np(iq[late], cfg.timesteps),
                                 device=device)
        want = goap.bound.batch(frames).argmax(-1).cpu().numpy()
        n_diff = int((results[late] != want).sum())
        print(f"  late requests vs plain goap on v2's weights: {n_diff} of "
              f"{int(late.sum())} differ")
        if n_diff:
            raise AssertionError("requests after the swap differ from goap "
                                 "on v2's weights")
        if after_monitor.shape != (BATCH,):
            raise AssertionError("the engine stopped serving after the "
                                 "monitor")

        # a fresh registry and plan cache on the same directories: v2's plan
        # comes from the disk tier, no artifact is built
        fresh = PlanCache(plans)
        built = artifact_build_count()
        v2 = ModelRegistry(root, device=device).load("amc@staging")
        plan = compile_plan(program, v2.params, masks=v2.masks,
                            assignment="cuda_fused", cache=fresh,
                            quant_fn=serving_quant_fn(None, 16,
                                                      assignment="cuda_fused"),
                            device=device)
        rebuilt = artifact_build_count() - built
        hits = fresh.stats["layer_disk_hits"]
        print(f"  fresh registry: v2 plan {plan.digest[:12]} (manifest "
              f"{v2.version.plan_digest[:12]}), {hits} layers from disk, "
              f"{rebuilt} artifacts built")
        if (plan.digest != v2.version.plan_digest or rebuilt
                or hits != len(cfg.conv_specs)):
            raise AssertionError("the fresh registry did not reload v2 from "
                                 "the disk tier")
    finally:
        set_default_cache(old_cache)
        shutil.rmtree(work, ignore_errors=True)
    print("lifecycle_phase " + json.dumps({
        "seconds": time.perf_counter() - t_phase, "publish_s": published,
        "requests": len(results), "failed": 0, "served_by": served,
        "submitted_after_swap": int(late.sum()), "swap": report.summary(),
        "monitor": {"decisions": decisions, "reason": monitor_summary["reason"],
                    "windowed_baseline": monitor_summary["windowed_baseline"],
                    "windowed_canary": monitor_summary["windowed_canary"]},
        "launches": counts, "card": nvidia_smi()}))
    return counts

# the served steps held captured against eager: (backend, live gauges)
CAPTURED = (("cuda_fused", True), ("cuda_fused", False), ("cuda", False),
            ("fixed", False), ("goap", False))
CAPTURE_REPLAYS = 20


def run_capture_phase(params, masks, cfg, iq, device, timers) -> dict:
    """The served step by CUDA-graph replay against the same step run op
    by op, for each of ``CAPTURED``: the engine's warm-up captured every
    bucket; on every bucket the replay's logits (and counters, with gauges
    on) equal the eager step's bit for bit on the same frames; a window of
    ``CAPTURE_REPLAYS`` replays launches exactly what the capture recorded,
    that many times; and the step host to host, captured and eager, in
    turns.  Returns the replay windows' launches, summed."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.lsq import init_lsq_scales

    ic0, width = cfg.conv_specs[0][1], cfg.input_width
    iq_b = iq[:BATCH]
    line, windows = {}, {}
    t_phase = time.perf_counter()
    for backend, gauges in CAPTURED:
        name = backend + ("+gauges" if gauges else "")
        scales = init_lsq_scales(params, 16) if backend == "fixed" else None
        with AsyncAMCServeEngine(params, cfg, masks, backend=backend,
                                 max_batch=BATCH, device=device,
                                 name=f"capture-{name}", lsq_scales=scales,
                                 activity_gauges=gauges) as engine:
            graphs = engine.get_version(engine.active_version).graphs
            buckets = engine.batcher.buckets
            if graphs is None or set(graphs.shapes()) != {
                    (b, ic0, width) for b in buckets}:
                raise AssertionError(f"{name}: the warm-up did not capture "
                                     f"every bucket {buckets}")
            for b in buckets:
                got, want = graphs(iq[:b]), graphs.eager(iq[:b])
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    raise AssertionError(f"{name}, bucket {b}: the replay "
                                         "differs from the eager step")
            width_out = cfg.n_classes + (len(cfg.conv_specs) if gauges else 0)
            if got.shape != (BATCH, width_out):
                raise AssertionError(f"{name}: output {got.shape}")
            per_replay = graphs.launches((BATCH, ic0, width))
            if backend.startswith("cuda") and not per_replay:
                raise AssertionError(f"{name}: the graph launches no kernel")
            reset_launch_counts()
            for _ in range(CAPTURE_REPLAYS):
                graphs(iq_b)
            torch.cuda.synchronize()
            counts = launch_counts()
            want_counts = {k: CAPTURE_REPLAYS * per_replay.get(k, 0)
                           for k in counts}
            if counts != want_counts:
                raise AssertionError(f"{name}: {CAPTURE_REPLAYS} replays "
                                     f"launched {counts}, not {want_counts}")
            for k, n in counts.items():
                windows[k] = windows.get(k, 0) + n
            steps = [(mode, timers.host(lambda: engine.serve_step(iq_b))
                      if mode == "captured" else
                      timers.host(lambda: graphs.eager(iq_b)))
                     for mode in ("captured", "eager", "eager", "captured")]
        line[name] = {
            "buckets": list(buckets), "bit_equal": True,
            "launches_per_replay": per_replay,
            "step_ms_captured": [ms for m, ms in steps if m == "captured"],
            "step_ms_eager": [ms for m, ms in steps if m == "eager"]}
        print(f"  {name}: every bucket bit-equal; {CAPTURE_REPLAYS} replays "
              f"launched {counts}; step ms captured "
              f"{line[name]['step_ms_captured']}, eager "
              f"{line[name]['step_ms_eager']}")
    print("capture_phase " + json.dumps({
        "seconds": time.perf_counter() - t_phase, "backends": line,
        "card": nvidia_smi()}))
    return windows


CLI_REQUESTS = 512
CLI_HOLD_S = 5.0
# a 1-replica window must have served its requests within this many seconds
CLI_WINDOW_LIMIT_S = 120.0


def _run_cli(argv, until: str = "", limit_s: float = 600.0):
    """``repro_torch.launch.serve.main(argv)`` in a thread, its standard
    output captured.  With ``until``, returns (thread, output, result)
    once a line containing it was printed (the CLI then holds); without,
    after the CLI returned or ``limit_s`` passed."""
    import contextlib
    import io
    import threading

    from repro_torch.launch import serve

    out, result = io.StringIO(), {}

    def cli():
        try:
            with contextlib.redirect_stdout(out):
                result["rc"] = serve.main(argv)
        except BaseException as e:  # noqa: BLE001 — reported by the caller
            result["error"] = repr(e)

    thread = threading.Thread(target=cli, name="serve-cli")
    thread.start()
    deadline = time.perf_counter() + 600
    while until and until not in out.getvalue():
        if not thread.is_alive() or time.perf_counter() > deadline:
            raise AssertionError(f"the CLI stopped before {until!r}: "
                                 f"{result}\n{out.getvalue()}")
        time.sleep(0.05)
    if not until:
        thread.join(timeout=limit_s)
    return thread, out, result


def _cli_stats(text: str) -> dict:
    import re

    head = re.search(r"^requests=(\d+) batches=(\d+) backend=(\S+) .*"
                     r"\((\d+) frames/s\)$", text, re.M)
    lat = re.search(r"^latency p50=(\S+)ms p95=(\S+)ms p99=(\S+)ms", text,
                    re.M)
    if head is None or lat is None:
        raise AssertionError(f"the CLI printed no report:\n{text}")
    return {"requests": int(head.group(1)), "batches": int(head.group(2)),
            "backend": head.group(3), "frames_per_s": int(head.group(4)),
            "p50_ms": float(lat.group(1)), "p95_ms": float(lat.group(2)),
            "p99_ms": float(lat.group(3))}


@contextlib.contextmanager
def window_pauses(t0: float):
    """What could hold a CLI window's workers: the collector's passes
    (``gc.callbacks``: per generation the count and the longest, ms) and
    the SLO thread's sweeps (the longest ``TimeSeriesRecorder.sample`` and
    watcher step, ms), each with its start in seconds after ``t0``; and
    the first submit.  Filled in when the window ends."""
    import gc

    from repro_torch.obs import anomaly, timeseries
    from repro_torch.serve import engine

    found = {"gc": {}, "obs_ms": 0.0, "obs_at_s": None, "first_submit_s": None}
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["gc"] = time.perf_counter()
            return
        ms = (time.perf_counter() - started.pop("gc", time.perf_counter())) * 1e3
        n, worst, at = found["gc"].get(info["generation"], (0, 0.0, None))
        if ms > worst:
            worst, at = ms, time.perf_counter() - t0 - ms / 1e3
        found["gc"][info["generation"]] = (n + 1, worst, at)

    def timed(fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                ms = (time.perf_counter() - t) * 1e3
                if ms > found["obs_ms"]:
                    found["obs_ms"], found["obs_at_s"] = ms, t - t0
        return call

    def first_submit(fn):
        def call(*args, **kwargs):
            if found["first_submit_s"] is None:
                found["first_submit_s"] = time.perf_counter() - t0
            return fn(*args, **kwargs)
        return call

    patched = [(timeseries.TimeSeriesRecorder, "sample"),
               (anomaly.SeriesWatcher, "step"),
               (anomaly.BurnRateWatcher, "step"),
               (engine.AsyncAMCServeEngine, "submit")]
    saved = [getattr(cls, name) for cls, name in patched]
    for (cls, name), fn in zip(patched, saved):
        setattr(cls, name, first_submit(fn) if name == "submit" else timed(fn))
    gc.callbacks.append(on_gc)
    try:
        yield found
    finally:
        gc.callbacks.remove(on_gc)
        for (cls, name), fn in zip(patched, saved):
            setattr(cls, name, fn)
        found["gc"] = {f"gen{g}": {"n": n, "max_ms": worst, "max_at_s": at}
                       for g, (n, worst, at) in sorted(found["gc"].items())}


def cli_window(device, observed: bool, work: pathlib.Path) -> dict:
    """One 1-replica window of the serving CLI: 512 requests at batch 64,
    with tracing, a metrics endpoint and the default SLOs (``observed``)
    or with none of them.  Fails when the window has not served all of
    its requests within CLI_WINDOW_LIMIT_S (a stalled replica) or the CLI
    failed; prints and returns its frames/s and p50/p99."""
    from repro_torch.obs import (disable_tracing, metrics,
                                 set_default_alert_manager,
                                 set_default_recorder)

    argv = ["--arch", "saocds-amc", "--batch", str(BATCH), "--requests",
            str(CLI_REQUESTS), "--device", str(device), "--replicas", "1",
            "--deadline-ms", "600000"]
    if observed:
        argv += ["--metrics-port", "0", "--slo", "default",
                 "--trace-dump", str(work / "window_trace.json"),
                 "--perfetto-dump", str(work / "window_perfetto.json")]
    old = metrics.set_default_registry(metrics.MetricsRegistry())
    t0 = time.perf_counter()
    with window_pauses(t0) as pauses:
        try:
            thread, out, result = _run_cli(argv, limit_s=CLI_WINDOW_LIMIT_S)
        finally:
            metrics.set_default_registry(old)
            disable_tracing()
            set_default_recorder(None)
            set_default_alert_manager(None)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    if thread.is_alive():
        raise AssertionError(f"a 1-replica window (observed={observed}) "
                             f"served nothing to its end within "
                             f"{CLI_WINDOW_LIMIT_S} s:\n{text}")
    if result.get("rc") != 0 or "outcomes:" in text:
        raise AssertionError(f"a 1-replica window failed: {result}\n{text}")
    stats = _cli_stats(text)
    if stats["requests"] != CLI_REQUESTS:
        raise AssertionError(f"a 1-replica window served {stats['requests']} "
                             f"of {CLI_REQUESTS}")
    window = {"observed": observed, "frames_per_s": stats["frames_per_s"],
              "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
              "backend": stats["backend"], "seconds": seconds, **pauses}
    print("cli_window " + json.dumps(window))
    return window


def run_cli_windows(device) -> list:
    """The stalled replica of ROADMAP Queue 3: one 1-replica window with
    tracing, ``/metrics`` and ``--slo default`` on, then one with them off,
    each printed; the observed window is reported as ``stalled`` when it
    serves below a fifth of the unobserved one's frames/s."""
    import shutil
    import tempfile

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_windows_"))
    try:
        windows = [cli_window(device, observed, work)
                   for observed in (True, False)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    on, off = (w["frames_per_s"] for w in windows)
    print("cli_windows " + json.dumps({"stalled": on < off / 5,
                                       "card": nvidia_smi()}))
    return windows


def run_serve_cli_phase(cfg, device) -> dict:
    """``python -m repro_torch.launch.serve --arch saocds-amc`` in process
    at full width: 512 requests at batch 64 through two replicas behind the
    fleet router, a live metrics endpoint, the default SLOs, a trace dump
    and a Perfetto dump, held 5 s.  During the hold: ``/readyz`` answers
    200; ``/metrics`` counts 512 served requests across both replicas;
    ``/healthz``, ``/timeseries`` and ``/alerts`` parse.  Then every trace
    runs submit -> complete with admits on both replicas, the Perfetto file
    validates, no request failed, and the CLI's predictions (from the
    traces) equal the plain goap backend's on the CLI's frames.  Then one
    replica serves the same 512 requests with the same observability
    (without the hold; a deadline no request reaches keeps the host-side
    activity counting off, as on the fleet) for the 1-replica figures.
    Returns the 2-replica run's launches."""
    import re
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from repro_torch.api import (compile_plan, compile_snn, init_snn,
                                 make_mask_pytree)
    from repro_torch.data.pipeline import sigma_delta_encode_batch
    from repro_torch.data.radioml import generate_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import (disable_tracing, metrics,
                                 set_default_alert_manager,
                                 set_default_recorder, validate_perfetto)

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    trace_path, perfetto_path = work / "trace.json", work / "perfetto.json"
    common = ["--arch", "saocds-amc", "--batch", str(BATCH),
              "--requests", str(CLI_REQUESTS), "--device", str(device),
              "--metrics-port", "0", "--slo", "default",
              "--trace-dump", str(trace_path),
              "--perfetto-dump", str(perfetto_path)]
    registry = metrics.MetricsRegistry()
    old = metrics.set_default_registry(registry)
    scraped = {}
    t_phase = time.perf_counter()

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:   # a 503 still has a body
            return e.code, e.read()

    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        thread, out, result = _run_cli(common + [
            "--replicas", "2", "--hold-s", str(CLI_HOLD_S)],
            until="perfetto:")
        serve_s = time.perf_counter() - t0
        base = re.search(r"metrics: (http://\S+)/metrics",
                         out.getvalue()).group(1)
        for path in ("/readyz", "/healthz", "/metrics", "/timeseries",
                     "/alerts"):
            scraped[path] = get(base + path)
        thread.join(timeout=CLI_HOLD_S + 60)
        torch.cuda.synchronize()
        counts = launch_counts()
        text = out.getvalue()
        dump = json.loads(trace_path.read_text())
        doc = json.loads(perfetto_path.read_text())
        disable_tracing()        # the CLI leaves the process's tracer on
        set_default_recorder(None)
        set_default_alert_manager(None)
    finally:
        metrics.set_default_registry(old)
        disable_tracing()
        set_default_recorder(None)
        set_default_alert_manager(None)
        shutil.rmtree(work, ignore_errors=True)
    for line in text.splitlines():
        print("  cli| " + line)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"the CLI failed: {result}\n{text}")
    if "outcomes:" in text:
        raise AssertionError("the CLI reports expired or shed requests")
    stats = _cli_stats(text)
    if stats["requests"] != CLI_REQUESTS:
        raise AssertionError(f"served {stats['requests']} of {CLI_REQUESTS}")
    # one replica alone, a window with the observability on and one
    # without (each printed; each must serve all of its requests)
    windows = run_cli_windows(device)
    code, body = scraped["/readyz"]
    if code != 200 or json.loads(body)["ready"] is not True:
        raise AssertionError(f"/readyz answered {code}: {body!r}")
    per_replica = {r: float(n) for r, n in re.findall(
        r'^repro_serve_requests_total\{engine="(replica-\d)"\} (\S+)$',
        scraped["/metrics"][1].decode(), re.M)}
    if set(per_replica) != {"replica-0", "replica-1"} or \
            sum(per_replica.values()) != CLI_REQUESTS:
        raise AssertionError(f"/metrics counts {per_replica}")
    health = json.loads(scraped["/healthz"][1])
    series = json.loads(scraped["/timeseries"][1])
    alerts = json.loads(scraped["/alerts"][1])
    # every trace submit -> complete, admitted on both replicas; the
    # predictions by request id (the CLI submits frame i as request i)
    if dump["n_completed"] != CLI_REQUESTS or any(
            rec["terminal"] != "complete" for rec in dump["traces"]):
        raise AssertionError("a traced request did not complete")
    first = min(rec["request_id"] for rec in dump["traces"])
    preds = np.full(CLI_REQUESTS, -1)
    replicas = set()
    for rec in dump["traces"]:
        names = [ev["name"] for ev in rec["events"]]
        if names[0] != "submit" or names[-1] != "complete":
            raise AssertionError(f"trace runs {names}")
        replicas |= {ev["replica"] for ev in rec["events"]
                     if ev["name"] == "admit"}
        preds[rec["request_id"] - first] = rec["events"][-1]["pred"]
    if replicas != {"replica-0", "replica-1"}:
        raise AssertionError(f"admits cover {replicas}")
    problems = validate_perfetto(doc)
    if problems:
        raise AssertionError(f"the Perfetto dump is invalid: {problems[:5]}")
    params = init_snn(0, cfg)
    goap = compile_plan(compile_snn(cfg), params,
                        masks=make_mask_pytree(params, 0.5),
                        assignment="goap", device=device)
    iq, _, _ = generate_batch(0, CLI_REQUESTS, snr_db=10.0,
                              frame_len=cfg.input_width)
    with torch.inference_mode():
        want = np.concatenate([goap.bound.batch(sigma_delta_encode_batch(
            torch.as_tensor(chunk, device=device), cfg.timesteps)
        ).argmax(-1).cpu().numpy() for chunk in np.split(
            iq, CLI_REQUESTS // BATCH)])
    n_diff = int((preds != want).sum())
    print(f"  serve_cli: {CLI_REQUESTS} requests, 0 failed; /metrics "
          f"{per_replica}; /healthz {health['status']}; {series['n_sweeps']} "
          f"sweeps; {len(alerts['firing'])} alerts firing; "
          f"{len(doc['traceEvents'])} Perfetto events; {n_diff} "
          f"predictions differ from goap; launches {counts}")
    if n_diff:
        raise AssertionError(f"{n_diff} CLI predictions differ from goap")
    print("serve_cli_phase " + json.dumps({
        "seconds": time.perf_counter() - t_phase, "replicas_2": stats,
        "replicas_1": windows,
        "serve_s_2_replicas": serve_s, "per_replica": per_replica,
        "healthz": health["status"], "alerts_firing": len(alerts["firing"]),
        "perfetto_events": len(doc["traceEvents"]), "launches": counts,
        "card": nvidia_smi()}))
    return counts


def run_compression_phase(trainer, device) -> dict:
    """Int8 gradient compression on the card: ``compressed_psum`` of the
    trained model's clipped gradients (one step's, on a fresh batch) over a
    world-size-1 NCCL group (rendezvous through a ``FileStore`` in a
    temporary directory: no network) must equal ``dequantize_int8`` of
    ``ef_compress``'s codes and scales, and its error feedback
    ``ef_compress``'s, bit for bit."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.compression import (compressed_psum,
                                                     compression_ratio,
                                                     dequantize_int8,
                                                     ef_compress)
    from repro_torch.tree import tree_leaves, tree_map

    frames, labels, _ = trainer._batch(SEED + 2, 10.0)
    _, _, grads, _, _ = trainer._gradients(trainer.params, trainer.lsq_scales,
                                           trainer.masks, frames, labels)
    ef = tree_map(torch.zeros_like, grads)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            compressed_psum(grads, ef)          # NCCL's communicator set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, new_ef = compressed_psum(grads, ef)
            torch.cuda.synchronize()
            psum_ms = (time.perf_counter() - t0) * 1e3
        finally:
            dist.destroy_process_group()
    q, scales, want_ef = ef_compress(grads, ef)
    want = dequantize_int8(q, scales)
    n_diff = sum(not torch.equal(a, b) for a, b in
                 zip(tree_leaves(mean), tree_leaves(want)))
    n_diff_ef = sum(not torch.equal(a, b) for a, b in
                    zip(tree_leaves(new_ef), tree_leaves(want_ef)))
    line = {"leaves": len(tree_leaves(grads)), "mean_leaves_differ": n_diff,
            "ef_leaves_differ": n_diff_ef,
            "compression_ratio": compression_ratio(grads),
            "psum_ms": psum_ms, "backend": "nccl", "world_size": 1,
            "card": nvidia_smi()}
    print(f"compression_phase {json.dumps(line)}")
    if n_diff or n_diff_ef or not all(
            torch.isfinite(x).all() for x in tree_leaves(mean)):
        raise AssertionError("compressed_psum differs from the dequantized "
                             "ef_compress codes")
    return line


def run_mesh_phase(params, masks, cfg, iq, unsharded, want, device,
                   timers) -> dict:
    """Data-parallel serving over ``serve_mesh()`` (every local card): the
    default ``auto`` engine on the mesh serves the REQUESTS frames at batch
    BATCH with the unsharded engine's predictions (and ``goap``'s), every
    batch by graph replay on every card, launching only the winner's
    kernels, one replay's record on each card a batch.  Prints the sharded
    step beside the unsharded one, host to host.  Returns the served
    window's launches."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine
    from repro_torch.distributed.sharding import serve_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts

    mesh = serve_mesh()
    ic0, width = cfg.conv_specs[0][1], cfg.input_width
    t0 = time.perf_counter()
    with AsyncAMCServeEngine(params, cfg, masks, mesh=mesh, max_batch=BATCH,
                             name="mesh") as engine:
        build_s = time.perf_counter() - t0
        check_race_errors(engine.autotune.errors, "mesh race")
        graphs = engine.get_version(engine.active_version).graphs
        buckets = engine.batcher.buckets
        if graphs is None or any(b % mesh.size for b in buckets):
            raise AssertionError(f"mesh engine: no graphs, or buckets "
                                 f"{buckets} not aligned to {mesh.size}")
        replays0 = graphs.replays
        reset_launch_counts()
        preds = serve_all(engine, iq)
        torch.cuda.synchronize()
        counts = launch_counts()
        replays = graphs.replays - replays0
        batches = engine.stats.batches
        per_replay = graphs.launches((BATCH, ic0, width))
        iq_b = iq[:BATCH]
        mesh_ms = [timers.host(lambda: engine.step(iq_b))]
        with AsyncAMCServeEngine(params, cfg, masks, backend=engine.backend,
                                 max_batch=BATCH, device=device,
                                 name="unsharded") as single:
            single_ms = timers.host(lambda: single.step(iq_b))
        mesh_ms.append(timers.host(lambda: engine.step(iq_b)))
        backend = engine.backend
    expect_launches(counts, kernels_of(engine.plan), "mesh served path")
    if backend == "cuda_fused":
        expect_launches(counts, {"stream_fused_forward"}, "mesh served path")
    if replays != batches or any(
            counts[k] != replays * n for k, n in per_replay.items()):
        raise AssertionError(f"mesh: {batches} batches, {replays} replays, "
                             f"launches {counts}, per replay {per_replay}: "
                             "not every batch was served by replay")
    n_diff = int((preds != unsharded).sum())
    n_goap = int((preds != want).sum())
    line = {"devices": [str(d) for d in mesh.devices], "backend": backend,
            "race_ms": engine.autotune.timings_ms, "buckets": list(buckets),
            "requests": len(preds), "batches": batches, "replays": replays,
            "launches": counts, "launches_per_replay": per_replay,
            "differ_from_unsharded": n_diff, "differ_from_goap": n_goap,
            "build_s": build_s, "step_ms_mesh": mesh_ms,
            "step_ms_unsharded": single_ms, "card": nvidia_smi()}
    print(f"mesh_phase {json.dumps(line)}")
    if n_diff or n_goap:
        raise AssertionError(f"mesh: {n_diff} predictions differ from the "
                             f"unsharded engine's, {n_goap} from goap's")
    return counts


def run_pipeline_phase(device) -> dict:
    """The example's 4-stage SNN pipeline (conv1 | conv2 | conv3 | FC head,
    8 microbatches, ``dense``) on the card: its logits within ATOL of the
    unpipelined ``dense`` forward on the same frames, and of the same
    pipeline on the CPU.  Prints the pipeline's seconds (the second run's
    too, with the card warm)."""
    import argparse

    import numpy as np

    from repro_torch.examples import snn_pipeline

    card = snn_pipeline.run(argparse.Namespace(device=str(device)))
    again = snn_pipeline.run(argparse.Namespace(device=str(device)))
    cpu = snn_pipeline.run(argparse.Namespace(device="cpu"))
    vs_cpu = float(np.abs(card["pipe_logits"] - cpu["pipe_logits"]).max())
    line = {"stages": card["devices"], "microbatches": 8,
            "max_err_vs_dense": card["max_err"], "max_err_vs_cpu": vs_cpu,
            "repeat_equal": bool(np.array_equal(card["pipe_logits"],
                                                again["pipe_logits"])),
            "seconds": [card["seconds"], again["seconds"]],
            "cpu_seconds": cpu["seconds"], "card": nvidia_smi()}
    print(f"pipeline_phase {json.dumps(line)}")
    if card["max_err"] > ATOL or vs_cpu > ATOL or not np.isfinite(
            card["pipe_logits"]).all():
        raise AssertionError(f"the 4-stage pipeline differs: {line}")
    return line


EXAMPLES = (("quickstart", []),
            ("amc_train", ["--steps", "4", "--batch", "16"]),
            ("amc_serve", ["--train-steps", "4", "--requests", "16"]),
            ("amc_deploy", ["--train-steps", "10", "--requests", "32"]),
            ("snn_pipeline", []))


def run_examples_phase(device) -> dict:
    """Each of the five SNN examples in process on the card with tiny
    budgets; each must return 0."""
    import importlib

    seconds = {}
    for name, argv in EXAMPLES:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        rc = module.main(argv + ["--device", str(device)])
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"example {name} exited {rc}")
    line = {"seconds": seconds, "card": nvidia_smi()}
    print(f"examples_phase {json.dumps(line)}")
    return line


ZOO_B, ZOO_S = 2, 16
ZOO_FWD_ATOL = 1e-4
ZOO_LOSS_RTOL = 1e-5
ZOO_SERVE_TOL = 2e-2
FULL_TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--scale", "full", "--steps", "4",
                   "--batch", "4", "--seq", "256"]
FULL_TIMED_STEPS = 3
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 64, 32
MAMBA_B, MAMBA_S = 2, 256


def _zoo_inputs(cfg, rng, batch: int, seq: int):
    """Tokens and the stub frontend input of a zoo arch, from numpy."""
    import numpy as np

    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = rng.normal(size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
    return toks, extra


def _zoo_forward(cfg, params, toks, extra):
    from repro_torch.models.lm import lm_forward
    from repro_torch.models.whisper import whisper_forward

    if cfg.family == "encdec":
        return whisper_forward(params, extra, toks, cfg)
    return lm_forward(params, toks, cfg, patch_embeds=extra)


def _serve_gap(cfg, params, toks, extra) -> float:
    """max |prefill(t[:-1]) + decode(t[-1]) - forward(t)| over the last
    position's real vocab, relative to the tolerance's scale
    (``|a - b| / (1 + |b|)``, so <= ZOO_SERVE_TOL is allclose with atol =
    rtol = ZOO_SERVE_TOL)."""
    import dataclasses

    import torch

    from repro_torch.models import lm, whisper

    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    b, s = toks.shape
    with torch.no_grad():
        full = _zoo_forward(cfg, params, toks, extra)
        if cfg.family == "encdec":
            _, st = whisper.whisper_prefill(params, extra, toks[:, : s - 1], cfg)
            big = whisper.init_whisper_decode_state(cfg, b, s, s,
                                                    dtype=st["self_k"].dtype,
                                                    device=toks.device)
            big["self_k"][:, :, : s - 1] = st["self_k"]
            big["self_v"][:, :, : s - 1] = st["self_v"]
            big.update(cross_k=st["cross_k"], cross_v=st["cross_v"], len=st["len"])
            step, _ = whisper.whisper_decode_step(params, big, toks[:, -1:], cfg)
        else:
            _, states = lm.lm_prefill(params, toks[:, : s - 1], cfg,
                                      patch_embeds=extra, cache_headroom=1)
            step, _ = lm.lm_decode_step(params, states, toks[:, -1:], cfg)
    want = full[:, -1, : cfg.vocab].float()
    got = step[:, -1, : cfg.vocab].float()
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def _quiet(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its standard output kept; returns
    (result, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def run_zoo_phase(device, seed: int = SEED) -> dict:
    """Phase 21: the language-model zoo on the card (see the module
    docstring).  Returns the phase's line, with the launch counts."""
    import gc
    import math
    import re

    import numpy as np
    import torch

    from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import LMTrainer
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import lm as lm_module
    from repro_torch.models.lm import init_lm
    from repro_torch.models.whisper import init_whisper
    from repro_torch.tree import tree_leaves, tree_map

    def on(x, dev):
        return None if x is None else torch.from_numpy(x).to(dev)

    card = nvidia_smi()
    reset_launch_counts()
    t_phase = time.perf_counter()
    line = {"reduced": {}, "card": card}
    failures = []
    for arch in ARCH_IDS:
        cfg = reduced_config(arch)
        gen = torch.Generator().manual_seed(seed)
        if cfg.family == "encdec":
            cpu_params = init_whisper(gen, cfg, max_dec_pos=4 * ZOO_S)
        else:
            cpu_params = init_lm(gen, cfg)
        params = tree_map(lambda t: t.to(device), cpu_params)
        toks, extra = _zoo_inputs(cfg, np.random.default_rng(seed), ZOO_B, ZOO_S)
        with torch.no_grad():
            got = _zoo_forward(cfg, params, on(toks, device), on(extra, device))
            want = _zoo_forward(cfg, cpu_params, on(toks, "cpu"), on(extra, "cpu"))
        fwd = float((got[..., : cfg.vocab].cpu() - want[..., : cfg.vocab]).abs().max())
        losses = {}
        for dev in (device, "cpu"):
            trainer = LMTrainer(cfg, batch=ZOO_B, seq=ZOO_S, seed=seed, device=dev)
            hist, _ = _quiet(trainer.run, 1, log_every=1)
            losses[str(dev)] = hist["loss"][0]
        card_loss, cpu_loss = losses[str(device)], losses["cpu"]
        loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        gap = _serve_gap(cfg, params, on(toks, device), on(extra, device))
        row = {"fwd_max_abs_diff_vs_cpu": fwd, "loss": card_loss,
               "loss_rel_diff_vs_cpu": loss_rel, "prefill_decode_gap": gap}
        line["reduced"][arch] = row
        if not (fwd <= ZOO_FWD_ATOL and loss_rel <= ZOO_LOSS_RTOL
                and gap <= ZOO_SERVE_TOL and math.isfinite(card_loss)):
            failures.append((arch, row))
    line["reduced_s"] = time.perf_counter() - t_phase

    # qwen1.5-0.5b at full width, through the training entry point
    t0 = time.perf_counter()
    rc, out = _quiet(train_main, FULL_TRAIN_ARGS + ["--device", str(device)])
    torch.cuda.synchronize()
    found = re.search(r"final loss (\S+)", out)
    final_loss = float(found.group(1)) if found else float("nan")
    line["full_train"] = {"argv": FULL_TRAIN_ARGS, "rc": rc,
                          "final_loss": final_loss,
                          "seconds": time.perf_counter() - t0,
                          "cli_line": out.strip().splitlines()[-1] if out else ""}
    if rc != 0 or not math.isfinite(final_loss):
        failures.append(("qwen1.5-0.5b launch.train", line["full_train"]))

    # a trainer of that size: step time, busy share, peak memory
    cfg = get_config("qwen1.5-0.5b")
    torch.cuda.reset_peak_memory_stats(device)
    trainer = LMTrainer(cfg, batch=4, seq=256, seed=seed, device=device,
                        capture=False)
    timing, _ = _quiet(step_ms, trainer, FULL_TIMED_STEPS)
    prof, _ = _quiet(profile_steps, lambda: trainer.run(1, log_every=1), 2)
    peak = torch.cuda.max_memory_allocated(device)
    # the same steps with the layers' recomputation off (a measurement of
    # what torch.utils.checkpoint costs here, not a mode of the port)
    torch.cuda.reset_peak_memory_stats(device)
    remat = lm_module.remat
    lm_module.remat = lambda fn, *args: fn(*args)
    try:
        no_remat, _ = _quiet(step_ms, trainer, FULL_TIMED_STEPS)
    finally:
        lm_module.remat = remat
    no_remat["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    busy = prof["device_busy_ms"]
    line["full_step"] = {
        **timing, **prof, "peak_memory_bytes": peak,
        # as the SNN train phase: the card's busy ms against a waited step
        "device_idle_share": (1.0 - busy / timing["step_ms_waited"])
        if busy else None,
        "params": sum(t.numel() for t in tree_leaves(trainer.params)),
        "without_recompute": no_remat,
        "tokens_per_step": 4 * 256, "steps_taken": trainer.step, "card": card}

    # greedy generation on the trained full-width params
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT)
                                            ).astype(np.int32)).to(device)
    generate(cfg, trainer.params, prompts, 1, capture=False)    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(cfg, trainer.params, prompts, GEN_NEW, capture=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    ok_tokens = (tuple(tokens.shape) == (GEN_BATCH, GEN_PROMPT + GEN_NEW)
                 and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    gap = _serve_gap(cfg, trainer.params, prompts, None)
    line["full_generate"] = {"batch": GEN_BATCH, "prompt": GEN_PROMPT,
                             "new_tokens": GEN_NEW, "seconds": gen_s,
                             "tokens_per_s": GEN_BATCH * GEN_NEW / gen_s,
                             "prefill_decode_gap": gap, "card": card}
    if not ok_tokens or gap > ZOO_SERVE_TOL:
        failures.append(("qwen1.5-0.5b generate", line["full_generate"]))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # mamba2-780m at full width: the family whose core is a scan
    cfg = get_config("mamba2-780m")
    params = init_lm(torch.Generator(device=device).manual_seed(seed), cfg)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (MAMBA_B, MAMBA_S)).astype(np.int32)).to(device)
    with torch.no_grad():
        logits = _zoo_forward(cfg, params, toks, None)          # warm
        torch.cuda.synchronize()
        fwd_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            logits = _zoo_forward(cfg, params, toks, None)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
    finite = bool(torch.isfinite(logits[..., : cfg.vocab]).all())
    gap = _serve_gap(cfg, params, toks, None)
    line["mamba2_full"] = {"batch": MAMBA_B, "seq": MAMBA_S,
                           "forward_ms": statistics.median(fwd_ms),
                           "forward_ms_all": fwd_ms, "finite": finite,
                           "prefill_decode_gap": gap, "card": card}
    if not finite or gap > ZOO_SERVE_TOL:
        failures.append(("mamba2-780m", line["mamba2_full"]))
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    counts = launch_counts()
    line["launches"] = counts
    line["seconds"] = time.perf_counter() - t_phase
    print(f"zoo_phase {json.dumps(line)}")
    if failures:
        raise AssertionError(f"zoo phase gates failed: {failures}")
    expect_launches(counts, set(), "zoo path")
    return line


# the cells phase: the train cell's cut global batch and its gate steps,
# the decode cell's steps, the prefill cell's cut batch and the capture
# time above which its sequence is cut
CELL_TRAIN_BATCH = 4
CELL_GATE_STEPS = 3
CELL_DECODE_STEPS = 16
CELL_PREFILL_BATCH = 1
CELL_PREFILL_CAPTURE_S = 30.0
CELL_PREFILL_CUT_SEQ = 8192


def _state_equal(got, want) -> bool:
    import torch

    from repro_torch.tree import tree_leaves

    got, want = tree_leaves(got), tree_leaves(want)
    return len(got) == len(want) and all(
        g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))


def _waited_ms(fn, reps: int) -> list:
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _cell_train(device, seed, mesh):
    """The qwen1.5-0.5b train cell at seq 4096, batch 4: CELL_GATE_STEPS
    steps op by op, then as many captured, from one state, each waited
    for (the last two give the waited step ms; the first captured one
    captures); then one captured step profiled.  Returns (line,
    {captured: (state after the gate steps, metrics)})."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.launch import steps
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optimizer import adamw
    from repro_torch.tree import tree_map

    cfg = get_config("qwen1.5-0.5b")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=CELL_TRAIN_BATCH)
    plan = steps._train_cell("qwen1.5-0.5b", shape, cfg, mesh)
    params = init_lm(torch.Generator(device=device).manual_seed(seed), cfg)
    state0 = {"params": params,
              "opt": adamw(3e-4, weight_decay=0.1)[0](params)}
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (shape.global_batch, shape.seq_len)
                             ).astype(np.int32) for k in ("tokens", "labels")}
    runs, line = {}, {"arch": "qwen1.5-0.5b", "seq": shape.seq_len,
                      "global_batch": shape.global_batch}
    for capture in (False, True):
        name = "captured" if capture else "eager"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        step = plan.jitted(device, capture=capture)
        st, metrics, waited = state0, [], []   # the first call copies state0 in
        for _ in range(CELL_GATE_STEPS):
            t0 = time.perf_counter()
            st, m = step(st, batch)
            metrics.append((m["loss"].clone(), m["gnorm"].clone()))
            torch.cuda.synchronize()
            waited.append((time.perf_counter() - t0) * 1e3)
        line[f"{name}_step_ms_waited"] = statistics.median(waited[1:])
        line[f"{name}_step_ms_all"] = waited
        # later steps rewrite the donated buffers: keep the gate's state
        runs[capture] = (tree_map(torch.clone, st), metrics)
        if capture:
            prof, _ = _quiet(profile_steps, lambda: step(st, batch), 1)
            busy = prof["device_busy_ms"]
            line.update(prof)
            # the card's idle share of the profiled step's own window
            line["device_idle_share"] = (
                1.0 - busy / prof["profiled_step_ms"] if busy else None)
            line["captures"] = step.static.captures
        line[f"{name}_peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
        del step, st, m
    cap_m, eag_m = runs[True][1], runs[False][1]
    line["losses"] = [float(l) for l, _ in cap_m]
    line["gnorms"] = [float(g) for _, g in cap_m]
    line["bit_equal"] = bool(all(torch.equal(a, b) and torch.equal(c, d)
                                 for (a, c), (b, d) in zip(cap_m, eag_m)))
    return line, runs


def run_cells_phase(device, fused_ms: float, seed: int = SEED) -> dict:
    """Phase 22: the zoo's production cells on the card (see the module
    docstring).  ``fused_ms`` is the fused kernel's device ms at batch 64
    from the kernels phase.  Returns the phase's line, with the launch
    counts."""
    import dataclasses
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun, pp_dryrun, steps
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.roofline import streaming_roofline
    from repro_torch.launch.serve import Generator
    from repro_torch.launch.train import LMTrainer
    from repro_torch.models import lm as lm_module
    from repro_torch.models.lm import init_decode_state, init_lm
    from repro_torch.models.snn import SNNConfig
    from repro_torch.tree import tree_map

    card = nvidia_smi()
    reset_launch_counts()
    t_phase = time.perf_counter()
    mesh = Mesh((1, 1), ("data", "model"))
    line = {"card": card}
    failures = []

    # -- the dry-runs first: the train cell's FLOPs come from one of them
    t0 = time.perf_counter()
    recs = {"long_500k_multi": dryrun.run_cell("mamba2-780m", "long_500k", "multi"),
            "train_4k_single": dryrun.run_cell("qwen1.5-0.5b", "train_4k", "single")}
    pp = pp_dryrun.run()
    line["dryrun"] = {k: {"arch": r["arch"], "chips": r["chips"],
                          "terms_s": r["roofline"]["terms_s"],
                          "bottleneck": r["roofline"]["bottleneck"],
                          "useful_ratio": r["roofline"]["useful_ratio"],
                          "peak_live_bytes": r["memory"]["peak_live_bytes"],
                          "fits_80g_hbm": r["memory"]["fits_80g_hbm"]}
                      for k, r in recs.items()}
    line["pp_dryrun"] = {k: pp[k] for k in ("ticks", "bubble_fraction",
                                            "terms_s", "stage_calls")}
    line["dryrun_s"] = time.perf_counter() - t0
    if not (all(r["ok"] for r in recs.values()) and pp["ok"]
            and recs["long_500k_multi"]["chips"] == 512 and pp["ticks"] == 23):
        failures.append(("dry-runs", line["dryrun"]))

    # -- the train cell
    t0 = time.perf_counter()
    train, runs = _cell_train(device, seed, mesh)
    (cap_st, _), (eag_st, _) = runs[True], runs[False]
    train["state_bit_equal"] = _state_equal(cap_st, eag_st)
    # its counted FLOPs: the train_4k dry-run's global count at batch 256,
    # linear in the batch (qwen1.5-0.5b takes one microbatch at both)
    rec = recs["train_4k_single"]
    flops = (rec["roofline"]["global"]["dot_flops"] * CELL_TRAIN_BATCH
             / SHAPES["train_4k"].global_batch)
    train["counted_flops"] = flops
    for name in ("captured", "eager"):
        tflops = flops / (train[f"{name}_step_ms_waited"] / 1e3) / 1e12
        train[f"{name}_tflop_per_s"] = tflops
        train[f"{name}_share_of_bf16_peak"] = tflops * 1e12 / HW["peak_flops_bf16"]
    train["seconds"] = time.perf_counter() - t0
    train["card"] = card
    line["train_cell"] = train
    if not (train["bit_equal"] and train["state_bit_equal"]
            and all(math.isfinite(x) for x in train["losses"])):
        failures.append(("train cell", train))
    del runs, cap_st, eag_st
    gc.collect()
    torch.cuda.empty_cache()

    # -- the decode cell at its published shape
    t0 = time.perf_counter()
    cfg = get_config("mamba2-780m")
    shape = SHAPES["long_500k"]
    plan = steps._decode_cell("mamba2-780m", shape, cfg, mesh)
    params = init_lm(torch.Generator(device=device).manual_seed(seed), cfg,
                     dtype=torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (CELL_DECODE_STEPS, shape.global_batch, 1)
    ).astype(np.int32)).to(device)
    decode = {"arch": "mamba2-780m", "ctx": shape.seq_len,
              "batch": shape.global_batch, "steps": CELL_DECODE_STEPS}
    outs = {}
    for capture in (False, True):
        step = plan.jitted(device, capture=capture)
        state0 = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                   device=device)
        st, logits = state0, []
        for i in range(CELL_DECODE_STEPS):          # the gate run (captures)
            lg, st = step(params, st, toks[i])
            logits.append(lg.clone())
        outs[capture] = (logits, tree_map(torch.clone, st))
        name = "captured" if capture else "eager"
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(CELL_DECODE_STEPS):          # timed: one wait at the end
            lg, st = step(params, st, toks[i])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        decode[f"{name}_tokens_per_s"] = CELL_DECODE_STEPS * shape.global_batch / dt
        decode[f"{name}_step_ms"] = dt * 1e3 / CELL_DECODE_STEPS
    decode["bit_equal"] = (
        all(torch.equal(a, b) for a, b in zip(outs[True][0], outs[False][0]))
        and _state_equal(outs[True][1], outs[False][1]))
    decode["finite"] = bool(torch.isfinite(outs[True][0][-1][..., :cfg.vocab]).all())
    decode["seconds"] = time.perf_counter() - t0
    decode["card"] = card
    line["decode_cell"] = decode
    if not (decode["bit_equal"] and decode["finite"]):
        failures.append(("decode cell", decode))
    del params, outs, st, lg, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- the prefill cell, batch 1 (seq cut if its capture is too slow)
    cfg = get_config("qwen1.5-0.5b")
    params = init_lm(torch.Generator(device=device).manual_seed(seed), cfg,
                     dtype=torch.bfloat16)
    prefill = {"arch": "qwen1.5-0.5b", "batch": CELL_PREFILL_BATCH}
    for seq in (SHAPES["prefill_32k"].seq_len, CELL_PREFILL_CUT_SEQ):
        t0 = time.perf_counter()
        shape = dataclasses.replace(SHAPES["prefill_32k"],
                                    global_batch=CELL_PREFILL_BATCH, seq_len=seq)
        plan = steps._prefill_cell("qwen1.5-0.5b", shape, cfg, mesh)
        prefill["build_s"] = time.perf_counter() - t0
        batch = {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (shape.global_batch, seq)).astype(np.int32)).to(device)}
        res = {}
        for capture in (False, True):
            step = plan.jitted(device, capture=capture)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, state = step(params, batch)
            torch.cuda.synchronize()
            first = time.perf_counter() - t1
            res[capture] = tree_map(torch.clone, (logits, state))
            name = "captured" if capture else "eager"
            # the eager first call builds nothing: it is the eager time;
            # the captured one warms up, captures and replays
            prefill[f"{name}_first_call_s"] = first
            prefill[f"{name}_ms_waited"] = (
                _waited_ms(lambda: step(params, batch), 1)[0] if capture
                else first * 1e3)
            del step, logits, state
        prefill["seq"] = seq
        prefill["bit_equal"] = _state_equal(res[True], res[False])
        prefill["finite"] = bool(torch.isfinite(res[True][0][..., :cfg.vocab]).all())
        del res
        gc.collect()
        torch.cuda.empty_cache()
        if prefill["captured_first_call_s"] <= CELL_PREFILL_CAPTURE_S:
            break
        prefill["cut_from"] = SHAPES["prefill_32k"].seq_len
    prefill["card"] = card
    line["prefill_cell"] = prefill
    if not (prefill["bit_equal"] and prefill["finite"]):
        failures.append(("prefill cell", prefill))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- LMTrainer at the zoo phase's size: captured, op by op, captured without
    # recomputation (a measurement, not a mode of the port)
    t0 = time.perf_counter()
    trainer_line = {"arch": "qwen1.5-0.5b", "batch": 4, "seq": 256}
    cfg = get_config("qwen1.5-0.5b")
    for name, capture, remat in (("captured", True, True), ("eager", False, True),
                                 ("captured_no_recompute", True, False)):
        saved = lm_module.remat
        if not remat:
            lm_module.remat = lambda fn, *args: fn(*args)
        try:
            torch.cuda.reset_peak_memory_stats(device)
            trainer = LMTrainer(cfg, batch=4, seq=256, seed=seed, device=device,
                                capture=capture)
            timing, _ = _quiet(step_ms, trainer, FULL_TIMED_STEPS)
            prof, _ = _quiet(profile_steps, lambda: trainer.run(1, log_every=1), 2)
        finally:
            lm_module.remat = saved
        busy = prof["device_busy_ms"]
        trainer_line[name] = {
            **timing, **prof,
            "device_idle_share": (1.0 - busy / timing["step_ms_waited"])
            if busy else None,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device)}
        if name == "captured":
            params = tree_map(torch.clone, trainer.params)   # for generation
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    cap = trainer_line["captured"]["step_ms_waited"]
    trainer_line["recompute_share_of_captured_step"] = (
        1.0 - trainer_line["captured_no_recompute"]["step_ms_waited"] / cap)
    trainer_line["seconds"] = time.perf_counter() - t0
    trainer_line["card"] = card
    line["lm_trainer"] = trainer_line

    # -- generation on the captured trainer's params: captured vs op by op
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT)
                                            ).astype(np.int32)).to(device)
    gen_line = {"batch": GEN_BATCH, "prompt": GEN_PROMPT, "new_tokens": GEN_NEW}
    tokens = {}
    for name, capture in (("captured", True), ("eager", False)):
        gen = Generator(cfg, params, capture=capture)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen(prompts, GEN_NEW)                      # the first call captures
        torch.cuda.synchronize()
        gen_line[f"{name}_first_call_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        tokens[name] = gen(prompts, GEN_NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        gen_line[f"{name}_tokens_per_s"] = GEN_BATCH * GEN_NEW / dt
    gen_line["tokens_equal"] = bool(torch.equal(tokens["captured"], tokens["eager"]))
    gen_line["card"] = card
    line["generate"] = gen_line
    if not gen_line["tokens_equal"]:
        failures.append(("generate", gen_line))
    del params, gen, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # -- the SNN's streaming roofline target beside the fused kernel
    target = streaming_roofline(SNNConfig(), batch=64)
    line["streaming_roofline"] = {
        "target_fps": target["target_fps"], "bound": target["bound"],
        "fused_kernel_fps_batch64": 64 / (fused_ms / 1e3),
        "fused_share_of_target": 64 / (fused_ms / 1e3) / target["target_fps"],
        "note": "HW quotes the bf16 tensor-core peak; the fused kernel "
                "runs f32 on the CUDA cores", "card": card}

    torch.cuda.synchronize()
    counts = launch_counts()
    line["launches"] = counts
    line["seconds"] = time.perf_counter() - t_phase
    print(f"cells_phase {json.dumps(line)}")
    if failures:
        raise AssertionError(f"cells phase gates failed: {failures}")
    expect_launches(counts, set(), "cells path")
    return line


# ---------------------------------------------------------------------------
# bf16_phase: the paper's SNN with bf16 weights (init_snn(dtype=bf16)).
# ---------------------------------------------------------------------------

# bf16 form -> (its CUDA source's stem, the reference's Pallas kernel)
BF16_FORMS = {
    "goap_conv_block_sparse_bf16": ("goap_conv", "src/repro/kernels/goap_conv.py:55"),
    "wm_fc_matmul_bf16": ("wm_fc", "src/repro/kernels/wm_fc.py:40"),
    "lif_update_fused_bf16": ("lif_update", "src/repro/kernels/lif_update.py:46"),
}
# the one bf16 form no path launches (the reference's conv casts to f32),
# and what the LIF's bound counts
BF16_NOTES = {"goap_conv_block_sparse_bf16": (
    "kernel contract only: no path reaches this form (ops.goap_conv_op "
    "casts to f32, as the reference's does); held and timed on the served "
    "convs' operands cast to bf16"),
    "lif_update_fused_bf16": LIF_BOUND_NOTE}
BF16_BACKENDS = ("dense", "goap", "stream", "cuda", "cuda_fused")
# the reference's kernel-test shapes, on random normal operands, and the
# edges of the bf16 kernels' tiling: ragged B, IN not a multiple of 128,
# more reference tiles than a block has warps, OUT = 11 / 37; BO 4-32, BK
# 16-48 and OI off the strip and off 8
BF16_FC_SHAPES = ((8, 256, 64), (5, 100, 37), (512, 1024, 128), (512, 128, 11),
                  (70, 130, 40), (33, 1000, 11), (17, 300, 37), (5, 2100, 64))
BF16_GOAP_TILES = ((8, 16, 64), (8, 32, 64),            # (block_oc, block_k, OI)
                   (16, 48, 1000), (24, 32, 129), (32, 16, 520), (4, 48, 33))
# (T, N, C, inner, with v0): the reference's (N,) form, then per-channel
# layouts without v0 (FC: inner 1; conv: inner W), odd N, T past the 16 a
# thread loads at once
BF16_LIF_SHAPES = ((1, 16, 16, 1, True), (4, 128, 128, 1, True), (8, 200, 200, 1, True),
                   (3, 1030, 1030, 1, True), (16, 7, 7, 1, True), (8, 704, 11, 1, False),
                   (17, 22, 11, 1, False), (8, 4 * 16 * 128, 16, 128, False),
                   (5, 9 * 3 * 33, 3, 33, False), (17, 3 * 5 * 7, 5, 7, True))


def bf16_ulps(got, want):
    """|got - want| per element in bf16 ulps of ``want`` (8 significant
    bits: one ulp of x is 2**(floor(log2|x|) - 7))."""
    import torch

    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return torch.where(g == w, torch.zeros_like(w), (g - w).abs() / ulp)


def bf16_bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_masks(params):
    """Density-0.5 magnitude masks in the weights' dtype: an f32 mask
    (make_mask_pytree's) promotes w * mask to f32, as in the reference, and
    the model would then run its FC layers in f32."""
    import torch

    from repro_torch.api import make_mask_pytree

    return {g: [m.to(torch.bfloat16) for m in ms]
            for g, ms in make_mask_pytree(params, DENSITY).items()}


def served_bf16_calls(plan, frames_b):
    """One layer-by-layer batch of the bf16 ``cuda`` plan, recording the
    operands of every per-layer kernel call; returns them as the bf16
    forms' operands: the FC products and FC LIFs as called (bf16), and the
    conv products cast to bf16 (exact: bf16-valued tiles, binary X'), the
    form ``ops.goap_conv_op`` never reaches."""
    import torch

    from repro_torch.kernels import ops

    raw = []
    saved = {n: getattr(ops, n) for n in ("goap_conv_block_sparse",
                                          "wm_fc_matmul", "lif_update_fused")}

    def recording(name, fn):
        def call(*args, **kwargs):
            raw.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return call

    for n, fn in saved.items():
        setattr(ops, n, recording(n, fn))
    try:
        logits = plan.bound.batch(frames_b)
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    calls = {name: [] for name in BF16_FORMS}
    for name, args, kwargs in raw:
        if name == "goap_conv_block_sparse":
            blocks, cols, x = args
            calls["goap_conv_block_sparse_bf16"].append(
                ((blocks.to(torch.bfloat16), cols, x.to(torch.bfloat16)), kwargs))
        elif (args[1] if name == "wm_fc_matmul" else args[0]).dtype == torch.bfloat16:
            calls[name + "_bf16"].append((args, kwargs))
    missing = [n for n, c in calls.items() if not c]
    if missing:
        raise AssertionError(f"the bf16 cuda path never called {missing}")
    return logits, calls


def bf16_work(name, args):
    """(bytes, flops, one bf16 library call or None) of one call."""
    import torch

    from repro_torch.kernels.goap_conv import dense_of_blocks

    if name == "goap_conv_block_sparse_bf16":
        blocks, cols, x = args
        dense = dense_of_blocks(blocks, cols, x.shape[0])
        macs = float((dense != 0).sum(0).double() @ (x != 0).sum(1).double())
        out = blocks.shape[0] * blocks.shape[2] * x.shape[1] * 2
        return (nbytes(blocks, cols, x) + out, 2 * macs,
                lambda: torch.matmul(dense, x))
    if name == "wm_fc_matmul_bf16":
        sp, w = args
        macs = float((sp != 0).sum(0).double() @ (w != 0).sum(1).double())
        return (nbytes(sp, w) + 2 * sp.shape[0] * w.shape[1], 2 * macs,
                lambda: torch.matmul(sp.to(w.dtype), w))
    cur = args[0]
    # multiply, add, compare, subtract per neuron and timestep (no tensor
    # cores: the f32 instruction rate bounds it, as the f32 form's); bytes:
    # the currents, the C-long parameters and v0 where one is given in, the
    # spikes and the final membrane out
    return (nbytes(*args) + nbytes(cur, cur[0]), 4.0 * cur.numel(), None)


def check_bf16_kernels(calls, device, timers, seed):
    """Each bf16 form against its plain version on the card: bit-equal on
    the served path's operands (the count of differing elements printed),
    within 1 bf16 ulp on random normal operands at the reference's test
    shapes (the LIF bit-equal there too, its per-channel layouts
    included); then timed on the served operands, beside the launch floor.
    Returns the rows."""
    import numpy as np
    import torch

    from repro_torch import kernels

    rng = np.random.default_rng(seed)
    floor_ms = launch_floor(device)

    def bf(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).to(torch.bfloat16)

    random_calls = {
        "wm_fc_matmul_bf16": [
            ((bf(rng.random((b, i)) < 0.5),
              bf((rng.random((i, o)) < 0.4) * rng.normal(size=(i, o)))), {})
            for b, i, o in BF16_FC_SHAPES],
        "goap_conv_block_sparse_bf16": [
            ((bf(rng.normal(size=(3, 4, bo, bk))),
              torch.as_tensor(rng.integers(0, 5, (3, 4)), dtype=torch.int32,
                              device=device),
              bf(rng.random((5 * bk, oi)) < 0.5)),
             {"block_oc": bo, "block_k": bk}) for bo, bk, oi in BF16_GOAP_TILES],
        "lif_update_fused_bf16": [
            ((bf(rng.normal(size=(t, n))), bf(rng.normal(size=n)) if v0 else None,
              bf(rng.uniform(0.5, 0.99, c)), bf(rng.uniform(0.5, 1.5, c)),
              bf(rng.uniform(0.3, 1.2, c))), {"inner": inner})
            for t, n, c, inner, v0 in BF16_LIF_SHAPES],
    }
    rows = []
    for name, (stem, replaces) in BF16_FORMS.items():
        # the LIF's plain loop is dtype-generic: its bf16 form has no own
        kernel = getattr(kernels, name)
        plain = getattr(kernels, name + "_ref", None) or getattr(
            kernels, name.removesuffix("_bf16") + "_ref")
        n_diff, n_elems, max_err = 0, 0, 0.0
        for args, kwargs in calls[name]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **plain_kwargs(name, kwargs))
            torch.cuda.synchronize()
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                if g.dtype != torch.bfloat16 or g.shape != w.shape:
                    raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} "
                                         f"against {tuple(w.shape)}")
                n_diff += int((g.view(torch.int16) != w.view(torch.int16)).sum())
                n_elems += g.numel()
                max_err = max(max_err, float((g.float() - w.float()).abs().max()))
        print(f"  {name} on the served operands: {len(calls[name])} calls, "
              f"{n_diff} of {n_elems} elements differ from the plain version")
        if n_diff:
            raise AssertionError(f"{name}: not bit-equal to its plain version "
                                 "on the served operands")
        worst, r_diff = 0.0, 0
        for args, kwargs in random_calls[name]:
            got = kernel(*args, **kwargs)
            want = plain(*args, **plain_kwargs(name, kwargs))
            torch.cuda.synchronize()
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                r_diff += int((g.view(torch.int16) != w.view(torch.int16)).sum())
                worst = max(worst, float(bf16_ulps(g, w).max()))
        print(f"  {name} on random normal operands: {r_diff} elements differ, "
              f"at most {worst} bf16 ulp")
        if worst > 1.0 or (r_diff and name == "lif_update_fused_bf16"):
            raise AssertionError(f"{name}: {worst} bf16 ulp from its plain "
                                 "version on random operands (the LIF must "
                                 "be bit-equal)")
        work = [bf16_work(name, args) for args, _ in calls[name]]
        b_ms, b_by = (bf16_bound_ms(sum(w[0] for w in work), sum(w[1] for w in work))
                      if name != "lif_update_fused_bf16" else
                      bound_ms(sum(w[0] for w in work), sum(w[1] for w in work)))

        def total(clock, fns):
            return sum(clock(fn) for fn in fns)

        launch = [lambda a=args, k=kwargs: kernel(*a, **k)
                  for args, kwargs in calls[name]]
        per_ms = [timers.graph(fn) for fn in launch]
        lib_ms = None if work[0][2] is None else [timers.graph(w[2]) for w in work]
        row = dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{stem}.cu",
            replaces=replaces, max_abs_err=max_err,
            random_max_ulp=worst, served_elements_differ=n_diff,
            ms=sum(per_ms), per_launch_ms=per_ms, launch_floor_ms=floor_ms,
            call_ms=total(timers.call, launch),
            plain_ms=total(timers.call, [
                lambda a=args, k=kwargs: plain(*a, **plain_kwargs(name, k))
                for args, kwargs in calls[name]]),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if lib_ms is None else sum(lib_ms),
            plan=[bf16_plan(name, args, kwargs, device)
                  for args, kwargs in calls[name]],
            note=BF16_NOTES.get(name))
        rows.append(row)
        print("bf16_kernel " + json.dumps({
            "name": name, "ms": row["ms"], "library_ms": row["library_ms"],
            "ratio": None if lib_ms is None else row["ms"] / row["library_ms"],
            "bound_ms": b_ms, "share": b_ms / row["ms"], "per_launch_ms": per_ms,
            "per_launch_library_ms": lib_ms, "launch_floor_ms": floor_ms}))
    return rows


def bf16_plan(name, args, kwargs, device):
    """The launch plan the wrapper makes for one call."""
    import dataclasses

    from repro_torch.kernels import goap_conv, lif_update, wm_fc

    if name == "lif_update_fused_bf16":
        cur, v0, alpha = args[:3]
        return dataclasses.asdict(lif_update.plan_lif_bf16_launch(
            *cur.shape, alpha.shape[0], kwargs.get("inner", 1),
            goap_conv._n_sms(device), align=lif_update._alignment(cur, v0)))

    if name == "wm_fc_matmul_bf16":
        sp, w = args
        return dataclasses.asdict(wm_fc.plan_wm_fc_bf16_launch(*sp.shape, w.shape[1]))
    if name == "goap_conv_block_sparse_bf16":
        blocks, _, x = args
        return dataclasses.asdict(goap_conv.plan_goap_conv_bf16_launch(
            *blocks.shape, *x.shape, n_sms=goap_conv._n_sms(device)))
    return None


def run_bf16_phase(device, timers, seed: int = SEED):
    """The paper's SNN with bf16 weights at full width (``init_snn(seed,
    SNNConfig(), dtype=torch.bfloat16)``, density-0.5 masks in bf16, batch
    64, the 256 requests).  Returns (the three bf16 forms' rows, launches
    of the served path)."""
    import numpy as np
    import torch

    from repro_torch.api import (AsyncAMCServeEngine, SNNConfig, compile_plan,
                                 compile_snn, init_snn)
    from repro_torch.data.pipeline import sigma_delta_encode_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    cfg = SNNConfig()
    params = init_snn(seed, cfg, dtype=torch.bfloat16)
    masks = bf16_masks(params)
    program = compile_snn(cfg)
    rng = np.random.default_rng(seed)
    iq = rng.normal(size=(REQUESTS, cfg.conv_specs[0][1], cfg.input_width)
                    ).astype(np.float32)
    frames = [sigma_delta_encode_batch(torch.as_tensor(chunk, device=device),
                                       cfg.timesteps)
              for chunk in np.split(iq, REQUESTS // BATCH)]
    frames_b = frames[0]
    plan = compile_plan(program, params, masks=masks, assignment="cuda",
                        device=device)

    # 1. each bf16 form against its plain version, then timed
    _, calls = served_bf16_calls(plan, frames_b)
    rows = check_bf16_kernels(calls, device, timers, seed)

    # 2. the captured cuda engine serves the 256 requests
    reset_launch_counts()
    t0 = time.perf_counter()
    with AsyncAMCServeEngine(params, cfg, masks, backend="cuda",
                             max_batch=BATCH, device=device) as engine:
        futures = [engine.submit(frame) for frame in iq]
        failed = 0
        preds = np.full(REQUESTS, -1)
        for i, f in enumerate(futures):
            try:
                preds[i] = f.result(timeout=600)
            except Exception as e:  # noqa: BLE001 — counted, then gated
                failed += 1
                print(f"  bf16 request {i} failed: {e!r}")
        stats = engine.stats.summary()
        graphs = engine.get_version(engine.active_version).graphs
        shapes = graphs.shapes() if graphs is not None else ()
        replays = graphs.replays if graphs is not None else 0
        per_replay = graphs.launches(shapes[0]) if shapes else {}
    torch.cuda.synchronize()
    served = launch_counts()
    serve_s = time.perf_counter() - t0
    print(f"  bf16 served: {REQUESTS} requests, {failed} failed, "
          f"{stats['throughput_fps']:.1f} frames/s, p50 {stats['p50_ms']:.3f} "
          f"ms, p99 {stats['p99_ms']:.3f} ms; {len(shapes)} graphs, {replays} "
          f"replays, per replay {per_replay}; launches {served}")
    if failed:
        raise AssertionError(f"{failed} bf16 requests failed")
    want_kernels = {"goap_conv_block_sparse", "lif_update_fused",
                    "wm_fc_matmul_bf16", "lif_update_fused_bf16"}
    expect_launches(served, want_kernels, "bf16 served path")
    if graphs is None or set(per_replay) != want_kernels or any(
            served[k] != n * (len(shapes) + replays) for k, n in per_replay.items()):
        raise AssertionError("the bf16 cuda step did not run by graph replay "
                             "alone")
    with torch.inference_mode():
        layered = torch.cat([plan.bound.batch(f) for f in frames])
    n_pred = int((layered.argmax(-1).cpu().numpy() != preds).sum())
    print(f"  bf16 served predictions vs the card's layered cuda path: "
          f"{n_pred} of {REQUESTS} differ")
    if n_pred or layered.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 served predictions: {n_pred} differ; "
                             f"layered logits {layered.dtype}")

    backends = bf16_card_vs_cpu(program, params, masks, frames_b, device)
    bf16_fused_equals_upcast(program, params, masks, frames_b, device)
    engines = bf16_engines(program, params, masks, iq[:BATCH], frames_b, device)
    print("bf16_phase " + json.dumps({
        "seconds": time.perf_counter() - t_phase, "serve_s": serve_s,
        "requests": REQUESTS, "failed": failed,
        "frames_per_s": stats["throughput_fps"], "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"], "graphs": len(shapes), "replays": replays,
        "per_replay": per_replay, "launches": served,
        "card_vs_cpu": backends, "engines": engines, "card": nvidia_smi()}))
    return rows, served


def bf16_engines(program, params, masks, iq, frames_b, device) -> dict:
    """An ``AsyncAMCServeEngine`` on the bf16 model for each backend and for
    the default race (``auto``: dense, goap, cuda and cuda_fused timed on
    one probe, the kernel backends raising nothing): each serves the batch
    by graph replay with its plan's own predictions.  Returns the race's
    timings and each engine's backend."""
    import numpy as np
    import torch

    from repro_torch.api import AsyncAMCServeEngine, compile_plan

    out = {}
    for backend in BF16_BACKENDS + ("auto",):
        with AsyncAMCServeEngine(params, program.cfg, masks, backend=backend,
                                 max_batch=BATCH, device=device) as engine:
            preds = serve_all(engine, iq)
            graphs = engine.get_version(engine.active_version).graphs
            chosen = engine.backend
            report = engine.autotune.summary() if backend == "auto" else None
        plan = compile_plan(program, params, masks=masks, assignment=chosen,
                            device=device)
        with torch.inference_mode():
            want = plan.preferred_batch()(frames_b).argmax(-1).cpu().numpy()
        n_diff = int((preds != want).sum())
        out[backend] = {"served_by": chosen, "predictions_differ": n_diff}
        if report is not None:
            check_race_errors(report["errors"], "bf16 autotune race")
            if report["fell_back"] or not {"cuda", "cuda_fused"} <= set(
                    report["timings_ms"]):
                raise AssertionError(f"bf16 race did not time both kernel "
                                     f"backends: {report}")
            out[backend]["timings_ms"] = report["timings_ms"]
        print(f"  bf16 engine {backend}: served by {chosen}, "
              f"{'captured' if graphs is not None else 'NOT captured'}, "
              f"{n_diff} of {len(preds)} predictions differ from its plan")
        if graphs is None or n_diff or not np.all(preds >= 0):
            raise AssertionError(f"bf16 engine {backend}: not captured or "
                                 "predictions differ from its plan")
    return out


def bf16_card_vs_cpu(program, params, masks, frames_b, device) -> dict:
    """Each backend on the card against the same backend on the CPU (its
    plain path) on one batch: predictions equal, logits within 1 bf16 ulp,
    bf16 logits on the layered paths and f32 from the fused kernel."""
    import torch

    from repro_torch.api import compile_plan

    backends = {}
    for backend in BF16_BACKENDS:
        card = compile_plan(program, params, masks=masks, assignment=backend,
                            device=device)
        cpu = compile_plan(program, params, masks=masks,
                           assignment=backend, device="cpu")
        paths = [("layered", card.bound.batch, cpu.bound.batch)]
        if backend == "cuda_fused":
            paths.append(("fused", card.batch, cpu.batch))
        for path, on_card, on_cpu in paths:
            with torch.inference_mode():
                got = on_card(frames_b).cpu()
                want = on_cpu(frames_b.cpu())
            want_dtype = torch.float32 if path == "fused" else torch.bfloat16
            ulps = float(bf16_ulps(got, want).max())
            diff = float((got.float() - want.float()).abs().max())
            n_pred = int((got.argmax(-1) != want.argmax(-1)).sum())
            backends[f"{backend}_{path}"] = {"max_abs_diff": diff,
                                             "max_ulp": ulps,
                                             "predictions_differ": n_pred}
            print(f"  bf16 {backend} {path}: card vs CPU max |diff| {diff} "
                  f"({ulps} bf16 ulp), {n_pred} of {BATCH} predictions differ, "
                  f"logits {got.dtype}")
            if (got.dtype != want_dtype or want.dtype != want_dtype or ulps > 1.0
                    or n_pred or not torch.isfinite(got.float()).all()):
                raise AssertionError(f"bf16 {backend} {path}: card and CPU "
                                     "disagree")

    return backends


def bf16_fused_equals_upcast(program, params, masks, frames_b, device) -> None:
    """The fused kernel casts its operands: bf16 weights serve exactly the
    f32 model on their upcast, under another plan digest."""
    import torch

    from repro_torch.api import compile_plan

    up_params = {g: [{"w": lp["w"].float(), "lif": type(lp["lif"])(
        *(a.float() for a in (lp["lif"].alpha_logit, lp["lif"].theta,
                              lp["lif"].v_th)))} for lp in params[g]]
        for g in ("conv", "fc")}
    up_masks = {g: [m.float() for m in ms] for g, ms in masks.items()}
    fused_bf = compile_plan(program, params, masks=masks,
                            assignment="cuda_fused", device=device)
    fused_up = compile_plan(program, up_params, masks=up_masks,
                            assignment="cuda_fused", device=device)
    if fused_bf.digest == fused_up.digest:
        raise AssertionError("a bf16 model and its f32 upcast share a plan")
    got, want = fused_bf.batch(frames_b), fused_up.batch(frames_b)
    torch.cuda.synchronize()
    print(f"  bf16 cuda_fused vs the f32 upcast: {got.dtype}, bit-equal "
          f"{torch.equal(got, want)}")
    if got.dtype != torch.float32 or not torch.equal(got, want):
        raise AssertionError("the fused kernel on bf16 weights differs from "
                             "the f32 model on their upcast")


# ---------------------------------------------------------------------------
# operands_phase: what one layer-by-layer batch launches on the card, for
# this tree and (``--parent DIR``: an unpacked earlier tree) for another.
# ---------------------------------------------------------------------------

PROBE_REPLAYS = 20


def device_kernels(fn) -> dict:
    """The device operations of one call of ``fn`` (``torch.profiler``):
    kernels and copies counted apart, the kernels by name."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [n for n in names if n.startswith(("Memcpy", "Memset"))]
    kernels = collections.Counter(n[:80] for n in names if n not in copies)
    return {"device_kernels": sum(kernels.values()), "copies": len(copies),
            "by_name": dict(kernels.most_common())}


def run_probe() -> dict:
    """One eager layer-by-layer batch of the ``cuda`` plan (bf16 and f32
    models, batch 64, seed-0 weights, density 0.5): its device kernels, and
    the device ms of one replay of the same batch captured in a CUDA graph
    (CUDA events around the replay alone, median of ``PROBE_REPLAYS``).
    Uses only names every tree of the port since slice 12 has."""
    import numpy as np
    import torch

    from repro_torch.api import (SNNConfig, compile_plan, compile_snn, init_snn,
                                 make_mask_pytree)
    from repro_torch.data.pipeline import sigma_delta_encode_batch
    from repro_torch.kernels.timing import graph_ms
    from repro_torch.plan import PlanCache, set_default_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    set_default_cache(PlanCache(disk_dir=""))
    device = torch.device("cuda", 0)
    cfg = SNNConfig()
    iq = np.random.default_rng(SEED).normal(
        size=(BATCH, cfg.conv_specs[0][1], cfg.input_width)).astype(np.float32)
    frames = sigma_delta_encode_batch(torch.as_tensor(iq, device=device),
                                      cfg.timesteps)
    out = {}
    with torch.no_grad():
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            params = init_snn(SEED, cfg, dtype=dtype)
            masks = (bf16_masks(params) if dtype == torch.bfloat16
                     else make_mask_pytree(params, DENSITY))
            plan = compile_plan(compile_snn(cfg), params, masks=masks,
                                assignment="cuda", device=device)
            for _ in range(2):
                plan.bound.batch(frames)
            out[name] = {**device_kernels(lambda: plan.bound.batch(frames)),
                         "replay_ms": graph_ms(lambda: plan.bound.batch(frames),
                                               calls=1, replays=PROBE_REPLAYS)}
    return out


def probe_tree(tree: pathlib.Path) -> dict:
    """:func:`run_probe` on ``tree``'s package, in a process of its own."""
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    done = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                           "--probe", str(tree)], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith("probe ")]
    if done.returncode != 0 or not lines:
        raise AssertionError(f"the probe of {tree} failed ({done.returncode}):\n"
                             f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    return json.loads(lines[-1][len("probe "):])


def run_operands_phase(parent: typing.Optional[pathlib.Path]) -> dict:
    """The device kernels of one eager layered batch and the captured bf16
    batch's replay ms, for this tree and, given ``--parent``, for the
    parent's, in turns (parent, this, this, parent).  Prints
    ``operands_phase``; fails if the probe of this tree saw no kernel."""
    trees = ([("parent", parent), ("this", ROOT), ("this", ROOT),
              ("parent", parent)] if parent is not None else [("this", ROOT)])
    runs = {"this": [], "parent": []}
    for label, tree in trees:
        runs[label].append(probe_tree(tree))
    line = {}
    for label, probes in runs.items():
        if not probes:
            continue
        line[label] = {d: {"device_kernels": probes[0][d]["device_kernels"],
                           "copies": probes[0][d]["copies"],
                           "replay_ms": [p[d]["replay_ms"] for p in probes],
                           "by_name": probes[0][d]["by_name"]}
                       for d in ("bf16", "f32")}
    for d in ("bf16", "f32"):
        if not line["this"][d]["device_kernels"]:
            raise AssertionError(f"the {d} layered batch ran no device kernel")
        if "parent" in line:
            line[f"{d}_fewer_kernels"] = (line["parent"][d]["device_kernels"]
                                          - line["this"][d]["device_kernels"])
    line["card"] = nvidia_smi()
    print("operands_phase " + json.dumps(line))
    return line


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--probe":
        if not torch.cuda.is_available():
            return 2
        sys.path.insert(0, str(pathlib.Path(sys.argv[2]) / "src"))
        print("probe " + json.dumps(run_probe()))
        return 0
    parent = None
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        parent = pathlib.Path(sys.argv[2]).resolve()
    elif len(sys.argv) != 1:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2

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
    result = run(device, Timers(call_ms, graph_ms, host_timer), parent=parent)
    for row in result["kernels"]:
        model = f" ({row['model']})" if row.get("model") else ""
        print(f"  {row['name']}{model}: {row['ms']:.4f} ms (one call "
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
