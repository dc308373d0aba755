"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports neither jax nor the reference package, so it also runs where
only PyTorch is installed; there, run it without the repository's
conftest (which loads the reference's plan cache):

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (
    AsyncAMCServeEngine,
    SNNConfig,
    compile_plan,
    compile_snn,
    init_snn,
    make_mask_pytree,
)
from repro_torch.core.lif import init_lif_params
from repro_torch.core.sparse_format import block_sparse_from_dense
from repro_torch.data.pipeline import sigma_delta_encode_batch
from repro_torch.kernels import (
    goap_conv_block_sparse,
    goap_conv_block_sparse_inorder,
    goap_conv_op,
    launch_counts,
    lif_op,
    reset_launch_counts,
    stream_fused_forward,
    stream_fused_forward_ref,
    wm_fc_matmul,
    wm_fc_matmul_inorder,
    wm_fc_matmul_ref,
)
from repro_torch.kernels.stream_fused import (
    CLUSTERS,
    THREAD_COUNTS,
    max_active_clusters,
    plan_stream_fused_launch,
)

SMALL = SNNConfig(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
                  fc_specs=((64, 16), (16, 5)), input_width=32,
                  timesteps=4, n_classes=5).validate()


@pytest.fixture(scope="module", autouse=True)
def plan_cache_in_memory():
    """Keep the port's plan cache off the disk while these tests run (the
    jax-free twin of ``tests/_torch_parity.py``'s fixture)."""
    from repro_torch.plan import PlanCache, cache, set_default_cache

    old = cache._default
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cache.ENV_DIR, "")
        set_default_cache(PlanCache())
        yield
    set_default_cache(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _plan(cfg, seed, device, backend="cuda_fused"):
    params = init_snn(seed, cfg)
    masks = make_mask_pytree(params, 0.5)
    return compile_plan(compile_snn(cfg), params, masks=masks,
                        assignment=backend, device=device), params, masks


def _iq(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.conv_specs[0][1], cfg.input_width)
                      ).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SMALL, SNNConfig()], ids=["small", "paper"])
def test_fused_kernel_equals_plain_bit_for_bit(cuda, cfg):
    plan, _, _ = _plan(cfg, 0, cuda)
    stack = plan.fused_stack()
    iq = torch.as_tensor(_iq(cfg, 5, 1), device=cuda)
    frames = sigma_delta_encode_batch(iq, cfg.timesteps)
    analog = 0.5 * (iq / (iq.abs().amax((-2, -1), keepdim=True) + 1e-8) + 1.0)
    for encode, x in ((False, frames), (True, analog)):
        got = stream_fused_forward(stack, x, encode=encode)
        want = stream_fused_forward_ref(stack, x, encode=encode)
        torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)


def _fused_inputs(cfg, b, seed, device):
    """Binary frames, analog frames for encode=True, and non-binary frames
    (normal values, a third of them 0) for encode=False."""
    iq = torch.as_tensor(_iq(cfg, b, seed), device=device)
    frames = sigma_delta_encode_batch(iq, cfg.timesteps)
    analog = 0.5 * (iq / (iq.abs().amax((-2, -1), keepdim=True) + 1e-8) + 1.0)
    rng = np.random.default_rng(seed + 1)
    raw = rng.normal(size=tuple(frames.shape)) * (rng.random(tuple(frames.shape)) < 2 / 3)
    return ((False, frames), (True, analog),
            (False, torch.as_tensor(raw.astype(np.float32), device=device)))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SMALL, SNNConfig()], ids=["small", "paper"])
@pytest.mark.parametrize("b", [1, 3, 64, 65, 300])
def test_fused_kernel_every_cluster_size_equals_plain(cuda, cfg, b):
    """Every cluster size and thread count the planner can choose, both
    encode modes and non-binary frames, against the plain version bit for
    bit; SMALL also with its FC weights streamed from global memory."""
    plan, _, _ = _plan(cfg, 0, cuda)
    stack = plan.fused_stack()
    launches = [plan_stream_fused_launch(stack, b, cluster=c, threads=n)
                for c in CLUSTERS for n in THREAD_COUNTS]
    if cfg is SMALL:
        launches += [plan_stream_fused_launch(stack, b, cluster=c,
                                              fc_resident=(False, False))
                     for c in (1, 4)]
    for encode, x in _fused_inputs(cfg, b, 3, cuda):
        want = stream_fused_forward_ref(stack, x, encode=encode)
        for launch in launches:
            assert max_active_clusters(launch) > 0
            got = stream_fused_forward(stack, x, encode=encode, plan=launch)
            torch.cuda.synchronize()
            what = (f"C={launch.cluster} threads={launch.threads} "
                    f"resident={launch.fc_resident} encode={encode}")
            for g, w_ in zip(got, want):
                torch.testing.assert_close(g, w_, atol=0, rtol=0,
                                           msg=lambda m: f"{what}: {m}")


# a pool of 3 runs the kernel's general pool path (a power of two pools on
# neighbouring lanes), with the spike-count readout
POOL3 = SNNConfig(conv_specs=((3, 2, 4), (3, 4, 8)), pool=3,
                  fc_specs=((32, 16), (16, 5)), input_width=36, timesteps=4,
                  n_classes=5, readout="spike_count").validate()


@pytest.mark.cuda
def test_fused_kernel_general_pool_equals_plain(cuda):
    plan, _, _ = _plan(POOL3, 1, cuda)
    stack = plan.fused_stack()
    for encode, x in _fused_inputs(POOL3, 3, 5, cuda):
        want = stream_fused_forward_ref(stack, x, encode=encode)
        for c in CLUSTERS:
            got = stream_fused_forward(stack, x, encode=encode,
                                       plan=plan_stream_fused_launch(stack, 3, cluster=c))
            for g, w_ in zip(got, want):
                torch.testing.assert_close(g, w_, atol=0, rtol=0,
                                           msg=lambda m: f"C={c} encode={encode}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SMALL, SNNConfig(), POOL3], ids=["small", "paper", "pool3"])
@pytest.mark.parametrize("b", [1, 3, 65])
def test_fused_kernel_bit_layout_equals_plain(cuda, cfg, b):
    """The bit layout at every cluster size and thread count, both encode
    modes and non-binary frames, against the plain version bit for bit."""
    stack = _plan(cfg, 0, cuda)[0].fused_stack()
    launches = [plan_stream_fused_launch(stack, b, cluster=c, threads=n, spikes="bits")
                for c in CLUSTERS for n in THREAD_COUNTS]
    for encode, x in _fused_inputs(cfg, b, 3, cuda):
        want = stream_fused_forward_ref(stack, x, encode=encode)
        for launch in launches:
            assert launch.spikes == "bits" and max_active_clusters(launch) > 0
            got = stream_fused_forward(stack, x, encode=encode, plan=launch)
            torch.cuda.synchronize()
            what = f"C={launch.cluster} threads={launch.threads} encode={encode}"
            for g, w_ in zip(got, want):
                torch.testing.assert_close(g, w_, atol=0, rtol=0,
                                           msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
def test_per_layer_kernels_equal_plain(cuda):
    rng = np.random.default_rng(0)
    s = torch.as_tensor((rng.random((16, 256)) < 0.5).astype(np.float32), device=cuda)
    w = torch.as_tensor(rng.normal(size=(256, 40)).astype(np.float32), device=cuda)
    torch.testing.assert_close(wm_fc_matmul(s, w), wm_fc_matmul_ref(s, w),
                               atol=1e-5, rtol=0)
    k = ((rng.random((5, 8, 16)) < 0.5)
         * rng.normal(size=(5, 8, 16))).astype(np.float32)
    ifm = (rng.random((3, 8, 36)) < 0.5).astype(np.float32)
    bs = block_sparse_from_dense(k, block_oc=8, block_k=32)
    torch.testing.assert_close(
        goap_conv_op(torch.as_tensor(ifm, device=cuda), bs).cpu(),
        goap_conv_op(torch.as_tensor(ifm), bs), atol=1e-5, rtol=0)
    cur = rng.normal(size=(4, 3, 16, 32)).astype(np.float32)
    got = lif_op(torch.as_tensor(cur, device=cuda), init_lif_params((16, 1)).to(cuda))
    want = lif_op(torch.as_tensor(cur), init_lif_params((16, 1)))
    torch.testing.assert_close(got[0].cpu(), want[0], atol=0, rtol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match="float32"):
        wm_fc_matmul(s.double(), w.double())


@pytest.mark.cuda
def test_plan_paths_agree_and_launch_their_kernels(cuda):
    plan, params, masks = _plan(SMALL, 2, cuda)
    frames = sigma_delta_encode_batch(
        torch.as_tensor(_iq(SMALL, 8, 3), device=cuda), SMALL.timesteps)
    reset_launch_counts()
    fused = plan.batch(frames)
    layered = plan.bound.batch(frames)
    counts = launch_counts()
    assert counts["stream_fused_forward"] == 1
    assert counts["goap_conv_block_sparse"] == 2     # one per conv layer
    assert counts["wm_fc_matmul"] == 2               # one per FC layer
    assert counts["lif_update_fused"] == 4           # one per LIF layer
    torch.testing.assert_close(layered, fused, atol=1e-5, rtol=0)
    dense, _, _ = _plan(SMALL, 2, cuda, backend="dense")
    torch.testing.assert_close(dense.bound.batch(frames), fused, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_engine_serves_through_the_fused_kernel(cuda):
    plan, params, masks = _plan(SMALL, 4, cuda)
    iq = _iq(SMALL, 13, 5)
    reset_launch_counts()
    with AsyncAMCServeEngine(params, SMALL, masks, backend="cuda_fused",
                             max_batch=8, warmup=False) as engine:
        preds = engine.classify(iq)
    assert launch_counts()["stream_fused_forward"] >= 2
    want = plan.batch(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=cuda), SMALL.timesteps)).argmax(-1)
    np.testing.assert_array_equal(preds, want.cpu().numpy())



@pytest.mark.cuda
def test_captured_step_spans_come_in_order_inside_engine_step(cuda, monkeypatch):
    import time

    from repro_torch.obs import trace

    plan, params, masks = _plan(SMALL, 4, cuda)
    with AsyncAMCServeEngine(params, SMALL, masks, backend="cuda_fused",
                             max_batch=8) as engine:
        engine.classify(_iq(SMALL, 8, 6))     # warm: every bucket captured
        monkeypatch.setattr(trace, "_tracer", None)
        trace.enable_tracing()
        # the worker's poll that was waiting when tracing began records
        # nothing; its next ones do
        engine.classify(_iq(SMALL, 8, 6))
        t0 = time.perf_counter()
        engine.classify(_iq(SMALL, 13, 7))
    w = trace._the_log().between(t0, float("inf"))
    sp = w.spans
    inner = ["step.copy_in", "step.replay", "step.copy_out", "step.sync"]
    steps = np.nonzero(sp["name"] == "engine.step")[0]
    assert len(steps) >= 2 and int(w.batches["n_real"].sum()) == 13
    for i in steps:
        kids = np.nonzero(sp["parent"] == sp["id"][i])[0]
        kids = kids[np.argsort(sp["t0"][kids])]
        names = list(sp["name"][kids])
        # the captured step's unpack, then the engine's split of the counters
        assert names[:4] == inner and names[4:] in (
            ["step.unpack"], ["step.unpack"] * 2), names
        assert (sp["t0"][kids[1:]] >= sp["t1"][kids[:-1]]).all()
        assert sp["t0"][kids[0]] >= sp["t0"][i]
        assert sp["t1"][kids[-1]] <= sp["t1"][i]

# The layer-by-layer path's conv and FC operands on the paper model at
# batch 64, T = 8: X' has 512 * W columns, the FCs take 512 rows.
PAPER_CONVS = [(11, 2, 16, 128), (11, 16, 32, 64), (5, 32, 64, 32)]   # kw, ic, oc, W
LAYERED_ROWS = 64 * 8


def _bits_equal(got, want):
    """Bit-for-bit equality (the in-order versions never give -0)."""
    assert got.shape == want.shape
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"max |err| {float((got - want).abs().max())}")


def _conv_operands(kw, ic, oc, oi, seed, device, bo=8, bk=32):
    rng = np.random.default_rng(seed)
    k = ((rng.random((kw, ic, oc)) < 0.5)
         * rng.normal(size=(kw, ic, oc))).astype(np.float32)
    bs = block_sparse_from_dense(k, block_oc=bo, block_k=bk)
    x = (rng.random((bs.padded_k, oi)) < 0.5).astype(np.float32)
    return (torch.as_tensor(bs.blocks, device=device),
            torch.as_tensor(bs.block_cols, device=device),
            torch.as_tensor(x, device=device))


def _goap(blocks, cols, x):
    return goap_conv_block_sparse(blocks, cols, x, block_oc=blocks.shape[2],
                                  block_k=blocks.shape[3])


@pytest.mark.cuda
@pytest.mark.parametrize("kw,ic,oc,w", PAPER_CONVS, ids=["conv1", "conv2", "conv3"])
def test_goap_conv_equals_inorder_at_paper_shapes(cuda, kw, ic, oc, w):
    blocks, cols, x = _conv_operands(kw, ic, oc, LAYERED_ROWS * w, 0, cuda)
    _bits_equal(_goap(blocks, cols, x), goap_conv_block_sparse_inorder(blocks, cols, x))


def _raw_conv(rng, r, mt, bo, bk, nk, oi, device):
    """Random tiles with repeated, unordered k-tile lists."""
    return (torch.as_tensor(rng.normal(size=(r, mt, bo, bk)).astype(np.float32), device=device),
            torch.as_tensor(rng.integers(0, nk, (r, mt)).astype(np.int32), device=device),
            torch.as_tensor((rng.random((nk * bk, oi)) < 0.5).astype(np.float32),
                            device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_strip", "oi_not_multiple_of_4", "non_binary",
                                  "unordered_repeated_cols", "bo4", "bo16", "bo6",
                                  "bo3", "all_zero", "all_one", "single_column"])
def test_goap_conv_edges_equal_inorder(cuda, case):
    rng = np.random.default_rng(7)
    oi = {"ragged_strip": 1000, "oi_not_multiple_of_4": 37, "single_column": 1}.get(case, 256)
    bo = {"bo4": 4, "bo16": 16, "bo6": 6, "bo3": 3}.get(case, 8)
    if case == "unordered_repeated_cols":
        blocks, cols, x = _raw_conv(rng, 3, 4, 8, 16, 5, 300, cuda)
    else:
        blocks, cols, x = _conv_operands(5, 12, 40, oi, 3, cuda, bo=bo)
    if case == "non_binary":
        x = torch.as_tensor(rng.normal(size=tuple(x.shape)).astype(np.float32), device=cuda)
        x[x.abs() < 0.5] = 0.0
    elif case == "all_zero":
        x = torch.zeros_like(x)
    elif case == "all_one":
        x = torch.ones_like(x)
    _bits_equal(_goap(blocks, cols, x), goap_conv_block_sparse_inorder(blocks, cols, x))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [5, -1])
def test_goap_conv_out_of_range_tile_gives_nan_rows(cuda, bad):
    rng = np.random.default_rng(8)
    blocks, cols, x = _raw_conv(rng, 3, 4, 8, 16, 5, 130, cuda)
    cols[1, 2] = bad
    got = _goap(blocks, cols, x)
    want = goap_conv_block_sparse_inorder(blocks, cols, x)
    assert torch.isnan(got[8:16]).all() and torch.isnan(want[8:16]).all()
    _bits_equal(got[:8], want[:8])
    _bits_equal(got[16:], want[16:])


def _fc_operands(b, din, dout, seed, device, spikes="binary"):
    rng = np.random.default_rng(seed)
    s = {"binary": (rng.random((b, din)) < 0.5).astype(np.float32),
         "zero": np.zeros((b, din), np.float32),
         "one": np.ones((b, din), np.float32),
         "non_binary": (rng.random((b, din)) < 0.5) * rng.normal(size=(b, din))}[spikes]
    w = ((rng.random((din, dout)) < 0.5) * rng.normal(size=(din, dout))).astype(np.float32)
    return (torch.as_tensor(np.asarray(s, np.float32), device=device),
            torch.as_tensor(w, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,din,dout,spikes", [
    (LAYERED_ROWS, 1024, 128, "binary"),      # FC1 on the layered path
    (LAYERED_ROWS, 128, 11, "binary"),        # FC2
    (1, 1024, 128, "binary"),
    (1, 128, 11, "binary"),
    (37, 100, 11, "binary"),                  # IN and OUT not multiples of 4
    (64, 1024, 128, "zero"),
    (64, 1024, 128, "one"),
    (64, 300, 11, "non_binary"),
    (70_000, 64, 11, "binary"),               # more rows than one grid axis
], ids=["fc1", "fc2", "batch1_fc1", "batch1_fc2", "unaligned", "all_zero",
        "all_one", "non_binary", "big_batch"])
def test_wm_fc_equals_inorder(cuda, b, din, dout, spikes):
    s, w = _fc_operands(b, din, dout, 1, cuda, spikes)
    _bits_equal(wm_fc_matmul(s, w), wm_fc_matmul_inorder(s, w))


# ---------------------------------------------------------------------------
# The measurement plane and the integer tier on the card.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SMALL, SNNConfig()], ids=["small", "paper"])
def test_stream_backend_counts_what_the_fused_kernel_counts(cuda, cfg):
    fused, params, masks = _plan(cfg, 6, cuda)
    stream = compile_plan(compile_snn(cfg), params, masks=masks,
                          assignment="stream", device=cuda)
    frames = sigma_delta_encode_batch(
        torch.as_tensor(_iq(cfg, 8, 7), device=cuda), cfg.timesteps)
    logits, accs = stream.batch_counters(frames)
    _, conv_accs = stream_fused_forward(fused.fused_stack(), frames)
    for i, name in enumerate(fused.fused_stack().conv_names):
        assert torch.equal(accs[name], conv_accs[:, i]), name
    cpu = compile_plan(compile_snn(cfg), params, masks=masks,
                       assignment="stream", device="cpu")
    want, want_accs = cpu.batch_counters(frames.cpu())
    torch.testing.assert_close(logits.cpu(), want, atol=1e-5, rtol=0)
    for name in want_accs:
        assert torch.equal(accs[name].cpu(), want_accs[name])


@pytest.mark.cuda
def test_engine_gauges_on_the_card_equal_stream_counters(cuda):
    from repro_torch.obs import metrics

    fresh = metrics.MetricsRegistry()
    old = metrics.set_default_registry(fresh)
    try:
        _, params, masks = _plan(SMALL, 8, cuda)
        iq = _iq(SMALL, 13, 9)
        with AsyncAMCServeEngine(params, SMALL, masks, backend="cuda_fused",
                                 max_batch=8, name="card") as engine:
            engine.classify(iq)
            padded = engine.stats.padded_frames
    finally:
        metrics.set_default_registry(old)
    stream = compile_plan(compile_snn(SMALL), params, masks=masks,
                          assignment="stream", device=cuda)
    _, accs = stream.batch_counters(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=cuda), SMALL.timesteps))
    assert padded > 0
    for name, a in accs.items():
        assert fresh.value("repro_activity_accumulations_total", engine="card",
                           layer=name) == float(a.double().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SMALL, SNNConfig()], ids=["small", "paper"])
@pytest.mark.parametrize("bits", [8, 16])
def test_fixed_backend_on_the_card_bit_equal_to_golden(cuda, cfg, bits):
    from repro_torch.fixed import FixedQuantFn, build_golden
    from repro_torch.train.lsq import init_lsq_scales

    params = init_snn(10, cfg)
    masks = make_mask_pytree(params, 0.5)
    scales = init_lsq_scales(params, bits)
    iq = _iq(cfg, 6, 11)
    with AsyncAMCServeEngine(params, cfg, masks, backend="fixed", max_batch=8,
                             lsq_scales=scales, quant_bits=bits) as engine:
        logits = engine.step(iq)
        preds = engine.classify(iq)
    golden = build_golden(cfg, params, masks=masks,
                          quant_fn=FixedQuantFn(scales, bits))
    want = np.stack([golden.forward_iq(f) for f in iq])
    assert logits.dtype == np.int32
    np.testing.assert_array_equal(logits, want)
    np.testing.assert_array_equal(preds, want.argmax(-1))


@pytest.mark.cuda
def test_lsq_fake_quant_on_the_card_equals_the_cpu(cuda):
    from repro_torch.train.lsq import lsq_fake_quant

    rng = np.random.default_rng(12)
    w = rng.normal(size=(11, 16, 32)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=w.shape).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        wt = torch.tensor(w, device=dev, requires_grad=True)
        st = torch.tensor(0.01, device=dev, requires_grad=True)
        out = lsq_fake_quant(wt, st, 8)
        (out * g.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), wt.grad.cpu(), float(st.grad)))
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-6, atol=1e-6)
    assert abs(grads[0][2] - grads[1][2]) <= 1e-6 * max(1.0, abs(grads[0][2]))


@pytest.mark.cuda
def test_lsq_served_through_the_fused_kernel(cuda):
    """cuda_fused with LSQ step sizes serves the fake-quantized weights
    through the whole-network kernel: the plain goap plan on the same
    quantized weights predicts the same."""
    from repro_torch.train.lsq import init_lsq_scales, make_serving_quant_fn

    params = init_snn(13, SNNConfig())
    masks = make_mask_pytree(params, 0.5)
    scales = init_lsq_scales(params, 8)
    iq = _iq(SNNConfig(), 16, 14)
    reset_launch_counts()
    with AsyncAMCServeEngine(params, SNNConfig(), masks, backend="cuda_fused",
                             max_batch=16, lsq_scales=scales,
                             quant_bits=8) as engine:
        preds = engine.classify(iq)
    assert launch_counts()["stream_fused_forward"] >= 1
    goap = compile_plan(compile_snn(SNNConfig()), params, masks=masks,
                        quant_fn=make_serving_quant_fn(scales, 8),
                        assignment="goap", device=cuda)
    want = goap.bound.batch(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=cuda), 8)).argmax(-1)
    np.testing.assert_array_equal(preds, want.cpu().numpy())


# the reduced training config of tests/_torch_parity.py (T = 2, threshold
# 0.5 so that spikes reach the readout)
TRAIN_SMALL = SNNConfig(conv_specs=((3, 2, 4), (3, 4, 8), (3, 8, 8)),
                        fc_specs=((8 * 16, 16), (16, 11)), timesteps=2,
                        lif_v_th=0.5).validate()


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One training step (per-layer masks, 16-bit LSQ) on the card against
    the same step on the CPU, from the same state and batch: the loss
    within 1e-4 and the clipped gradients within 1e-3 in relative norm
    (chip_smoke's train-phase gate, at a reduced size)."""
    from repro_torch.train import SNNTrainer, TrainerConfig, make_mask_pytree
    from repro_torch.tree import tree_leaves, tree_map

    density = {"conv1": 0.5, "conv2": 0.4, "conv3": 0.3, "fc1": 0.4, "fc2": 0.5}
    tcfg = TrainerConfig(total_steps=6, batch_size=8, osr=2, use_lsq=True,
                         per_layer_density=density, prune_every=2)
    cpu = SNNTrainer(TRAIN_SMALL, tcfg, device="cpu")
    card = SNNTrainer(TRAIN_SMALL, tcfg, device=cuda)
    masks = make_mask_pytree(cpu.params, density)
    frames, labels, _ = cpu._batch(3, 10.0)
    got = card._gradients(card.params, card.lsq_scales,
                          tree_map(lambda m: m.to(cuda), masks),
                          frames.to(cuda), labels.to(cuda))
    want = cpu._gradients(cpu.params, cpu.lsq_scales, masks, frames, labels)
    assert abs(float(got[0]) - float(want[0])) <= 1e-4
    g = torch.cat([x.cpu().reshape(-1) for x in tree_leaves(got[2])]).double()
    w = torch.cat([x.reshape(-1) for x in tree_leaves(want[2])]).double()
    assert float((g - w).norm() / w.norm()) <= 1e-3


@pytest.mark.cuda
def test_auto_race_times_both_kernel_backends_on_the_card(cuda):
    """The default backend races dense, goap, cuda and cuda_fused on the
    card; both kernel backends are timed, none raises, and the winner
    serves the goap backend's predictions."""
    plan, params, masks = _plan(SMALL, 6, cuda, backend="goap")
    iq = _iq(SMALL, 13, 7)
    with AsyncAMCServeEngine(params, SMALL, masks, max_batch=8) as engine:
        report = engine.autotune
        preds = engine.classify(iq)
    assert set(report.timings_ms) == {"dense", "goap", "cuda", "cuda_fused"}
    assert not report.errors and not report.fell_back
    assert engine.backend == report.choice
    want = plan.bound.batch(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=cuda), SMALL.timesteps)).argmax(-1)
    np.testing.assert_array_equal(preds, want.cpu().numpy())


@pytest.mark.cuda
def test_per_layer_race_times_both_kernel_backends_on_the_card(cuda):
    plan, params, masks = _plan(SMALL, 6, cuda, backend="goap")
    iq = _iq(SMALL, 13, 8)
    reset_launch_counts()
    with AsyncAMCServeEngine(params, SMALL, masks, backend="per-layer",
                             max_batch=8) as engine:
        report = engine.perlayer
        preds = engine.classify(iq)
    counts = launch_counts()
    for layer in ("conv1", "conv2", "fc1", "fc2"):
        timings = report.timings_ms[layer]
        assert {"cuda", "cuda_fused"} <= set(timings)
        assert not report.errors[layer]
        # cuda and cuda_fused time one cell: a kernel win is cuda_fused
        if min(timings, key=timings.get) in ("cuda", "cuda_fused"):
            assert report.assignment[layer] == "cuda_fused"
    assert "cuda" not in report.assignment.values()
    assert not report.fell_back
    # the race ran each kernel backend's layers through their kernels
    assert counts["goap_conv_block_sparse"] and counts["wm_fc_matmul"]
    assert counts["lif_update_fused"]
    if set(report.assignment.values()) == {"cuda_fused"}:
        # an all-kernel assignment serves through the whole-network launch
        assert counts["stream_fused_forward"]
    want = plan.bound.batch(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=cuda), SMALL.timesteps)).argmax(-1)
    np.testing.assert_array_equal(preds, want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "per-layer"])
def test_a_failing_kernel_fails_the_engine_on_the_card(cuda, backend):
    """On the card a kernel backend that fails to build or launch must not
    be raced around onto plain PyTorch: the engine's construction raises."""
    from repro_torch.models import graph

    _, params, masks = _plan(SMALL, 21, cuda, backend="goap")

    def _boom(spec, layer_params, **kw):
        raise RuntimeError("kernel did not build")

    snapshot = dict(graph._REGISTRY)
    graph.register_backend("cuda", "conv_lif", _boom)
    try:
        with pytest.raises(RuntimeError, match="kernel did not build"):
            AsyncAMCServeEngine(params, SMALL, masks, backend=backend,
                                max_batch=8)
    finally:
        graph._REGISTRY.clear()
        graph._REGISTRY.update(snapshot)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["static_awgn", "urban_fading",
                                  "doppler_drift", "iq_impaired",
                                  "adjacent_interferer", "rician_los",
                                  "timing_drift"])
def test_channel_on_the_card_equals_the_cpu(cuda, name):
    """The draws come from host numpy streams, so a seed impairs frames
    alike on the card and on the CPU, within rounding."""
    from repro_torch.channel import apply_scenario_np
    from repro_torch.data.radioml import generate_batch

    iq, _, snrs = generate_batch(5, 64, apply_channel=False)
    card = apply_scenario_np(name, iq, snrs, 17, device=cuda)
    cpu = apply_scenario_np(name, iq, snrs, 17, device="cpu")
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_robustness_kernel_backends_agree_on_the_card(cuda):
    from repro_torch.eval import RobustnessConfig, evaluate_robustness

    params = init_snn(3, SMALL)
    reset_launch_counts()
    report = evaluate_robustness(
        params, SMALL, RobustnessConfig(
            suite="quick", snr_grid=(-10.0, 10.0), frames_per_cell=16,
            backends=("cuda_fused", "cuda", "goap")),
        masks=make_mask_pytree(params, 0.5), device=cuda)
    assert report["agreement"]["max_abs_logit_diff"] <= 1e-5
    # the f32 model launches every f32 form (and no bf16 one)
    assert all((n > 0) != name.endswith("_bf16")
               for name, n in launch_counts().items())


@pytest.mark.cuda
def test_hot_swap_on_the_card_serves_the_new_version(cuda):
    from repro_torch.data.pipeline import sigma_delta_encode_np
    from repro_torch.deploy import hot_swap

    p1, p2 = init_snn(0, SMALL), init_snn(1, SMALL)
    m2 = make_mask_pytree(p2, 0.5)
    iq = _iq(SMALL, 32, 4)
    with AsyncAMCServeEngine(p1, SMALL, make_mask_pytree(p1, 0.5),
                             backend="cuda_fused", max_batch=8,
                             version_label="v1") as engine:
        report = hot_swap(engine, p2, m2, label="v2")
        preds = engine.classify(iq)
    assert report.drained and report.backend == "cuda_fused"
    goap = compile_plan(compile_snn(SMALL), p2, masks=m2, assignment="goap",
                        device=cuda)
    want = goap.bound.batch(torch.as_tensor(
        sigma_delta_encode_np(iq, SMALL.timesteps), device=cuda))
    np.testing.assert_array_equal(preds, want.argmax(-1).cpu().numpy())


@pytest.mark.cuda
def test_a_failing_kernel_fails_bind_version_on_the_card(cuda):
    """A new version bound to a kernel backend that raises fails the bind:
    nothing falls back to a plain backend."""
    from repro_torch.models import graph

    _, params, masks = _plan(SMALL, 22, cuda, backend="goap")

    def _boom(spec, layer_params, **kw):
        raise RuntimeError("kernel did not build")

    with AsyncAMCServeEngine(params, SMALL, masks, backend="goap",
                             max_batch=8) as engine:
        snapshot = dict(graph._REGISTRY)
        graph.register_backend("cuda", "conv_lif", _boom)
        try:
            with pytest.raises(RuntimeError, match="kernel did not build"):
                engine.bind_version("v2", params, masks, backend="cuda")
        finally:
            graph._REGISTRY.clear()
            graph._REGISTRY.update(snapshot)
        assert set(engine.versions()) == {"default"}


# ---------------------------------------------------------------------------
# the served step captured in CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend,gauges", [
    ("cuda_fused", True), ("cuda_fused", False), ("cuda", False),
    ("goap", False), ("dense", False), ("stream", True), ("stream", False),
    ("fixed", False)])
def test_captured_step_equals_the_eager_step_on_every_bucket(cuda, backend,
                                                             gauges):
    """Every backend's served step is captured at warm-up (none is on the
    eager list) and its replay equals the same step run op by op, bit for
    bit, on every bucket and on a shape captured at first use."""
    from repro_torch.serve.capture import EAGER_BACKENDS
    from repro_torch.train.lsq import init_lsq_scales

    _, params, masks = _plan(SMALL, 30, cuda, backend="goap")
    scales = init_lsq_scales(params, 16) if backend == "fixed" else None
    iq = _iq(SMALL, 8, 31)
    with AsyncAMCServeEngine(params, SMALL, masks, backend=backend,
                             max_batch=8, activity_gauges=gauges,
                             lsq_scales=scales) as engine:
        graphs = engine.get_version("default").graphs
        assert backend not in EAGER_BACKENDS and graphs is not None
        assert {s[0] for s in graphs.shapes()} == set(engine.batcher.buckets)
        for b in list(engine.batcher.buckets) + [5]:
            got, want = graphs(iq[:b]), graphs.eager(iq[:b])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        logits, accs = engine.serve_step(iq)
        assert (accs is not None) == (gauges and backend != "fixed")
        np.testing.assert_array_equal(logits.argmax(-1), engine.classify(iq))


@pytest.mark.cuda
def test_replays_count_the_launches_their_capture_recorded(cuda):
    _, params, masks = _plan(SMALL, 32, cuda, backend="goap")
    iq = _iq(SMALL, 8, 33)
    for backend, kernels in (("cuda_fused", {"stream_fused_forward"}),
                             ("cuda", {"goap_conv_block_sparse",
                                       "wm_fc_matmul", "lif_update_fused"})):
        with AsyncAMCServeEngine(params, SMALL, masks, backend=backend,
                                 max_batch=8) as engine:
            graphs = engine.get_version("default").graphs
            per_replay = graphs.launches((8, 2, SMALL.input_width))
            assert set(per_replay) == kernels
            reset_launch_counts()
            for _ in range(5):
                graphs(iq)
            torch.cuda.synchronize()
            assert launch_counts() == {k: 5 * per_replay.get(k, 0)
                                       for k in launch_counts()}


@pytest.mark.cuda
def test_capture_while_other_engines_serve(cuda):
    """A hot-swap's bind, a second engine's warm-up and a fleet's scale-up
    capture while other workers replay on the same card; four workers
    share one version's graphs.  Nothing fails, every prediction is
    goap's."""
    from repro_torch.data.pipeline import sigma_delta_encode_np
    from repro_torch.fleet import FleetRouter, engine_factory

    p1, p2 = init_snn(40, SMALL), init_snn(41, SMALL)
    m1, m2 = make_mask_pytree(p1, 0.5), make_mask_pytree(p2, 0.5)
    iq = _iq(SMALL, 256, 42)

    def goap_preds(params, masks):
        plan = compile_plan(compile_snn(SMALL), params, masks=masks,
                            assignment="goap", device=cuda)
        return plan.bound.batch(torch.as_tensor(sigma_delta_encode_np(
            iq, SMALL.timesteps), device=cuda)).argmax(-1).cpu().numpy()

    want1 = goap_preds(p1, m1)
    with AsyncAMCServeEngine(p1, SMALL, m1, backend="cuda_fused", max_batch=8,
                             workers=4) as busy:
        futures = [busy.submit(f) for f in iq]
        busy.bind_version("v2", p2, m2)            # captures under load
        with AsyncAMCServeEngine(p2, SMALL, m2, backend="cuda",
                                 max_batch=8) as other:
            fleet = FleetRouter(engine_factory(p1, SMALL, masks=m1,
                                               backend="cuda_fused",
                                               max_batch=8, device=cuda),
                                replicas=1, max_replicas=2)
            try:
                assert fleet.scale_up() == "replica-1"
                np.testing.assert_array_equal(fleet.classify(iq), want1)
            finally:
                fleet.close()
            np.testing.assert_array_equal(other.classify(iq),
                                          goap_preds(p2, m2))
        got = np.array([f.result(timeout=120) for f in futures])
        np.testing.assert_array_equal(got, want1)
        busy.swap_to("v2")
        np.testing.assert_array_equal(busy.classify(iq), goap_preds(p2, m2))


# ---------------------------------------------------------------------------
# the trainer's captured step, mesh serving, the stage pipeline, compression
# ---------------------------------------------------------------------------

def _train_pair(cuda, steps):
    """A captured and an eager trainer from one state: per-layer masks
    recomputed every 2 steps over a ``steps``-step schedule, 16-bit LSQ."""
    from repro_torch.train import SNNTrainer, TrainerConfig

    density = {"conv1": 0.5, "conv2": 0.4, "conv3": 0.3, "fc1": 0.4, "fc2": 0.5}
    tcfg = TrainerConfig(total_steps=steps, batch_size=8, osr=2, use_lsq=True,
                         per_layer_density=density, prune_every=2)
    return (SNNTrainer(TRAIN_SMALL, tcfg, device=cuda),
            SNNTrainer(TRAIN_SMALL, tcfg, device=cuda, capture=False))


@pytest.mark.cuda
def test_captured_train_steps_bit_equal_to_eager_across_reprunes(cuda):
    from repro_torch.tree import tree_leaves

    cap, eager = _train_pair(cuda, 8)
    assert cap.capture and not eager.capture
    before = cap.params
    copy = [x.clone() for x in tree_leaves(before)]
    h_cap = cap.run(steps=8, log_every=1)
    h_eager = eager.run(steps=8, log_every=1)
    assert h_cap["loss"] == h_eager["loss"]
    for x, y in zip(tree_leaves(cap._state_tree()),
                    tree_leaves(eager._state_tree())):
        assert torch.equal(x, y)
    # reprunes at steps 0, 2, 4 and 6 copy new masks in: no recapture
    assert cap._steps.captures == 1 and len(cap._steps.keys()) == 1
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(before), copy))


@pytest.mark.cuda
def test_captured_evaluate_equals_eager(cuda):
    cap, eager = _train_pair(cuda, 4)
    cap.run(steps=4)
    eager.run(steps=4)
    frames, _ = cap._host_batch(10_000, 10.0)
    np.testing.assert_array_equal(cap._eval_logits(frames, True),
                                  eager._eval_logits(frames, True))
    assert cap.evaluate(n_batches=2, snr_db=10.0) == \
        eager.evaluate(n_batches=2, snr_db=10.0)
    assert cap._evals.captures == 1


@pytest.mark.cuda
def test_assigned_params_take_effect_without_recapture(cuda):
    from repro_torch.tree import tree_leaves, tree_map

    cap, eager = _train_pair(cuda, 4)
    cap.run(steps=1)
    eager.run(steps=1)
    new = tree_map(lambda x: x * 0.5, cap.params)
    cap.params, eager.params = new, tree_map(torch.clone, new)
    cap.run(steps=2, log_every=1)
    eager.run(steps=2, log_every=1)
    assert cap._steps.captures == 1
    for x, y in zip(tree_leaves(cap.params), tree_leaves(eager.params)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_mesh_engine_replay_equals_its_eager_step(cuda):
    from repro_torch.distributed.sharding import serve_mesh

    _, params, masks = _plan(SMALL, 50, cuda, backend="goap")
    iq = _iq(SMALL, 64, 51)
    mesh = serve_mesh()
    with AsyncAMCServeEngine(params, SMALL, masks, backend="cuda_fused",
                             max_batch=8, mesh=mesh) as engine:
        assert engine.activity is None
        assert all(b % mesh.size == 0 for b in engine.batcher.buckets)
        graphs = engine.get_version("default").graphs
        for b in engine.batcher.buckets:
            np.testing.assert_array_equal(graphs(iq[:b]), graphs.eager(iq[:b]))
        preds = engine.classify(iq)
    with AsyncAMCServeEngine(params, SMALL, masks, backend="cuda_fused",
                             max_batch=8, device=cuda) as single:
        np.testing.assert_array_equal(preds, single.classify(iq))


@pytest.mark.cuda
def test_snn_pipeline_on_the_card_equals_the_cpu(cuda):
    from repro_torch.configs.saocds_amc import CONFIG
    from repro_torch.examples.snn_pipeline import pipeline_logits, stage_devices

    params = init_snn(52, CONFIG)
    rng = np.random.default_rng(53)
    frames = (rng.random((8, CONFIG.timesteps, 2, CONFIG.input_width))
              < 0.5).astype(np.float32)
    got = pipeline_logits(CONFIG, params, frames, stage_devices(cuda))
    want = pipeline_logits(CONFIG, params, frames, [torch.device("cpu")] * 4)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
def test_compressed_psum_over_one_nccl_rank(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize_int8,
                                                     ef_compress)

    g = {"w": torch.randn(64, device=cuda), "b": [torch.randn(3, 5, device=cuda)]}
    ef = {"w": torch.zeros(64, device=cuda), "b": [torch.zeros(3, 5, device=cuda)]}
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        mean, new_ef = compressed_psum(g, ef)
    finally:
        dist.destroy_process_group()
    q, s, want_ef = ef_compress(g, ef)
    want = dequantize_int8(q, s)
    assert torch.equal(mean["w"], want["w"])
    assert torch.equal(mean["b"][0], want["b"][0])
    assert torch.equal(new_ef["w"], want_ef["w"])


ZOO_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "qwen1.5-0.5b",
             "yi-9b", "qwen3-14b", "llama3-8b", "mamba2-780m", "internvl2-1b",
             "recurrentgemma-9b", "whisper-large-v3")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_lm_trainer_captured_steps_equal_eager_ones(cuda, arch):
    """Three captured LMTrainer steps (one graph, replayed) equal three
    steps op by op on the same buffers, bit for bit."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.launch.train import LMTrainer
    from repro_torch.tree import tree_leaves

    cfg = reduced_config(arch)
    runs = {}
    for capture in (True, False):
        trainer = LMTrainer(cfg, batch=2, seq=16, device=cuda, capture=capture)
        hist = trainer.run(3, log_every=1)
        runs[capture] = (hist["loss"], trainer)
    assert runs[True][0] == runs[False][0]
    cap, eager = runs[True][1], runs[False][1]
    assert cap._step.static.captures == 1 and eager._step.static.captures == 0
    for x, y in zip(tree_leaves(cap.state), tree_leaves(eager.state)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [a for a in ZOO_ARCHS if a != "whisper-large-v3"])
def test_generate_captured_equals_eager(cuda, arch):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.launch.serve import Generator, generate
    from repro_torch.models.lm import init_lm

    cfg = reduced_config(arch)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device=cuda)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)).to(cuda)
    gen = Generator(cfg, params)
    got = gen(prompts, 6)
    again = gen(prompts, 6)           # the graphs replayed, not recaptured
    want = generate(cfg, params, prompts, 6, capture=False)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert gen._prefill[6].static.captures == gen._decode.static.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m", "qwen2-moe-a2.7b"])
def test_cells_captured_equal_eager(cuda, arch):
    """The reduced train, prefill and decode cells: the captured step
    equals the same step op by op, bit for bit."""
    from repro_torch.configs.registry import ShapeSpec, reduced_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import steps
    from repro_torch.models.lm import init_decode_state, init_lm
    from repro_torch.train.optimizer import adamw
    from repro_torch.tree import tree_leaves, tree_map

    cfg = reduced_config(arch)
    mesh = Mesh((1, 1), ("data", "model"))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))

    def both(plan, make_args, n):
        out = {}
        for capture in (True, False):
            step = plan.jitted(cuda, capture=capture)
            args = make_args()
            for _ in range(n):
                res = step(*args)
                args = tuple(res[i] if i in plan.donate_argnums else a
                             for i, a in enumerate(args))
            out[capture] = tree_leaves(res)
        assert all(torch.equal(x, y) for x, y in zip(out[True], out[False]))

    params = init_lm(torch.Generator().manual_seed(0), cfg, device=cuda)
    train = steps._train_cell(arch, ShapeSpec("t", 16, 2, "train"), cfg, mesh)
    both(train, lambda: ({"params": tree_map(torch.clone, params),
                          "opt": adamw(3e-4, weight_decay=0.1)[0](params)},
                         {"tokens": toks.to(cuda), "labels": toks.to(cuda)}), 3)
    bf16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    prefill = steps._prefill_cell(arch, ShapeSpec("p", 16, 2, "prefill"), cfg, mesh)
    both(prefill, lambda: (bf16, {"tokens": toks.to(cuda)}), 1)
    decode = steps._decode_cell(arch, ShapeSpec("d", 16, 2, "decode"), cfg, mesh)
    both(decode, lambda: (bf16, init_decode_state(cfg, 2, 16, device=cuda),
                          toks[:, :1].to(cuda)), 4)


# ---------------------------------------------------------------------------
# The bf16 forms (init_snn(dtype=torch.bfloat16)).
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,din,dout", [(8, 256, 64), (5, 100, 37), (512, 1024, 128),
                                        (3, 7, 11), (70, 130, 40)])
def test_wm_fc_bf16_kernel_equals_its_plain_version(cuda, b, din, dout):
    from repro_torch.kernels import wm_fc_matmul_bf16, wm_fc_matmul_bf16_ref

    rng = np.random.default_rng(b + din + dout)
    s = torch.as_tensor(rng.random((b, din)) < 0.5, device=cuda).to(torch.bfloat16)
    w = torch.as_tensor((rng.random((din, dout)) < 0.4) * rng.normal(size=(din, dout)),
                        device=cuda).to(torch.bfloat16)
    reset_launch_counts()
    got = wm_fc_matmul(s, w)
    assert launch_counts()["wm_fc_matmul_bf16"] == 1
    assert launch_counts()["wm_fc_matmul"] == 0
    assert torch.equal(got, wm_fc_matmul_bf16_ref(s, w))
    assert torch.equal(wm_fc_matmul_bf16(s.float(), w), got)


@pytest.mark.cuda
@pytest.mark.parametrize("bo,bk,oi", [(8, 16, 64), (8, 32, 200), (4, 16, 33),
                                      (16, 40, 129)])
def test_goap_conv_bf16_kernel_equals_its_plain_version(cuda, bo, bk, oi):
    from repro_torch.kernels import goap_conv_block_sparse_bf16_ref

    rng = np.random.default_rng(bo * bk + oi)
    blocks = torch.as_tensor(rng.normal(size=(3, 4, bo, bk)), device=cuda
                             ).to(torch.bfloat16)
    cols = torch.as_tensor(rng.integers(0, 5, (3, 4)), dtype=torch.int32,
                           device=cuda)
    x = torch.as_tensor(rng.random((5 * bk, oi)) < 0.5, device=cuda).to(torch.bfloat16)
    reset_launch_counts()
    got = goap_conv_block_sparse(blocks, cols, x, block_oc=bo, block_k=bk)
    assert launch_counts()["goap_conv_block_sparse_bf16"] == 1
    assert torch.equal(got, goap_conv_block_sparse_bf16_ref(blocks, cols, x))
    cols[1, 2] = 9                              # outside X': rows 8..15 NaN
    bad = goap_conv_block_sparse(blocks, cols, x, block_oc=bo, block_k=bk)
    assert bool(bad[bo:2 * bo].isnan().all()) and not bool(bad[:bo].isnan().any())


# (T, N, C, inner, with v0): the reference's (N,) form, the FC layout
# (inner 1), the conv layout (inner W), odd N, T past the 16 a thread loads
# at once
LIF_LAYOUTS = [(1, 16, 16, 1, True), (8, 200, 200, 1, True), (3, 1030, 1030, 1, True),
               (16, 7, 7, 1, True), (8, 704, 11, 1, False), (8, 8192, 128, 1, False),
               (8, 4 * 16 * 128, 16, 128, False), (17, 3 * 5 * 7, 5, 7, True),
               (17, 2 * 11, 11, 1, False), (5, 9 * 3 * 33, 3, 33, False),
               (8, 99, 1, 1, True), (0, 12, 4, 3, True)]


def _lif_args(rng, tt, n, c, with_v0, dtype, device):
    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
    return (put(rng.normal(size=(tt, n))), put(rng.normal(size=n)) if with_v0 else None,
            put(rng.uniform(0.5, 0.99, c)), put(rng.uniform(0.5, 1.5, c)),
            put(rng.uniform(0.3, 1.2, c)))


@pytest.mark.cuda
@pytest.mark.parametrize("tt,n,c,inner,with_v0", LIF_LAYOUTS)
def test_lif_bf16_kernel_equals_its_plain_version(cuda, tt, n, c, inner, with_v0):
    from repro_torch.kernels import lif_update_fused, lif_update_fused_ref
    from repro_torch.kernels import lif_update as lif
    from repro_torch.kernels.goap_conv import _n_sms

    rng = np.random.default_rng(tt * n + c)
    args = _lif_args(rng, tt, n, c, with_v0, torch.bfloat16, cuda)
    want = lif_update_fused_ref(*args, inner=inner)
    reset_launch_counts()
    got = lif_update_fused(*args, inner=inner)
    assert launch_counts()["lif_update_fused_bf16"] == (1 if n else 0)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    # every plan the planner can lay out
    plans = set()
    for k in lif.K_CHOICES:
        for threads in lif.THREAD_CHOICES:
            try:
                plans.add(lif.plan_lif_bf16_launch(tt, n, c, inner, _n_sms(cuda),
                                                   k=k, threads=threads))
            except ValueError:
                continue
    assert plans
    for plan in plans:
        for g, w in zip(lif._launch_bf16(*args, inner, plan), want):
            assert torch.equal(g.view(torch.int16), w.view(torch.int16)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("tt,n,c,inner,with_v0", LIF_LAYOUTS)
def test_lif_f32_kernel_takes_per_channel_parameters(cuda, tt, n, c, inner, with_v0):
    from repro_torch.kernels import lif_update_fused, lif_update_fused_ref

    rng = np.random.default_rng(tt * n + c + 1)
    args = _lif_args(rng, tt, n, c, with_v0, torch.float32, cuda)
    reset_launch_counts()
    got = lif_update_fused(*args, inner=inner)
    assert launch_counts()["lif_update_fused"] == (1 if n else 0)
    for g, w in zip(got, lif_update_fused_ref(*args, inner=inner)):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.cuda
def test_lif_kernels_refuse_a_layout_that_is_not_whole_channels(cuda):
    from repro_torch.kernels import lif_update_fused

    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        args = _lif_args(rng, 4, 30, 4, False, dtype, cuda)
        with pytest.raises(ValueError, match="channels"):
            lif_update_fused(*args)
        with pytest.raises(ValueError, match="channels"):
            lif_update_fused(*_lif_args(rng, 4, 30, 5, False, dtype, cuda), inner=4)


@pytest.mark.cuda
def test_bf16_model_serves_through_the_bf16_kernels(cuda):
    params = init_snn(40, SMALL, dtype=torch.bfloat16)
    masks = {g: [m.to(torch.bfloat16) for m in ms]
             for g, ms in make_mask_pytree(params, 0.5).items()}
    program = compile_snn(SMALL)
    frames = sigma_delta_encode_batch(
        torch.as_tensor(_iq(SMALL, 8, 41), device=cuda), SMALL.timesteps)
    card = compile_plan(program, params, masks=masks, assignment="cuda",
                        device=cuda)
    cpu = compile_plan(program, params, masks=masks, assignment="cuda",
                       device="cpu")
    reset_launch_counts()
    got = card.bound.batch(frames)
    counts = launch_counts()
    assert counts["wm_fc_matmul_bf16"] == 2 and counts["lif_update_fused_bf16"] == 2
    assert counts["goap_conv_block_sparse"] == 2 and counts["wm_fc_matmul"] == 0
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), cpu.bound.batch(frames.cpu()))
    iq = _iq(SMALL, 16, 42)
    with AsyncAMCServeEngine(params, SMALL, masks, backend="cuda",
                             max_batch=8) as engine:
        preds = engine.classify(iq)
        assert engine.get_version("default").graphs is not None
    want = cpu.bound.batch(sigma_delta_encode_batch(torch.as_tensor(iq),
                                                    SMALL.timesteps))
    np.testing.assert_array_equal(preds, want.argmax(-1).numpy())


# The redesigned bf16 forms at their edges: every launch plan, ragged
# shapes, IN not a multiple of 128, several rounds of tiles, BO 4-32 and
# BK 16-48, OI not a multiple of the strip or of 8, no tile slots, a bad
# k-tile index, and operands whose data pointer is off 16-byte alignment.

def _bf16(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device).to(torch.bfloat16)


def _bf16_bits_equal(got, want):
    """Bit-for-bit equality of bf16 tensors (NaN rows included)."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    n = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    assert n == 0, f"{n} of {got.numel()} elements differ"


def _at_odd_offset(t):
    """t's values in a contiguous tensor that starts one element into its
    allocation: the data pointer is 2 bytes off 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _column_slice(t):
    """t's values as a slice one column into a wider tensor (not contiguous)."""
    wide = torch.zeros((t.shape[0], t.shape[1] + 1), dtype=t.dtype, device=t.device)
    wide[:, 1:] = t
    return wide[:, 1:]


def _fc_bf16_operands(b, din, dout, seed, device):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.random((b, din)) < 0.5, device),
            _bf16((rng.random((din, dout)) < 0.4) * rng.normal(size=(din, dout)), device))


BF16_FC_EDGES = {
    "fc1": (LAYERED_ROWS, 1024, 128),
    "fc2": (LAYERED_ROWS, 128, 11),
    "ragged": (70, 130, 40),             # B, IN and OUT off every tile
    "out11_in1000": (33, 1000, 11),
    "out37": (17, 300, 37),
    "two_rounds": (5, 2100, 64),         # 17 reference tiles: 8 + 8 + 1
    "no_inputs": (4, 0, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("operands", ["contiguous", "odd_offset", "column_slice"])
@pytest.mark.parametrize("name", sorted(BF16_FC_EDGES))
def test_wm_fc_bf16_edges_equal_plain(cuda, name, operands):
    from repro_torch.kernels import wm_fc_matmul_bf16, wm_fc_matmul_bf16_ref

    s, w = _fc_bf16_operands(*BF16_FC_EDGES[name], 3, cuda)
    if operands == "odd_offset":
        s, w = _at_odd_offset(s), _at_odd_offset(w)
    elif operands == "column_slice":
        s, w = _column_slice(s), _column_slice(w)
    reset_launch_counts()
    got = wm_fc_matmul_bf16(s, w)
    assert launch_counts()["wm_fc_matmul_bf16"] == 1
    _bf16_bits_equal(got, wm_fc_matmul_bf16_ref(s, w))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 32])
@pytest.mark.parametrize("out_tile", [16, 32, 64])
@pytest.mark.parametrize("split", [1, 3, 8])
def test_wm_fc_bf16_every_plan_equals_plain(cuda, rows, out_tile, split):
    from repro_torch.kernels import wm_fc
    from repro_torch.kernels.wm_fc import MAX_SMEM, fc_bf16_smem, plan_wm_fc_bf16_launch

    for b, din, dout in (BF16_FC_EDGES["fc1"], BF16_FC_EDGES["fc2"], BF16_FC_EDGES["ragged"]):
        if fc_bf16_smem(rows, out_tile, split) > MAX_SMEM:    # 32 x 64 x 8 warps
            with pytest.raises(ValueError, match="shared memory"):
                plan_wm_fc_bf16_launch(b, din, dout, rows=rows, out_tile=out_tile,
                                       split=split)
            continue
        s, w = _fc_bf16_operands(b, din, dout, 4, cuda)
        plan = plan_wm_fc_bf16_launch(b, din, dout, rows=rows, out_tile=out_tile,
                                      split=split)
        _bf16_bits_equal(wm_fc._launch_bf16(s, w, plan),
                         wm_fc.wm_fc_matmul_bf16_ref(s, w))


@pytest.mark.cuda
def test_wm_fc_bf16_random_normal_operands_within_one_ulp(cuda):
    from repro_torch.kernels import wm_fc_matmul_bf16, wm_fc_matmul_bf16_ref

    # spikes against unmasked normal weights (chip_smoke's random gate)
    rng = np.random.default_rng(5)
    for b, din, dout in BF16_FC_EDGES.values():
        s = _bf16(rng.random((b, din)) < 0.5, cuda)
        w = _bf16(rng.normal(size=(din, dout)), cuda)
        got, want = wm_fc_matmul_bf16(s, w).float(), wm_fc_matmul_bf16_ref(s, w).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        assert float(((got - want).abs() / ulp).max()) <= 1.0


def _conv_bf16_operands(r, mt, bo, bk, n_k, oi, seed, device):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.normal(size=(r, mt, bo, bk)), device),
            torch.as_tensor(rng.integers(0, n_k, (r, mt)), dtype=torch.int32, device=device),
            _bf16(rng.random((n_k * bk, oi)) < 0.5, device))


def _goap_bf16(blocks, cols, x):
    from repro_torch.kernels import goap_conv_block_sparse_bf16

    return goap_conv_block_sparse_bf16(blocks, cols, x, block_oc=blocks.shape[2],
                                       block_k=blocks.shape[3])


def _conv_bf16_plans(blocks, x):
    """Every launch plan the planner lays out for these operands: each
    strip that fits."""
    from repro_torch.kernels.goap_conv import BF16_STRIPS, plan_goap_conv_bf16_launch

    plans = []
    for strip in BF16_STRIPS:
        try:
            plans.append(plan_goap_conv_bf16_launch(*blocks.shape, *x.shape, strip=strip))
        except ValueError:               # past 227 KB
            continue
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("kw,ic,oc,w", PAPER_CONVS, ids=["conv1", "conv2", "conv3"])
def test_goap_conv_bf16_every_plan_at_paper_shapes(cuda, kw, ic, oc, w):
    from repro_torch.kernels import goap_conv

    blocks, cols, x = _conv_operands(kw, ic, oc, LAYERED_ROWS * w, 0, cuda)
    blocks, x = blocks.to(torch.bfloat16), x.to(torch.bfloat16)
    want = goap_conv.goap_conv_block_sparse_bf16_ref(blocks, cols, x)
    reset_launch_counts()
    _bf16_bits_equal(_goap_bf16(blocks, cols, x), want)
    assert launch_counts()["goap_conv_block_sparse_bf16"] == 1
    plans = _conv_bf16_plans(blocks, x)
    assert len(plans) >= 2
    for plan in plans:
        _bf16_bits_equal(goap_conv._launch_bf16(blocks, cols, x, plan), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bo", [4, 8, 16, 24, 32])
@pytest.mark.parametrize("bk", [16, 32, 48])
def test_goap_conv_bf16_tiles_equal_plain(cuda, bo, bk):
    from repro_torch.kernels import goap_conv

    # OI 1000: not a multiple of any strip; then every plan the tiles take
    blocks, cols, x = _conv_bf16_operands(3, 4, bo, bk, 5, 1000, bo + bk, cuda)
    want = goap_conv.goap_conv_block_sparse_bf16_ref(blocks, cols, x)
    _bf16_bits_equal(_goap_bf16(blocks, cols, x), want)
    for plan in _conv_bf16_plans(blocks, x):
        _bf16_bits_equal(goap_conv._launch_bf16(blocks, cols, x, plan), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["oi129", "oi33", "oi1", "no_slots", "bad_index",
                                  "negative_index", "odd_offset", "column_slice"])
def test_goap_conv_bf16_edges_equal_plain(cuda, case):
    from repro_torch.kernels import goap_conv_block_sparse_bf16_ref

    oi = {"oi129": 129, "oi33": 33, "oi1": 1}.get(case, 520)
    blocks, cols, x = _conv_bf16_operands(3, 0 if case == "no_slots" else 4, 8, 32, 5,
                                          oi, 11, cuda)
    if case in ("bad_index", "negative_index"):
        cols[1, 2] = 5 if case == "bad_index" else -1
    elif case == "odd_offset":
        blocks, cols, x = _at_odd_offset(blocks), _at_odd_offset(cols), _at_odd_offset(x)
    elif case == "column_slice":
        x = _column_slice(x)
    got = _goap_bf16(blocks, cols, x)
    want = goap_conv_block_sparse_bf16_ref(blocks, cols, x)
    _bf16_bits_equal(got, want)
    if case == "no_slots":
        assert not bool(got.any())
    if case in ("bad_index", "negative_index"):
        assert bool(got[8:16].isnan().all()) and not bool(got[:8].isnan().any())
