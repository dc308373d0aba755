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
