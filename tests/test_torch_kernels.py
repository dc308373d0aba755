"""Port kernel modules held to the reference's Pallas kernels (CPU).

On the CPU each wrapper runs its plain PyTorch version; the reference
runs its Pallas kernels in interpret mode, as its own tests do.  Currents
and logits within 1e-5, spikes and counters exactly equal.  The CUDA
kernels themselves are held to their plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import PAPER, PAPER_REF, SMALL, SMALL_REF, setup, spike_frames, t
from repro.api import compile_plan as ref_compile_plan, compile_snn as ref_compile_snn
from repro.core.encoder import sigma_delta_encode as ref_sd_encode
from repro.core.lif import init_lif_params as ref_init_lif
from repro.core.sparse_format import block_sparse_from_dense as ref_bs
from repro.kernels import ops as ref_ops
from repro.kernels.goap_conv import goap_conv_block_sparse as ref_goap_raw
from repro.kernels.lif_update import lif_update_fused as ref_lif_raw
from repro.kernels.stream_fused import (
    fused_stack_of as ref_fused_stack_of,
    stream_fused_forward as ref_fused,
)
from repro.kernels.wm_fc import wm_fc_matmul as ref_wm_fc
from repro_torch.api import compile_plan, compile_snn
from repro_torch.core.encoder import sigma_delta_encode
from repro_torch.core.lif import init_lif_params
from repro_torch.core.sparse_format import block_sparse_from_dense
from repro_torch.kernels import (
    goap_conv_block_sparse,
    goap_conv_block_sparse_inorder,
    goap_conv_op,
    lif_op,
    lif_update_fused,
    stream_fused_forward,
    wm_fc_matmul,
    wm_fc_matmul_inorder,
    wm_fc_op,
)
from repro_torch.kernels.goap_conv import MAX_SMEM, ConvLaunch, plan_goap_conv_launch
from repro_torch.kernels.stream_fused import (
    CLUSTERS,
    FusedConv,
    FusedFC,
    FusedPool,
    conv_weight_lists,
    counter_map,
    plan_stream_fused_launch,
    split_outputs,
)
from repro_torch.serve.batcher import make_buckets
from repro_torch.kernels.wm_fc import CHUNK, FCLaunch, plan_wm_fc_launch

RNG = np.random.default_rng(0)

# (kw, ic, oc, wi, density, block_oc, block_k, block_oi) of tests/test_kernels.py
GOAP_SWEEP = [
    (11, 2, 16, 138, 1.0, 8, 32, 32),
    (11, 16, 32, 74, 0.3, 8, 64, 64),
    (5, 32, 64, 36, 0.10, 8, 32, 32),
    (5, 32, 64, 36, 0.02, 4, 16, 16),
    (3, 1, 1, 10, 1.0, 8, 128, 128),
    (7, 24, 48, 150, 0.5, 16, 128, 128),
]


@pytest.mark.parametrize("kw,ic,oc,wi,density,bo,bk,boi", GOAP_SWEEP)
def test_goap_conv_op_matches_reference(kw, ic, oc, wi, density, bo, bk, boi):
    k = ((RNG.random((kw, ic, oc)) < density)
         * RNG.normal(size=(kw, ic, oc))).astype(np.float32)
    ifm = (RNG.random((ic, wi)) < 0.5).astype(np.float32)
    want = np.asarray(ref_ops.goap_conv_op(jnp.asarray(ifm), ref_bs(k, bo, bk),
                                           block_oi=boi))
    bs = block_sparse_from_dense(k, block_oc=bo, block_k=bk)
    np.testing.assert_allclose(goap_conv_op(t(ifm), bs).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    # leading batch dims fold into the OI axis of one product
    both = goap_conv_op(t(np.stack([ifm, 1 - ifm])), bs)
    want1 = np.asarray(ref_ops.goap_conv_op(jnp.asarray(1 - ifm),
                                            ref_bs(k, bo, bk), block_oi=boi))
    np.testing.assert_allclose(both[1].numpy(), want1, atol=1e-5, rtol=1e-5)


def test_goap_padding_tiles_are_noop():
    k = np.zeros((3, 4, 8), dtype=np.float32)
    k[0, 0, 0] = 2.0   # single nnz: every other tile is padding
    ifm = np.ones((4, 18), dtype=np.float32)
    want = np.asarray(ref_ops.goap_conv_op(jnp.asarray(ifm), ref_bs(k, 4, 8),
                                           block_oi=16))
    got = goap_conv_op(t(ifm), block_sparse_from_dense(k, block_oc=4, block_k=8))
    np.testing.assert_array_equal(got.numpy(), want)


def test_goap_raw_kernel_contract_matches_reference():
    r, mt, bo, bk, nk, oi = 3, 4, 8, 16, 5, 64
    blocks = RNG.normal(size=(r, mt, bo, bk)).astype(np.float32)
    cols = RNG.integers(0, nk, (r, mt)).astype(np.int32)
    x = (RNG.random((nk * bk, oi)) < 0.5).astype(np.float32)
    want = np.asarray(ref_goap_raw(jnp.asarray(blocks), jnp.asarray(cols),
                                   jnp.asarray(x), block_oc=bo, block_k=bk,
                                   block_oi=oi))
    got = goap_conv_block_sparse(t(blocks), torch.from_numpy(cols), t(x),
                                 block_oc=bo, block_k=bk)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,din,dout", [(1, 1024, 128), (8, 1024, 128),
                                        (5, 100, 37), (16, 128, 11)])
def test_wm_fc_matches_reference(b, din, dout):
    s = (RNG.random((b, din)) < 0.5).astype(np.float32)
    w = ((RNG.random((din, dout)) < 0.4)
         * RNG.normal(size=(din, dout))).astype(np.float32)
    want = np.asarray(ref_wm_fc(jnp.asarray(s), jnp.asarray(w)))
    np.testing.assert_allclose(wm_fc_matmul(t(s), t(w)).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wm_fc_op(t(s[0]), t(w)).numpy(), want[0],
                               atol=1e-5, rtol=1e-5)


def test_goap_inorder_matches_reference_on_unordered_repeated_cols():
    r, mt, bo, bk, nk, oi = 3, 4, 8, 16, 5, 64
    blocks = RNG.normal(size=(r, mt, bo, bk)).astype(np.float32)
    cols = RNG.integers(0, nk, (r, mt)).astype(np.int32)
    x = RNG.normal(size=(nk * bk, oi)).astype(np.float32) * (RNG.random((nk * bk, oi)) < 0.5)
    want = np.asarray(ref_goap_raw(jnp.asarray(blocks), jnp.asarray(cols),
                                   jnp.asarray(x), block_oc=bo, block_k=bk,
                                   block_oi=oi))
    got = goap_conv_block_sparse_inorder(t(blocks), torch.from_numpy(cols), t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", [5, -1])
def test_goap_inorder_poisons_the_rows_of_an_out_of_range_tile(bad):
    blocks = t(RNG.normal(size=(3, 2, 4, 8)))
    cols = torch.tensor([[0, 1], [2, bad], [4, 3]], dtype=torch.int32)
    x = t((RNG.random((40, 20)) < 0.5))
    got = goap_conv_block_sparse_inorder(blocks, cols, x)
    assert torch.isnan(got[4:8]).all()
    assert torch.isfinite(got[:4]).all() and torch.isfinite(got[8:]).all()
    ok = torch.tensor([[0, 1], [2, 0], [4, 3]], dtype=torch.int32)
    want = goap_conv_block_sparse_inorder(blocks, ok, x)
    assert torch.equal(got[:4], want[:4]) and torch.equal(got[8:], want[8:])


@pytest.mark.parametrize("b,din,dout", [(8, 1024, 128), (5, 100, 37), (16, 128, 11)])
def test_wm_fc_inorder_matches_reference(b, din, dout):
    s = (RNG.random((b, din)) < 0.5).astype(np.float32)
    w = ((RNG.random((din, dout)) < 0.4)
         * RNG.normal(size=(din, dout))).astype(np.float32)
    want = np.asarray(ref_wm_fc(jnp.asarray(s), jnp.asarray(w)))
    np.testing.assert_allclose(wm_fc_matmul_inorder(t(s), t(w)).numpy(), want,
                               atol=1e-5, rtol=1e-5)


# Launch planning (pure Python: what the wrappers hand the card).  The
# paper model's layer-by-layer shapes at batch 64, T = 8, and SMALL's at
# batch 8: (n_oc_tiles, max_tiles, block_oc, block_k, K_pad, OI).
PAPER_CONV_SHAPES = {
    "conv1": ((2, 1, 8, 32, 32, 65536), ConvLaunch(256, 4, 256, 256, 67592)),
    "conv2": ((4, 6, 8, 32, 192, 32768), ConvLaunch(128, 4, 132, 256, 221280)),
    "conv3": ((8, 5, 8, 32, 160, 16384), ConvLaunch(128, 8, 128, 256, 204960)),
    "small_conv1": ((1, 1, 8, 32, 32, 1024), ConvLaunch(256, 4, 4, 128, 66564)),
    "small_conv2": ((1, 1, 8, 32, 32, 512), ConvLaunch(256, 4, 2, 128, 66564)),
}


@pytest.mark.parametrize("name", sorted(PAPER_CONV_SHAPES))
def test_goap_conv_plan_for_model_shapes(name):
    shape, want = PAPER_CONV_SHAPES[name]
    plan = plan_goap_conv_launch(*shape)
    assert plan == want
    r, mt, bo, bk, k_pad, oi = shape
    # two strips of X' (one walked, one in flight) and every tile
    assert plan.smem_bytes == 4 * (2 * k_pad * plan.strip + r * mt * (bo * bk + 1))
    assert plan.smem_bytes <= MAX_SMEM
    n_strips = -(-oi // plan.strip)
    assert plan.blocks <= n_strips
    items = r * (bo // plan.rows_per_thread) * plan.strip // 4
    assert plan.threads == min(256, max(32, items))


def test_goap_conv_plan_for_the_small_config_follows_the_plan_built_by_the_path():
    from _torch_parity import SMALL
    from repro_torch.models.graph import BLOCK_K, BLOCK_OC

    w, batch = SMALL.input_width, 8
    for kw, ic, oc in SMALL.conv_specs:
        k = np.ones((kw, ic, oc), np.float32)
        bs = block_sparse_from_dense(k, block_oc=BLOCK_OC, block_k=BLOCK_K)
        oi = batch * SMALL.timesteps * w
        plan = plan_goap_conv_launch(*bs.blocks.shape, bs.padded_k, oi)
        assert plan.strip == 256 and plan.rows_per_thread == 4
        assert plan.threads == 128 and plan.blocks == oi // 256
        w //= SMALL.pool


@pytest.mark.parametrize("k_pad,strip", [(64, 256), (192, 128), (384, 64), (512, 32)])
def test_goap_conv_plan_narrows_the_strip_as_k_grows(k_pad, strip):
    plan = plan_goap_conv_launch(2, 2, 8, 32, k_pad, 1 << 20)
    assert plan.strip == strip
    assert plan.smem_bytes <= MAX_SMEM


def test_goap_conv_plan_covers_narrow_oi_and_picks_rows_per_thread():
    assert plan_goap_conv_launch(1, 1, 8, 32, 32, 10).strip == 16
    assert plan_goap_conv_launch(1, 1, 8, 32, 32, 1).strip == 4
    assert plan_goap_conv_launch(1, 1, 8, 32, 32, 100).strip == 128
    for bo, rb in ((16, 8), (8, 4), (4, 4), (6, 2), (3, 1)):
        assert plan_goap_conv_launch(2, 1, bo, 32, 32, 256).rows_per_thread == rb


def test_goap_conv_plan_raises_past_227_kb():
    # 928 rows of X', twice at the narrowest strip: 237,568 bytes
    with pytest.raises(ValueError, match="shared memory"):
        plan_goap_conv_launch(1, 1, 8, 32, 928, 100)
    with pytest.raises(ValueError, match="shared memory"):
        plan_goap_conv_launch(4, 7, 8, 32, 1792, 100)
    with pytest.raises(ValueError, match="shared memory"):
        plan_goap_conv_launch(2, 2, 8, 32, 192, 4096, strip=512)
    with pytest.raises(ValueError, match="multiple of 4"):
        plan_goap_conv_launch(2, 2, 8, 32, 192, 4096, strip=30)
    with pytest.raises(ValueError, match="rows_per_thread"):
        plan_goap_conv_launch(2, 2, 8, 32, 192, 4096, rows_per_thread=3)
    # just under the limit still plans: 230,404 bytes
    assert plan_goap_conv_launch(1, 1, 8, 32, 896, 100).smem_bytes == 230_404


@pytest.mark.parametrize("shape,want", [
    ((512, 1024, 128), FCLaunch(16, 32, 128, 49664, (32, 4))),   # paper FC1
    ((512, 128, 11), FCLaunch(16, 16, 64, 33280, (32, 1))),      # paper FC2
    ((32, 64, 16), FCLaunch(16, 16, 64, 33280, (2, 1))),         # SMALL FC1
    ((32, 16, 5), FCLaunch(16, 8, 32, 25088, (2, 1))),           # SMALL FC2
    ((1, 1, 1), FCLaunch(32, 4, 32, 37888, (1, 1))),
    ((70_000, 1024, 128), FCLaunch(16, 32, 128, 49664, (4375, 4))),
], ids=["paper_fc1", "paper_fc2", "small_fc1", "small_fc2", "tiny", "big_batch"])
def test_wm_fc_plan(shape, want):
    plan = plan_wm_fc_launch(*shape)
    assert plan == want
    b, din, dout = shape
    assert plan.threads == plan.rows * plan.out_tile // 4
    # two chunks of W and of the spikes (rows padded by 4 floats)
    assert plan.smem_bytes == 8 * CHUNK * (plan.out_tile + plan.rows) + 32 * plan.rows
    assert plan.grid[0] * plan.rows >= b and plan.grid[1] * plan.out_tile >= dout


def test_wm_fc_plan_raises_where_the_card_would_refuse():
    with pytest.raises(ValueError, match="shared memory"):
        plan_wm_fc_launch(512, 1024, 1, rows=256)       # 274,432 bytes
    with pytest.raises(ValueError, match="warps"):
        plan_wm_fc_launch(512, 1024, 128, rows=2)
    with pytest.raises(ValueError, match="out_tile"):
        plan_wm_fc_launch(512, 1024, 128, out_tile=24)
    with pytest.raises(ValueError, match="grid"):
        plan_wm_fc_launch(4, 32, 32 * 65_536, rows=16)


@pytest.mark.parametrize("tt,n", [(1, 16), (4, 128), (8, 200), (3, 1030), (16, 7)])
def test_lif_update_matches_reference(tt, n):
    cur = RNG.normal(size=(tt, n)).astype(np.float32)
    v0 = RNG.normal(size=(n,)).astype(np.float32)
    alpha = RNG.uniform(0.5, 0.99, n).astype(np.float32)
    theta = RNG.uniform(0.5, 1.5, n).astype(np.float32)
    v_th = RNG.uniform(0.3, 1.2, n).astype(np.float32)
    sp_r, vf_r = ref_lif_raw(*(jnp.asarray(a) for a in (cur, v0, alpha, theta, v_th)))
    sp, vf = lif_update_fused(*(t(a) for a in (cur, v0, alpha, theta, v_th)))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_r))
    np.testing.assert_allclose(vf.numpy(), np.asarray(vf_r), atol=1e-5, rtol=1e-5)


def test_lif_op_multidim_with_channel_params():
    tt, oc, oi = 5, 6, 33
    cur = RNG.normal(size=(tt, oc, oi)).astype(np.float32)
    sp_r, vf_r = ref_ops.lif_op(jnp.asarray(cur),
                                ref_init_lif((oc, 1), alpha=0.8, theta=0.7, v_th=0.4))
    sp, vf = lif_op(t(cur), init_lif_params((oc, 1), alpha=0.8, theta=0.7, v_th=0.4))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_r))
    np.testing.assert_allclose(vf.numpy(), np.asarray(vf_r), atol=1e-5, rtol=1e-5)


def test_wrappers_take_float32_only():
    with pytest.raises(TypeError, match="float32"):
        wm_fc_matmul(torch.ones(2, 4, dtype=torch.bfloat16),
                     torch.ones(4, 3, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        lif_update_fused(*(torch.ones(n, dtype=torch.float64)
                           for n in ((2, 3), 3, 3, 3, 3)))


# ---------------------------------------------------------------------------
# stream_fused_forward
# ---------------------------------------------------------------------------

def _stacks(seed, density=0.5):
    params, masks, tparams, tmasks = setup(SMALL_REF, seed, density)
    ref_plan = ref_compile_plan(ref_compile_snn(SMALL_REF), params, masks=masks,
                                assignment="pallas_fused")
    plan = compile_plan(compile_snn(SMALL), tparams, masks=tmasks,
                        assignment="cuda_fused", device="cpu")
    return ref_fused_stack_of(ref_plan), plan.fused_stack()


def test_fused_operands_equal_reference():
    ref_stack, stack = _stacks(0)
    assert len(stack.layers) == len(ref_stack.layers)
    for got, want in zip(stack.layers, ref_stack.layers):
        assert type(got).__name__ == type(want).__name__
        for f in ("w_cm", "counts", "lif", "w"):
            if hasattr(want, f):
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        if hasattr(want, "static_counts"):
            assert got.static_counts == want.static_counts


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("encode", [False, True])
def test_stream_fused_matches_reference(seed, encode):
    ref_stack, stack = _stacks(seed)
    if encode:
        x = np.random.default_rng(seed).random(
            (3, SMALL.conv_specs[0][1], SMALL.input_width)).astype(np.float32)
    else:
        x = spike_frames(seed, (3, SMALL.timesteps, SMALL.conv_specs[0][1],
                                SMALL.input_width))
    want_l, want_a = ref_fused(ref_stack, jnp.asarray(x), encode=encode)
    got_l, got_a = stream_fused_forward(stack, t(x), encode=encode)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_stream_fused_batched_equals_per_sample_and_encode_equals_encode_first():
    _, stack = _stacks(1)
    frames = t(spike_frames(7, (3, SMALL.timesteps, 2, SMALL.input_width)))
    logits_b, accs_b = stream_fused_forward(stack, frames)
    for i in range(frames.shape[0]):
        logits_1, accs_1 = stream_fused_forward(stack, frames[i:i + 1])
        np.testing.assert_array_equal(logits_b[i].numpy(), logits_1[0].numpy())
        np.testing.assert_array_equal(accs_b[i].numpy(), accs_1[0].numpy())
    x = t(np.random.default_rng(11).random((2, 2, SMALL.input_width)))
    encoded = sigma_delta_encode(x, SMALL.timesteps).movedim(0, 1)
    want = stream_fused_forward(stack, encoded)
    got = stream_fused_forward(stack, x, encode=True)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(
        encoded.numpy(),
        np.moveaxis(np.asarray(ref_sd_encode(jnp.asarray(x.numpy()),
                                             SMALL.timesteps)), 0, 1))


def test_stream_fused_rejects_mismatched_frames():
    _, stack = _stacks(0)
    with pytest.raises(ValueError, match="stack expects"):
        stream_fused_forward(stack, torch.zeros(1, SMALL.timesteps + 1, 2, 32))
    with pytest.raises(TypeError, match="float32"):
        stream_fused_forward(stack, torch.zeros(1, SMALL.timesteps, 2, 32,
                                                dtype=torch.float64))


# ---------------------------------------------------------------------------
# stream_fused_forward: launch planning and operand packing of the kernel
# ---------------------------------------------------------------------------

BUCKETS = make_buckets(64)      # the serving bucket ladder, 1 .. 64


def _port_stack(cfg, seed=0):
    _, _, tparams, tmasks = setup({"small": SMALL_REF, "paper": PAPER_REF}[cfg],
                                  seed, 0.5)
    port_cfg = {"small": SMALL, "paper": PAPER}[cfg]
    return compile_plan(compile_snn(port_cfg), tparams, masks=tmasks,
                        assignment="cuda_fused", device="cpu").fused_stack()


@pytest.mark.parametrize("cfg", ["small", "paper"])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_fused_plan_gives_every_output_to_one_cta(cfg, cluster):
    stack = _port_stack(cfg)
    weighted = [l for l in stack.layers if isinstance(l, (FusedConv, FusedFC))]
    for b in BUCKETS:
        plan = plan_stream_fused_launch(stack, b, cluster=cluster)
        assert plan.cluster == cluster and plan.smem_bytes <= 232_448
        assert len(plan.owned) == len(weighted)
        for layer, owned in zip(weighted, plan.owned):
            n = layer.oc if isinstance(layer, FusedConv) else layer.w.shape[1]
            assert len(owned) == cluster
            got = [o for start, stop in owned for o in range(start, stop)]
            assert got == list(range(n))       # each output once, in CTA order
        assert plan.waves == -(-b // (plan.ctas_per_sm * 132 // cluster))
        assert plan.threads * plan.ctas_per_sm <= 2048
        # regions are 16-byte aligned, disjoint and inside the CTA's memory
        spans = sorted((off, off + words) for _, off, words in plan.layout)
        assert all(off % 4 == 0 for off, _ in spans)
        assert all(a[1] <= b_[0] for a, b_ in zip(spans, spans[1:]))
        assert 4 * spans[-1][1] == plan.smem_bytes


def test_fused_plan_on_the_paper_model_keeps_fc1_resident_and_raises_past_the_limit():
    stack = _port_stack("paper")
    # batch 64 in one wave of 2-CTA clusters, FC1 streamed; a lone request
    # gets the largest cluster that keeps FC1 resident
    plan = plan_stream_fused_launch(stack, 64)
    assert (plan.cluster, plan.waves, plan.fc_resident) == (2, 1, (False, True))
    # FC1: a staging area of 256 rows for each timestep's active rows past
    # the resident ones, and as many resident rows as fit beside it (a
    # multiple of 32); FC2 all resident
    rows = plan.fc_rows[0]
    assert plan.fc_staged == (256, 0)
    assert 0 < rows < 1024 - 256 and rows % 32 == 0 and plan.fc_rows[1] == 128
    assert plan.smem_bytes <= 232_448 < plan.smem_bytes + 32 * 4 * 64
    # forced residency: all rows or none, nothing staged
    assert plan_stream_fused_launch(stack, 64, cluster=2,
                                    fc_resident=(False, True)).fc_staged == (0, 0)
    plan = plan_stream_fused_launch(stack, 1)
    assert all(plan.fc_resident) and plan.cluster == 8
    # the card's own occupancy decides the waves
    one = plan_stream_fused_launch(stack, 64, active_clusters=lambda c, t, m: 64)
    assert one.waves == 1 and one.cluster == 8
    assert plan_stream_fused_launch(stack, 64, cluster=1).fc_resident == (False, True)
    assert plan_stream_fused_launch(stack, 64, cluster=4).fc_resident == (True, True)
    with pytest.raises(ValueError, match="232448|shared memory"):
        plan_stream_fused_launch(stack, 64, cluster=1, fc_resident=(True, True))
    with pytest.raises(ValueError, match="cluster"):
        plan_stream_fused_launch(stack, 64, cluster=3)
    with pytest.raises(ValueError, match="fc_resident"):
        plan_stream_fused_launch(stack, 64, fc_resident=(True,))
    # FC2's 11 outputs over 8 CTAs: two each, the last CTAs fewer or none
    fc2 = plan_stream_fused_launch(stack, 64, cluster=8).owned[-1]
    assert [stop - start for start, stop in fc2] == [2, 2, 2, 2, 2, 1, 0, 0]


@pytest.mark.parametrize("cfg", ["small", "paper"])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_conv_weight_lists_are_the_nonzeros_in_ascending_row(cfg, cluster):
    stack = _port_stack(cfg)
    width = stack.in_width
    for layer in stack.layers:
        if isinstance(layer, FusedPool):
            width //= layer.pool
        if not isinstance(layer, FusedConv):
            continue
        entries, rowptr = conv_weight_lists(layer, width, cluster)
        wp = width + layer.kw - 1
        for q, (start, stop) in enumerate(split_outputs(layer.oc, cluster)):
            assert rowptr[q, 0] == 0 and (np.diff(rowptr[q]) % 4 == 0).all()
            for cl, ch in enumerate(range(start, stop)):
                e = entries[q, rowptr[q, cl]:rowptr[q, cl + 1]]
                w, off = e[:, 0], e[:, 1].view(np.int32)
                nz = np.flatnonzero(layer.w_cm[ch])
                n = len(nz)
                np.testing.assert_array_equal(w[:n], layer.w_cm[ch, nz])
                np.testing.assert_array_equal(off[:n], (nz % layer.ic) * wp + nz // layer.ic)
                assert (w[n:] == 0).all() and (off[n:] == 0).all() and len(w) - n < 4
            assert (rowptr[q, stop - start:] == rowptr[q, stop - start]).all()


@pytest.mark.parametrize("cfg", ["small", "paper"])
def test_counter_map_equals_the_row_sum_counter(cfg):
    stack = _port_stack(cfg)
    rng = np.random.default_rng(5)
    width = stack.in_width
    for layer in stack.layers:
        if isinstance(layer, FusedPool):
            width //= layer.pool
        if not isinstance(layer, FusedConv):
            continue
        x = (rng.random((layer.ic, width)) < 0.4).astype(np.int64)
        left = (layer.kw - 1) // 2
        xp = np.pad(x, ((0, 0), (left, layer.kw - 1 - left)))
        rows = np.stack([xp[:, ci:ci + width].sum(-1) for ci in range(layer.kw)])
        want = int((rows.reshape(-1) * layer.counts[0].astype(np.int64)).sum())
        assert int((x * counter_map(layer, width)).sum()) == want


def test_fused_stages_reject_what_the_kernel_does_not_run():
    stack = _port_stack("small")
    conv, pool, conv2, pool2, fc1, fc2, readout = stack.layers
    for layers, match in (((conv, pool, conv2, pool2, fc1, fc2), "no readout"),
                          ((conv, pool, conv2, pool2, fc1, readout, fc2), "last"),
                          ((pool, conv, conv2, pool2, fc1, fc2, readout), "follow a conv"),
                          ((conv, pool, conv2, pool2, readout), "follow an FC")):
        bad = dataclasses.replace(stack, layers=layers, _packed={})
        with pytest.raises(ValueError, match=match):
            plan_stream_fused_launch(bad, 1)


def test_stream_fused_plain_counts_non_binary_rows_in_ascending_position():
    """Non-binary frames: each X' row is summed in ascending position in f32
    and truncated, the kernel's order (binary frames sum exactly in any)."""
    stack = _port_stack("small")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, SMALL.timesteps, 2, SMALL.input_width)).astype(np.float32)
    _, accs = stream_fused_forward(stack, t(x))
    layer = stack.layers[0]
    left = (layer.kw - 1) // 2
    want = np.zeros(2, np.int64)
    for b in range(2):
        for step in range(SMALL.timesteps):
            xp = np.pad(x[b, step], ((0, 0), (left, layer.kw - 1 - left)))
            for r in range(layer.kw * layer.ic):
                ci, ic = divmod(r, layer.ic)
                s = np.float32(0)
                for p in range(SMALL.input_width):
                    s = np.float32(s + xp[ic, ci + p])
                want[b] += int(layer.counts[0, r]) * int(np.trunc(s))
    np.testing.assert_array_equal(accs[:, 0].numpy(), want.astype(np.float32))
