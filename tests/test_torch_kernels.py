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
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
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
from repro_torch.kernels.lif_update import plan_lif_bf16_launch
from repro_torch.kernels.goap_conv import (BF16_STRIPS, MAX_SMEM, ConvBf16Launch,
                                           ConvLaunch, conv_bf16_groups, conv_bf16_smem,
                                           plan_goap_conv_bf16_launch,
                                           plan_goap_conv_launch)
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
from repro_torch.kernels.wm_fc import (CHUNK, FCBf16Launch, FCLaunch, fc_bf16_smem,
                                       plan_wm_fc_bf16_launch, plan_wm_fc_launch)

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


# The bf16 forms' launch planners.  The paper model's shapes are those of
# the sweep (repro_torch.kernels.sweep: CONVS, FCS, ROWS = 512) and of the
# served bf16 path at batch 64.
BF16_CONV_PLANS = {
    "conv1": ((2, 1, 8, 32, 32, 65536), ConvBf16Launch(256, 256, 256, 42504)),
    "conv2": ((4, 6, 8, 32, 192, 32768), ConvBf16Launch(256, 128, 512, 228960)),
    "conv3": ((8, 5, 8, 32, 160, 16384), ConvBf16Launch(128, 128, 512, 125088)),
}


def _check_conv_bf16_plan(plan, shape):
    r, mt, bo, bk, k_pad, oi = shape
    item = 16 * conv_bf16_groups(bo)
    assert plan.strip in BF16_STRIPS and plan.strip % item == 0
    assert plan.smem_bytes == conv_bf16_smem(r, mt, bo, bk, k_pad // bk, plan.strip)
    assert plan.smem_bytes <= MAX_SMEM
    # every column lies in one strip and every strip has a block
    n_strips = -(-oi // plan.strip)
    assert n_strips * plan.strip >= oi and 1 <= plan.blocks <= n_strips
    # a warp per (oc-tile, item) of a strip, up to 16
    assert plan.threads == 32 * min(16, r * plan.strip // item)


@pytest.mark.parametrize("name", sorted(BF16_CONV_PLANS))
def test_goap_conv_bf16_plan_at_paper_shapes(name):
    shape, want = BF16_CONV_PLANS[name]
    plan = plan_goap_conv_bf16_launch(*shape)
    assert plan == want
    _check_conv_bf16_plan(plan, shape)


@pytest.mark.parametrize("bo", [4, 8, 16, 24, 32])
@pytest.mark.parametrize("bk", [16, 32, 48])
@pytest.mark.parametrize("oi", [1, 33, 129, 1000, 65536])
def test_goap_conv_bf16_plan_covers_tiles_and_ragged_oi(bo, bk, oi):
    shape = (3, 4, bo, bk, 5 * bk, oi)
    plan = plan_goap_conv_bf16_launch(*shape)
    _check_conv_bf16_plan(plan, shape)
    # no wider than OI needs (one box of 64 columns at least)
    assert plan.strip == 64 or plan.strip // 2 < oi


def test_goap_conv_bf16_plan_raises_where_the_card_would_refuse():
    # 7 k-tiles x 256 columns twice and 28 tiles of 8 x 32: 264,304 bytes
    with pytest.raises(ValueError, match="shared memory"):
        plan_goap_conv_bf16_launch(4, 7, 8, 32, 224, 32768, strip=256)
    assert plan_goap_conv_bf16_launch(4, 7, 8, 32, 224, 32768).strip == 128
    with pytest.raises(ValueError, match="block_oc"):
        plan_goap_conv_bf16_launch(1, 1, 40, 32, 32, 64)
    with pytest.raises(ValueError, match="strip"):
        plan_goap_conv_bf16_launch(2, 2, 8, 32, 64, 4096, strip=96)
    with pytest.raises(ValueError, match="strip"):              # narrower than a box
        plan_goap_conv_bf16_launch(2, 2, 8, 32, 64, 4096, strip=32)
    # 28 k-tiles of 32 rows x 64 columns twice are just under the limit, 29 over
    plan = plan_goap_conv_bf16_launch(1, 1, 8, 32, 28 * 32, 100)
    assert plan.strip == 64 and plan.smem_bytes == 231_172 <= MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        plan_goap_conv_bf16_launch(1, 1, 8, 32, 29 * 32, 100)


BF16_FC_PLANS = {
    "paper_fc1": ((512, 1024, 128), FCBf16Launch(16, 32, 8, 256, 139264, (32, 4))),
    "paper_fc2": ((512, 128, 11), FCBf16Launch(16, 16, 1, 32, 13056, (32, 1))),
    "small_fc1": ((32, 64, 16), FCBf16Launch(16, 16, 1, 32, 13056, (2, 1))),
    "ragged": ((70, 130, 40), FCBf16Launch(16, 32, 2, 64, 36352, (5, 2))),
    "out11_in1000": ((33, 1000, 11), FCBf16Launch(16, 16, 8, 256, 97280, (3, 1))),
    "out37": ((17, 300, 37), FCBf16Launch(16, 32, 3, 96, 53504, (2, 2))),
    "two_rounds": ((5, 2100, 64), FCBf16Launch(16, 32, 8, 256, 139264, (1, 2))),
    "no_inputs": ((4, 0, 16), FCBf16Launch(16, 16, 1, 32, 13056, (1, 1))),
    "big_batch": ((70_000, 1024, 128), FCBf16Launch(16, 32, 8, 256, 139264, (4375, 4))),
}


@pytest.mark.parametrize("name", sorted(BF16_FC_PLANS))
def test_wm_fc_bf16_plan(name):
    (b, din, dout), want = BF16_FC_PLANS[name]
    plan = plan_wm_fc_bf16_launch(b, din, dout)
    assert plan == want
    # a warp per 128-input reference tile, up to 8 a block (further rounds)
    assert plan.split == max(1, min(8, -(-din // 128))) and plan.threads == 32 * plan.split
    assert plan.smem_bytes == fc_bf16_smem(plan.rows, plan.out_tile, plan.split)
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.grid[0] * plan.rows >= b > (plan.grid[0] - 1) * plan.rows
    assert plan.grid[1] * plan.out_tile >= dout > (plan.grid[1] - 1) * plan.out_tile


def test_wm_fc_bf16_plan_raises_where_the_card_would_refuse():
    with pytest.raises(ValueError, match="shared memory"):   # 299,008 bytes
        plan_wm_fc_bf16_launch(512, 1024, 128, rows=32, out_tile=64, split=8)
    assert fc_bf16_smem(32, 64, 8) == 299_008
    with pytest.raises(ValueError, match="rows"):
        plan_wm_fc_bf16_launch(512, 1024, 128, rows=8)
    with pytest.raises(ValueError, match="out_tile"):
        plan_wm_fc_bf16_launch(512, 1024, 128, out_tile=24)
    with pytest.raises(ValueError, match="split"):
        plan_wm_fc_bf16_launch(512, 1024, 128, split=9)
    with pytest.raises(ValueError, match="grid"):
        plan_wm_fc_bf16_launch(4, 32, 32 * 65_536)
    # the largest block that fits: 32 rows x 32 outputs x 8 warps
    assert plan_wm_fc_bf16_launch(512, 1024, 128, rows=32, split=8).smem_bytes == 196_608


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


# the bf16 LIF's launch at the layer-by-layer path's shapes (batch 64, T 8,
# 132 SMs): (T, N, C, inner) -> (k, t_tile, threads, grid)
BF16_LIF_PLANS = {
    "fc1": ((8, 64 * 128, 128, 1), (1, 8, 64, 128)),
    "fc2": ((8, 64 * 11, 11, 1), (1, 8, 64, 11)),
    "conv1": ((8, 64 * 16 * 128, 16, 128), (2, 8, 128, 512)),
    "conv3": ((8, 64 * 64 * 32, 64, 32), (2, 8, 128, 512)),
}


@pytest.mark.parametrize("name", sorted(BF16_LIF_PLANS))
def test_lif_bf16_plan_at_the_layered_shapes(name):
    (tt, n, c, inner), (k, t_tile, threads, grid) = BF16_LIF_PLANS[name]
    plan = plan_lif_bf16_launch(tt, n, c, inner, 132)
    assert (plan.k, plan.t_tile, plan.threads, plan.grid) == (k, t_tile, threads, grid)


@pytest.mark.parametrize("tt,t_tile", [(0, 1), (1, 1), (3, 4), (8, 8), (16, 16), (17, 16),
                                       (40, 16)])
@pytest.mark.parametrize("n", [1, 7, 704, 1030, 8192])
def test_lif_bf16_plan_covers_every_neuron(tt, t_tile, n):
    for k in (None, 1, 2, 4, 8):
        for threads in (None, 32, 64, 128, 256):
            try:
                plan = plan_lif_bf16_launch(tt, n, n, 1, 132, k=k, threads=threads)
            except ValueError:
                assert k is not None and n % k
                continue
            assert plan.t_tile == t_tile and n % plan.k == 0
            assert plan.grid * plan.threads * plan.k >= n > (plan.grid - 1) * plan.threads * plan.k


def test_lif_bf16_plan_raises_where_the_kernel_has_no_instance():
    with pytest.raises(ValueError, match="k 3"):
        plan_lif_bf16_launch(8, 30, 30, 1, 132, k=3)
    with pytest.raises(ValueError, match="does not divide"):
        plan_lif_bf16_launch(8, 30, 30, 1, 132, k=4)
    with pytest.raises(ValueError, match="alignment"):
        plan_lif_bf16_launch(8, 32, 32, 1, 132, k=4, align=4)
    assert plan_lif_bf16_launch(8, 64 * 16 * 128, 16, 128, 132, align=2).k == 1
    with pytest.raises(ValueError, match="threads"):
        plan_lif_bf16_launch(8, 32, 32, 1, 132, threads=96)


# (C, inner, groups): FC layouts (inner 1) and conv layouts (inner W), N =
# groups x C x inner odd, so not a multiple of the k a thread takes
LIF_CHANNEL_LAYOUTS = {"fc": (7, 1, 3), "conv": (3, 11, 3)}


def _expanded(p, inner, groups):
    """A (C,) parameter as the reference's (N,) vector."""
    return np.tile(np.repeat(p, inner), groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("layout", sorted(LIF_CHANNEL_LAYOUTS))
@pytest.mark.parametrize("tt", [1, 3, 8, 17])
def test_lif_per_channel_and_v0_none_equal_the_expanded_call(tt, layout, dtype):
    c, inner, groups = LIF_CHANNEL_LAYOUTS[layout]
    n = c * inner * groups
    assert n % 2 == 1
    rng = np.random.default_rng(tt * n)
    cur = rng.normal(size=(tt, n))
    params = (rng.uniform(0.5, 0.99, c), rng.uniform(0.5, 1.5, c),
              rng.uniform(0.3, 1.2, c))

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)

    sp, vf = lif_update_fused(put(cur), None, *(put(a) for a in params), inner=inner)
    sp_n, vf_n = lif_update_fused(put(cur), put(np.zeros(n)),
                                  *(put(_expanded(a, inner, groups)) for a in params))
    assert sp.dtype == dtype and vf.shape == (n,)
    assert torch.equal(sp, sp_n) and torch.equal(vf, vf_n)


@pytest.mark.parametrize("n,c,inner", [(30, 4, 1), (30, 5, 4), (12, 5, 1), (12, 0, 1),
                                       (12, 12, 2)])
def test_lif_layouts_that_are_not_whole_channels_raise(n, c, inner):
    args = (torch.zeros(3, n), None, *(torch.ones(c) for _ in range(3)))
    with pytest.raises(ValueError, match="channels|vector"):
        lif_update_fused(*args, inner=inner)
    with pytest.raises(ValueError, match="inner"):
        lif_update_fused(torch.zeros(3, 12), None, *(torch.ones(4) for _ in range(3)),
                         inner=0)
    with pytest.raises(ValueError, match="vector"):
        lif_update_fused(torch.zeros(3, 12), None, torch.ones(4), torch.ones(3),
                         torch.ones(4))


def test_lif_op_equals_reference_on_bf16_fc_layout():
    tt, b, dout = 6, 5, 11
    rng = np.random.default_rng(11)
    cur = jnp.asarray(rng.normal(size=(tt, b, dout)), jnp.bfloat16)
    logit, theta, v_th = (jnp.asarray(a, jnp.bfloat16) for a in (
        rng.normal(size=dout) + 1.5, rng.uniform(0.5, 1.5, dout),
        rng.uniform(0.3, 1.2, dout)))
    ref_params = dataclasses.replace(ref_init_lif((dout,), dtype=jnp.bfloat16),
                                     alpha_logit=logit, theta=theta, v_th=v_th)
    sp_r, vf_r = ref_ops.lif_op(cur, ref_params)

    def tb(a):
        return t(jnp.asarray(a, jnp.float32)).to(torch.bfloat16)

    params = init_lif_params((dout,), dtype=torch.bfloat16)
    params = dataclasses.replace(params, alpha_logit=tb(logit), theta=tb(theta),
                                 v_th=tb(v_th))
    sp, vf = lif_op(tb(cur), params)
    assert sp.dtype == torch.bfloat16 and vf.dtype == torch.bfloat16
    np.testing.assert_array_equal(sp.float().numpy(), np.asarray(sp_r, np.float32))
    np.testing.assert_array_equal(vf.float().numpy(), np.asarray(vf_r, np.float32))


def test_lif_op_equals_reference_on_f32_conv_layout():
    tt, b, oc, oi = 5, 3, 6, 33
    rng = np.random.default_rng(12)
    cur = rng.normal(size=(tt, b, oc, oi)).astype(np.float32)
    v0 = rng.normal(size=(b, oc, oi)).astype(np.float32)
    for start in (None, v0):
        ref_start = None if start is None else jnp.asarray(start)
        sp_r, vf_r = ref_ops.lif_op(jnp.asarray(cur), ref_init_lif(
            (oc, 1), alpha=0.8, theta=0.7, v_th=0.4), ref_start)
        sp, vf = lif_op(t(cur), init_lif_params((oc, 1), alpha=0.8, theta=0.7,
                                                v_th=0.4),
                        None if start is None else t(start))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_r))
        np.testing.assert_allclose(vf.numpy(), np.asarray(vf_r), atol=1e-5, rtol=1e-5)


# ops that building a LIF's operands per call would send: the broadcast
# copies, the zero start, the casts and the decay's sigmoid chain
OPERAND_OPS = {"zeros", "zero_", "fill_", "new_zeros", "clone", "_to_copy", "copy_",
               "exp", "sigmoid", "reciprocal", "neg", "add", "mul", "div",
               "expand", "full"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_cells_build_no_lif_operands_per_call(dtype, monkeypatch):
    """The ``cuda`` conv and FC cells hand their LIF the operands made when
    the cell was built: inside ``lif_op``, with the kernel wrapper stubbed,
    nothing but views reaches the dispatcher.  The conv's currents come in
    its (OC, T x B, OI) order and are made contiguous before the count:
    flattening them is the conv output's layout copy, not the LIF's
    operands."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.api import init_snn, make_mask_pytree
    from repro_torch.kernels import ops

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []
            self.on = True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.on:
                self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    counter = Ops()
    lif_calls = []

    def stub(cur, v0, alpha, theta, v_th, *, inner=1):   # the kernel, stubbed
        lif_calls.append((tuple(cur.shape), v0, alpha.shape[0], inner, alpha.dtype))
        counter.on = False
        out = (torch.zeros_like(cur), torch.zeros_like(cur[0]))
        counter.on = True
        return out

    def counted(currents, *args, **kwargs):
        currents = currents.contiguous()
        with counter:
            return real_lif_op(currents, *args, **kwargs)

    real_lif_op = ops.lif_op
    monkeypatch.setattr(ops, "lif_update_fused", stub)
    monkeypatch.setattr(ops, "lif_op", counted)
    params = init_snn(0, SMALL, dtype=dtype)
    masks = {g: [m.to(dtype) for m in ms]
             for g, ms in make_mask_pytree(params, 0.5).items()}
    bound = compile_snn(SMALL)._bind(params, "cuda", masks=masks, device="cpu")
    frames = t(spike_frames(0, (4, SMALL.timesteps, SMALL.conv_specs[0][1],
                                SMALL.input_width)))
    bound.batch(frames)
    n_conv, n_fc = len(SMALL.conv_specs), len(SMALL.fc_specs)
    assert len(lif_calls) == n_conv + n_fc
    for shape, v0, c, inner, p_dtype in lif_calls[:n_conv]:   # f32 membranes
        assert v0 is None and p_dtype == torch.float32 and inner == shape[1] // (4 * c)
    for shape, v0, c, inner, p_dtype in lif_calls[n_conv:]:
        assert v0 is None and p_dtype == dtype and inner == 1 and shape[1] == 4 * c
    assert not set(counter.seen) & OPERAND_OPS, counter.seen
    assert set(counter.seen) <= {"view", "_unsafe_view", "alias"}, counter.seen


def test_cuda_fc_cell_refuses_lif_parameters_wider_than_its_currents_when_built():
    from repro_torch.api import init_snn

    params = init_snn(0, SMALL, dtype=torch.bfloat16)
    lif = params["fc"][0]["lif"]
    params["fc"][0]["lif"] = dataclasses.replace(
        lif, alpha_logit=lif.alpha_logit.float(), theta=lif.theta.float(),
        v_th=lif.v_th.float())
    with pytest.raises(TypeError, match="float32 against torch.bfloat16"):
        compile_snn(SMALL)._bind(params, "cuda", device="cpu")
    # the conv's membrane is f32: bf16 parameters there are promoted
    compile_snn(SMALL)._bind(init_snn(0, SMALL, dtype=torch.bfloat16), "cuda",
                             device="cpu")


def test_wrappers_take_float32_only():
    # narrowed: float32 and bfloat16 (the reference's kernel contract) are
    # taken, so the check is that every other dtype (float16, float64) is
    # refused
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wm_fc_matmul(torch.ones(2, 4, dtype=torch.float16),
                     torch.ones(4, 3, dtype=torch.float16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
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
                # ascending ic-major row k = ic*KW + ci (w_cm's columns
                # are ci-major, r = ci*IC + ic)
                nz = np.flatnonzero(layer.w_cm[ch])
                k = (nz % layer.ic) * layer.kw + nz // layer.ic
                nz = nz[np.argsort(k)]
                assert (np.diff(np.sort(k)) > 0).all()
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
