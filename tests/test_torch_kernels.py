"""Port kernel modules held to the reference's Pallas kernels (CPU).

On the CPU each wrapper runs its plain PyTorch version; the reference
runs its Pallas kernels in interpret mode, as its own tests do.  Currents
and logits within 1e-5, spikes and counters exactly equal.  The CUDA
kernels themselves are held to their plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import SMALL, SMALL_REF, setup, spike_frames, t
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
    goap_conv_op,
    lif_op,
    lif_update_fused,
    stream_fused_forward,
    wm_fc_matmul,
    wm_fc_op,
)

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
