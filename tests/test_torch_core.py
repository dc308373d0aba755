"""Port core numerics held to the live reference (CPU).

Sparse-format artifacts, Σ-Δ bits, pooling and masks must be equal;
LIF spikes exact with ``v`` within 1e-6; conv currents within 1e-5; the
sigmoid of the LIF decay bit-equal at the default init; the surrogate
gradient within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import t
from repro.core import encoder as ref_enc
from repro.core import goap as ref_goap
from repro.core import lif as ref_lif
from repro.core import saocds as ref_saocds
from repro.core import sparse_format as ref_sf
from repro.data import pipeline as ref_pipe
from repro.train import pruning as ref_pruning
from repro_torch.core import encoder, goap, lif, saocds, sparse_format
from repro_torch.data import pipeline
from repro_torch.train import pruning

KERNELS = [  # (kw, ic, oc, density, seed)
    (11, 2, 16, 0.5, 0), (11, 16, 32, 0.3, 1), (5, 32, 64, 0.1, 2),
    (3, 4, 8, 0.0, 3), (3, 1, 1, 1.0, 4), (7, 24, 48, 0.02, 5),
]


def _kernel(kw, ic, oc, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((kw, ic, oc)) < density)
            * rng.normal(size=(kw, ic, oc))).astype(np.float32)


def _assert_same_fields(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


@pytest.mark.parametrize("kw,ic,oc,density,seed", KERNELS)
def test_sparse_format_artifacts_equal_reference(kw, ic, oc, density, seed):
    k = _kernel(kw, ic, oc, density, seed)
    coo, ref_coo = sparse_format.coo_from_dense(k), ref_sf.coo_from_dense(k)
    _assert_same_fields(coo, ref_coo,
                        ("data", "row_idx", "col_idx", "kw", "ic", "oc"))
    np.testing.assert_array_equal(sparse_format.coo_to_dense(coo),
                                  ref_sf.coo_to_dense(ref_coo))
    _assert_same_fields(sparse_format.build_schedule(coo),
                        ref_sf.build_schedule(ref_coo),
                        ("kind", "weight", "oc", "ic", "ci", "emit",
                         "n_compute", "n_extra", "n_empty"))
    for bo, bk in ((8, 32), (4, 16)):
        _assert_same_fields(
            sparse_format.block_sparse_from_dense(k, bo, bk),
            ref_sf.block_sparse_from_dense(k, bo, bk),
            ("blocks", "block_cols", "tile_valid", "n_tiles_per_row", "oc",
             "k", "kw", "ic", "block_oc", "block_k"))
    _assert_same_fields(goap.goap_pack(coo), ref_goap.goap_pack(ref_coo),
                        ("w_pad", "row_pad", "kw", "ic", "oc"))


@pytest.mark.parametrize("osr", [1, 3, 8])
def test_sigma_delta_encoders_bit_exact(osr):
    rng = np.random.default_rng(osr)
    iq = rng.normal(size=(5, 2, 32)).astype(np.float32)
    want = ref_pipe.sigma_delta_encode_np(iq, osr)
    np.testing.assert_array_equal(pipeline.sigma_delta_encode_np(iq, osr), want)
    np.testing.assert_array_equal(
        np.asarray(ref_pipe.sigma_delta_encode_batch(jnp.asarray(iq), osr)), want)
    np.testing.assert_array_equal(
        pipeline.sigma_delta_encode_batch(t(iq), osr).numpy(), want)
    np.testing.assert_array_equal(
        encoder.normalize_iq(t(iq)).numpy(),
        np.asarray(ref_enc.normalize_iq(jnp.asarray(iq))))
    x = rng.random((3, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        encoder.sigma_delta_encode(t(x), osr).numpy(),
        np.asarray(ref_enc.sigma_delta_encode(jnp.asarray(x), osr)))


@pytest.mark.parametrize("seed", range(3))
def test_lif_step_matches_reference(seed):
    rng = np.random.default_rng(seed)
    shape = (6, 33)
    v = rng.normal(size=shape).astype(np.float32)
    cur = rng.normal(size=shape).astype(np.float32)
    logit = rng.normal(size=(6, 1)).astype(np.float32)
    theta = rng.uniform(0.5, 1.5, (6, 1)).astype(np.float32)
    vth = rng.uniform(0.3, 1.2, (6, 1)).astype(np.float32)
    rv, rs = ref_lif.lif_step(jnp.asarray(v), jnp.asarray(cur),
                              ref_lif.LIFParams(jnp.asarray(logit),
                                                jnp.asarray(theta),
                                                jnp.asarray(vth)))
    pv, ps = lif.lif_step(t(v), t(cur), lif.LIFParams(t(logit), t(theta), t(vth)))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)


def test_alpha_sigmoid_bit_equal_at_default_init_and_2ulp_elsewhere():
    logit = np.float32(np.log(0.9 / 0.1))
    default = ref_lif.init_lif_params((16, 1)).alpha_logit
    for lg in (np.full((16, 1), logit, np.float32), np.asarray(default)):
        np.testing.assert_array_equal(
            torch.sigmoid(t(lg)).numpy(),
            np.asarray(jax.nn.sigmoid(jnp.asarray(lg))))
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=4.0, size=100_000).astype(np.float32)
    got = torch.sigmoid(t(logits)).numpy()
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


def test_spike_surrogate_gradient_matches_reference():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(64,)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda x: jnp.sum(ref_lif.spike(x) * jnp.asarray(g)))(jnp.asarray(u)))
    ut = t(u).requires_grad_(True)
    (lif.spike(ut) * t(g)).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), want, atol=1e-6, rtol=0)
    assert lif.SURROGATE_SLOPE == ref_lif.SURROGATE_SLOPE


@pytest.mark.parametrize("kw,ic,oc,density,seed", KERNELS[:4])
def test_conv_oracles_match_reference(kw, ic, oc, density, seed):
    k = _kernel(kw, ic, oc, density, seed)
    rng = np.random.default_rng(seed + 10)
    ifm = (rng.random((ic, 40)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        goap.build_shift_buffer(t(ifm), kw).numpy(),
        np.asarray(ref_goap.build_shift_buffer(jnp.asarray(ifm), kw)))
    want = np.asarray(ref_goap.conv1d_dense_oracle(jnp.asarray(ifm),
                                                   jnp.asarray(k)))
    np.testing.assert_allclose(goap.conv1d_dense_oracle(t(ifm), t(k)).numpy(),
                               want, atol=1e-5, rtol=0)
    pack = goap.goap_pack(sparse_format.coo_from_dense(k))
    ref_pack = ref_goap.goap_pack(ref_sf.coo_from_dense(k))
    np.testing.assert_allclose(goap.goap_conv_packed(t(ifm), pack).numpy(),
                               np.asarray(ref_goap.goap_conv_packed(
                                   jnp.asarray(ifm), ref_pack)),
                               atol=1e-5, rtol=0)
    # leading batch dims carry through (the reference vmaps instead)
    batch = np.stack([ifm, 1 - ifm])
    np.testing.assert_allclose(goap.goap_conv_packed(t(batch), pack)[1].numpy(),
                               np.asarray(ref_goap.goap_conv_packed(
                                   jnp.asarray(1 - ifm), ref_pack)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw,pool,w", [(11, 2, 128), (5, 2, 33), (4, 3, 10)])
def test_pad_and_pool_equal_reference(kw, pool, w):
    x = (np.random.default_rng(w).random((2, 3, w)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        saocds.pad_same(t(x), kw).numpy(),
        np.asarray(ref_saocds.pad_same(jnp.asarray(x), kw)))
    np.testing.assert_array_equal(
        saocds.max_pool_spikes(t(x), pool).numpy(),
        np.asarray(ref_saocds.max_pool_spikes(jnp.asarray(x), pool)))


@pytest.mark.parametrize("density", [0.3, 0.5, 1.0])
def test_magnitude_masks_equal_reference(density):
    w = np.random.default_rng(7).normal(size=(11, 16, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        pruning.magnitude_masks(t(w), density).numpy(),
        np.asarray(ref_pruning.magnitude_masks(jnp.asarray(w), density)))
