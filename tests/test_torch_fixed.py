"""The port's integer tier and LSQ serving, held to the live reference
(CPU).

Codes, ``FixedLIF`` registers, encoder bits and int32 logits bit-equal to
``repro.fixed`` and to both numpy goldens (the reference's and the
port's), at 8 and 16 bits; ``lsq_fake_quant``'s value bit-equal and both
of its gradients within 1e-6 of ``jax.grad``; quantized engines predict
what the reference engines predict.  LSQ step sizes come from the
reference (its float32 mean sums in another order) like the weights.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import PAPER, PAPER_REF, SMALL, SMALL_REF, setup
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro import fixed as ref_fixed
from repro.models.graph import compile_snn as ref_compile_snn
from repro.models.snn import SNNConfig as RefConfig
from repro.plan import PlanCache as RefPlanCache
from repro.plan import compile_plan as ref_compile_plan
from repro.serve import AsyncAMCServeEngine as RefEngine
from repro.train import lsq as ref_lsq
from repro_torch import fixed
from repro_torch.api import compile_plan, compile_snn
from repro_torch.fixed.backend import _LifConsts, fixed_lif_step
from repro_torch.fixed.quantize import FixedQuantFn, lif_to_fixed
from repro_torch.models.snn import SNNConfig
from repro_torch.serve import AsyncAMCServeEngine
from repro_torch.train import lsq

# the reduced configs of tests/test_fixed.py
SPEC_A = dict(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
              fc_specs=((32, 16), (16, 5)), input_width=16, timesteps=3,
              n_classes=5)
SPEC_B = dict(conv_specs=((5, 2, 8),), pool=2, fc_specs=((64, 10),),
              input_width=16, timesteps=4, n_classes=10,
              readout="spike_count")
CONFIGS = {"two_conv_current": (SNNConfig(**SPEC_A), RefConfig(**SPEC_A)),
           "one_conv_spikecount": (SNNConfig(**SPEC_B), RefConfig(**SPEC_B)),
           "small": (SMALL, SMALL_REF)}


def _iq(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 2, cfg.input_width)).astype(np.float32)


def _scales_to_torch(scales):
    return {g: [torch.tensor(np.asarray(s)) for s in scales[g]]
            for g in ("conv", "fc")}


def _setup(ref_cfg, seed, bits, calibrate=False):
    """(ref params, ref masks, port params, port masks, ref scales, port
    scales); the scales are None when the tier calibrates."""
    params, masks, tparams, tmasks = setup(ref_cfg, seed, 0.5)
    if calibrate:
        return params, masks, tparams, tmasks, None, None
    scales = ref_lsq.init_lsq_scales(params, bits)
    return params, masks, tparams, tmasks, scales, _scales_to_torch(scales)


# ---------------------------------------------------------------------------
# bind-time conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("seed", range(3))
def test_conversion_equals_reference(bits, seed):
    params, masks, tparams, tmasks, scales, tscales = _setup(SMALL_REF, seed, bits)
    for group, i in itertools.chain((("conv", i) for i in range(2)),
                                    (("fc", i) for i in range(2))):
        w = np.asarray(params[group][i]["w"])
        m = np.asarray(masks[group][i])
        assert fixed.calibrate_step(w * m, bits) == ref_fixed.calibrate_step(w * m, bits)
        rq, tq = ref_fixed.FixedQuantFn(scales, bits), FixedQuantFn(tscales, bits)
        step = rq.step_for(group, i, w * m)
        assert tq.step_for(group, i, w * m) == step
        np.testing.assert_array_equal(fixed.quantize_codes(w * m, step, bits),
                                      ref_fixed.quantize_codes(w * m, step, bits))
        got = fixed.derive_fixed_layer(group, i, tparams[group][i]["w"],
                                       mask=tmasks[group][i], quant_fn=tq)
        want = ref_fixed.derive_fixed_layer(group, i, params[group][i]["w"],
                                            mask=masks[group][i], quant_fn=rq)
        assert got.codes.dtype == want.codes.dtype
        np.testing.assert_array_equal(got.codes, want.codes)
        assert (got.step, got.bits) == (want.step, want.bits)
        tl = lif_to_fixed(tparams[group][i]["lif"], got.step)
        rl = ref_fixed.lif_to_fixed(params[group][i]["lif"], want.step)
        for f in dataclasses.fields(rl):
            np.testing.assert_array_equal(getattr(tl, f.name),
                                          getattr(rl, f.name), err_msg=f.name)


@pytest.mark.parametrize("bits", [8, 16])
def test_fixed_quant_fn_value_equals_reference(bits):
    params, masks, tparams, _, scales, tscales = _setup(SMALL_REF, 0, bits)
    for sc, tsc in ((scales, tscales), (None, None)):
        rq, tq = ref_fixed.FixedQuantFn(sc, bits), FixedQuantFn(tsc, bits)
        for group in ("conv", "fc"):
            for lp, tlp in zip(params[group], tparams[group]):
                want = np.asarray(rq(lp["w"]))
                got = tq(tlp["w"])
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
    assert (fixed.fixed_logit_scale(tparams, SMALL, quant_fn=FixedQuantFn(tscales, bits))
            == ref_fixed.fixed_logit_scale(params, SMALL_REF,
                                           quant_fn=ref_fixed.FixedQuantFn(scales, bits)))
    for assignment in ("fixed", {"conv1": "fixed"}, "goap", {"conv1": "goap"}, None):
        assert (fixed.assignment_uses_fixed(assignment)
                == ref_fixed.assignment_uses_fixed(assignment))
    assert isinstance(fixed.serving_quant_fn(None, bits, "fixed"), FixedQuantFn)
    assert fixed.serving_quant_fn(None, bits, "goap") is None
    with pytest.raises(ValueError):
        FixedQuantFn(None, bits=4)


# ---------------------------------------------------------------------------
# integer datapath
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("osr", [1, 8])
def test_fixed_encoder_equals_reference_and_golden(osr):
    iq = np.random.default_rng(osr).normal(size=(4, 2, 128)).astype(np.float32)
    iq[0] = 0.0                                   # the padded-bucket row
    want = np.asarray(ref_fixed.fixed_encode_batch(jnp.asarray(iq), osr))
    got = fixed.fixed_encode_batch(torch.from_numpy(iq), osr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    golden = np.moveaxis(fixed.golden_encode_frames(iq, osr), 0, 1)
    np.testing.assert_array_equal(golden, want)
    x = np.random.default_rng(9).random((3, 17)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 0.5 / 32768, 1.5 / 32768]   # round-half ties
    np.testing.assert_array_equal(
        fixed.fixed_sigma_delta_encode(torch.from_numpy(x), osr).numpy(),
        np.asarray(ref_fixed.fixed_sigma_delta_encode(jnp.asarray(x), osr)))


def test_fixed_lif_step_equals_reference():
    from repro.fixed.backend import _LifConsts as RefConsts
    from repro.fixed.backend import fixed_lif_step as ref_step

    rng = np.random.default_rng(0)
    v16 = rng.integers(-32768, 32768, size=(4, 6, 10)).astype(np.int16)
    acc = rng.integers(-2 ** 26, 2 ** 26, size=(4, 6, 10)).astype(np.int32)
    leak = rng.integers(0, 16, size=(6, 1)).astype(np.int32)
    vth = rng.integers(1, 8000, size=(6, 1)).astype(np.int32)
    theta = rng.integers(1, 8000, size=(6, 1)).astype(np.int32)
    for acc_shift in (0, 3, 24):
        want_v, want_s = ref_step(jnp.asarray(v16), jnp.asarray(acc), RefConsts(
            jnp.asarray(leak), jnp.asarray(vth), jnp.asarray(theta), acc_shift))
        got_v, got_s = fixed_lif_step(torch.from_numpy(v16), torch.from_numpy(acc),
                                      _LifConsts(torch.from_numpy(leak),
                                                 torch.from_numpy(vth),
                                                 torch.from_numpy(theta),
                                                 acc_shift))
        assert got_v.dtype == torch.int16 and got_s.dtype == torch.int32
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


PARITY_GRID = list(itertools.product(CONFIGS, (0, 1, 2), (8, 16)))


@pytest.mark.parametrize("cfg_name,seed,bits", PARITY_GRID)
def test_fixed_backend_bit_equal_to_reference_and_goldens(cfg_name, seed, bits):
    cfg, ref_cfg = CONFIGS[cfg_name]
    # odd seeds calibrate (no LSQ state at serve time)
    params, masks, tparams, tmasks, scales, tscales = _setup(
        ref_cfg, seed, bits, calibrate=seed % 2 == 1)
    iq = _iq(cfg, 3, seed=seed)
    ref_plan = ref_compile_plan(ref_compile_snn(ref_cfg), params, masks=masks,
                                quant_fn=ref_fixed.FixedQuantFn(scales, bits),
                                assignment="fixed",
                                cache=RefPlanCache(disk_dir=""))
    want = np.asarray(ref_plan.bound.batch(
        ref_fixed.fixed_encode_batch(jnp.asarray(iq), cfg.timesteps)))
    plan = compile_plan(compile_snn(cfg), tparams, masks=tmasks,
                        quant_fn=FixedQuantFn(tscales, bits),
                        assignment="fixed", device="cpu")
    enc = fixed.fixed_encode_batch(torch.from_numpy(iq), cfg.timesteps)
    got = plan.bound.batch(enc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ref_golden = ref_fixed.build_golden(ref_cfg, params, masks=masks,
                                        quant_fn=ref_fixed.FixedQuantFn(scales, bits))
    golden = fixed.build_golden(cfg, tparams, masks=tmasks,
                                quant_fn=FixedQuantFn(tscales, bits))
    assert golden.logit_scale == ref_golden.logit_scale
    for i, f in enumerate(iq):
        np.testing.assert_array_equal(golden.forward_iq(f), want[i])
        np.testing.assert_array_equal(ref_golden.forward_iq(f), want[i])
    # the streaming executor gives the same ints
    streamed, _ = plan.run_streaming(enc[0])
    np.testing.assert_array_equal(streamed.numpy(), want[0])


def test_fixed_backend_bit_equal_paper_config():
    """Paper pin at 16 bits: two frames, the port against the reference
    backend and the port's golden."""
    params, masks, tparams, tmasks, scales, tscales = _setup(PAPER_REF, 0, 16)
    iq = _iq(PAPER, 2, seed=7)
    want = np.asarray(ref_compile_plan(
        ref_compile_snn(PAPER_REF), params, masks=masks,
        quant_fn=ref_fixed.FixedQuantFn(scales, 16), assignment="fixed",
        cache=RefPlanCache(disk_dir="")).bound.batch(
            ref_fixed.fixed_encode_batch(jnp.asarray(iq), PAPER.timesteps)))
    plan = compile_plan(compile_snn(PAPER), tparams, masks=tmasks,
                        quant_fn=FixedQuantFn(tscales, 16), assignment="fixed",
                        device="cpu")
    got = plan.bound.batch(fixed.fixed_encode_batch(torch.from_numpy(iq),
                                                    PAPER.timesteps))
    np.testing.assert_array_equal(got.numpy(), want)
    golden = fixed.build_golden(PAPER, tparams, masks=tmasks,
                                quant_fn=FixedQuantFn(tscales, 16))
    np.testing.assert_array_equal(np.stack([golden.forward_iq(f) for f in iq]),
                                  want)
    assert np.abs(want).max() > 0


# ---------------------------------------------------------------------------
# LSQ
# ---------------------------------------------------------------------------

LSQ_CASES = [(8, (11, 2, 16), None), (8, (11, 2, 16), 0.01), (8, (64,), None),
             (8, (64,), 0.01), (16, (11, 2, 16), None), (16, (11, 2, 16), 0.01),
             (16, (64,), None), (16, (64,), 0.01)]


@pytest.mark.parametrize("bits,shape,step", LSQ_CASES)
def test_lsq_fake_quant_value_and_gradients_match_jax(bits, shape, step):
    """None: the LSQ init step; 0.01 at 8 bits clips (|w/s| up to ~300)."""
    rng = np.random.default_rng(len(shape) * bits)
    w = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    if step is None:
        step = 2 * np.abs(w).mean() / np.sqrt(2 ** (bits - 1) - 1)
    step = np.float32(step)
    want = np.asarray(ref_lsq.lsq_fake_quant(jnp.asarray(w), jnp.asarray(step), bits))
    gw, gs = jax.grad(lambda w_, s_: jnp.sum(
        ref_lsq.lsq_fake_quant(w_, s_, bits) * jnp.asarray(g)), argnums=(0, 1))(
            jnp.asarray(w), jnp.asarray(step))
    wt = torch.tensor(w, requires_grad=True)
    st = torch.tensor(step, requires_grad=True)
    out = lsq.lsq_fake_quant(wt, st, bits)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(st.grad), float(gs), rtol=1e-6, atol=1e-6)


def test_round_half_to_even_like_jnp():
    ties = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    got = torch.round(torch.from_numpy(ties)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.round(jnp.asarray(ties))))
    np.testing.assert_array_equal(got, [-2, -2, -0, 0, 2, 2, 4])
    # and through the fake-quant and the integer codes, on exact ties
    w = torch.from_numpy(ties * np.float32(0.25))
    np.testing.assert_array_equal(lsq.lsq_fake_quant(w, 0.25, 8).numpy(),
                                  np.asarray(ref_lsq.lsq_fake_quant(
                                      jnp.asarray(ties * np.float32(0.25)),
                                      jnp.float32(0.25), 8)))
    np.testing.assert_array_equal(
        lsq.quantize_to_int(w, 0.25, 8).numpy(),
        np.asarray(ref_lsq.quantize_to_int(jnp.asarray(w.numpy()), 0.25, 8)))


@pytest.mark.parametrize("bits", [8, 16])
def test_lsq_helpers_match_reference(bits):
    params, _, tparams, _ = setup(SMALL_REF, 1, 0.5)
    want = ref_lsq.init_lsq_scales(params, bits)
    got = lsq.init_lsq_scales(tparams, bits)
    for group in ("conv", "fc"):
        for a, b in zip(got[group], want[group]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    rfn = ref_lsq.make_serving_quant_fn(want, bits)
    tfn = lsq.make_serving_quant_fn(_scales_to_torch(want), bits)
    for group in ("conv", "fc", "conv"):          # the index wraps around
        for lp, tlp in zip(params[group], tparams[group]):
            np.testing.assert_array_equal(tfn(tlp["w"]).detach().numpy(),
                                          np.asarray(rfn(lp["w"])))
    w = params["fc"][0]["w"]
    s = want["fc"][0]
    codes = lsq.quantize_to_int(tparams["fc"][0]["w"], torch.tensor(np.asarray(s)), bits)
    want_codes = ref_lsq.quantize_to_int(w, s, bits)
    assert codes.dtype == torch.int16
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(
        lsq.dequantize(codes, torch.tensor(np.asarray(s))).numpy(),
        np.asarray(ref_lsq.dequantize(want_codes, s)))


# ---------------------------------------------------------------------------
# quantized serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port,ref,bits", [("fixed", "fixed", 8),
                                           ("fixed", "fixed", 16),
                                           ("cuda_fused", "goap", 8),
                                           ("stream", "goap", 16)])
def test_quantized_engine_predicts_what_the_reference_engine_predicts(port, ref, bits):
    cfg, ref_cfg = CONFIGS["two_conv_current"]
    params, masks, tparams, tmasks, scales, tscales = _setup(ref_cfg, 3, bits)
    iq = _iq(cfg, 11, seed=3)
    with RefEngine(params, ref_cfg, masks, backend=ref, max_batch=4,
                   lsq_scales=scales, quant_bits=bits) as engine:
        want = engine.classify(iq)
    with AsyncAMCServeEngine(tparams, cfg, tmasks, backend=port, max_batch=4,
                             lsq_scales=tscales, quant_bits=bits,
                             device="cpu") as engine:
        got = engine.classify(iq)
        logits = engine.step(iq[:4])
    np.testing.assert_array_equal(got, want)
    if port == "fixed":     # the served step's ints are the golden's
        golden = fixed.build_golden(cfg, tparams, masks=tmasks,
                                    quant_fn=FixedQuantFn(tscales, bits))
        assert logits.dtype == np.int32
        np.testing.assert_array_equal(
            logits, np.stack([golden.forward_iq(f) for f in iq[:4]]))
