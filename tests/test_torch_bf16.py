"""The SNN with bfloat16 weights, held to the live reference (CPU).

The reference's ``init_snn(key, cfg, dtype=jnp.bfloat16)`` params cross to
the port as bf16 (``repro_torch.convert``), and both packages run the same
numpy frames.  Tolerances:

* each bf16 kernel's plain version against the reference's Pallas kernel
  (interpret mode, as its own tests run it): **bit for bit**.  The
  reference's own ceiling for these forms is rtol 5e-2, atol 0.3 (goap)
  and 5e-2 (wm_fc) against its oracles (``tests/test_kernels.py``); bit
  equality holds, so the ceiling is never used;
* the whole model, every backend pair (``dense``, ``goap``, ``stream``,
  ``cuda`` <-> ``pallas``, ``cuda_fused`` <-> ``pallas_fused``): logits of
  the reference's dtype, within 1 bf16 ulp (rtol 2**-7), predictions
  equal, ``stream`` counters exact.  Bit equality holds here too; the
  ulp bound is the contract, since a rounding point that moves flips
  spikes;
* serving: the port's sync and async engines give the reference sync
  engine's predictions.

Where the reference rounds is pinned here as well: every bf16 op on its
own (eager torch), except the bf16 sigmoid promoted against an f32
membrane inside its traced step, whose last divide XLA keeps in f32
(``LIFParams.alpha_for``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (PAPER, PAPER_REF, SMALL, SMALL_REF, params_to_numpy,
                           setup_bf16, t)
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.api import (compile_plan as ref_compile_plan, compile_snn as ref_compile_snn,
                       init_snn as ref_init_snn)
from repro.core.lif import LIFParams as RefLIF, lif_step as ref_lif_step
from repro.core.saocds import wm_fc_layer as ref_wm_fc_layer
from repro.data.pipeline import sigma_delta_encode_np
from repro.kernels.goap_conv import goap_conv_block_sparse as ref_goap_raw
from repro.kernels.lif_update import lif_update_fused as ref_lif_raw
from repro.kernels.wm_fc import wm_fc_matmul as ref_wm_fc
from repro.serve.engine import AMCServeEngine as RefSync
from repro_torch.api import AsyncAMCServeEngine, compile_plan, compile_snn, init_snn
from repro_torch.convert import params_from_numpy
from repro_torch.core.lif import LIFParams, init_lif_params, lif_step
from repro_torch.core.saocds import wm_fc_layer
from repro_torch.kernels import (goap_conv_block_sparse, goap_conv_block_sparse_bf16_ref,
                                 lif_update_fused, lif_update_fused_ref, wm_fc_matmul,
                                 wm_fc_matmul_bf16_ref)
from repro_torch.serve import AMCServeEngine

BF16 = torch.bfloat16
ULP = 2.0 ** -7          # bf16 keeps 8 significant bits
BACKENDS = [("dense", "dense"), ("goap", "goap"), ("stream", "stream"),
            ("cuda", "pallas"), ("cuda_fused", "pallas_fused")]
COUNTER_KEYS = ("reps_per_timestep", "compute_iters", "extra_iters",
                "empty_iters", "accumulations", "timesteps")


def bf(a) -> torch.Tensor:
    """A jax (bf16) array -> the same bf16 values as a torch tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(BF16)


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_bits(got: torch.Tensor, want) -> None:
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), f32(want))


def assert_logits(got: torch.Tensor, want) -> None:
    """The reference's dtype, within 1 bf16 ulp, equal predictions."""
    want_dtype = {jnp.dtype(jnp.bfloat16): BF16,
                  jnp.dtype(jnp.float32): torch.float32}[want.dtype]
    assert got.dtype == want_dtype
    w = f32(want)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=ULP, atol=0)
    np.testing.assert_array_equal(got.float().numpy().argmax(-1), w.argmax(-1))


# ---------------------------------------------------------------------------
# The kernels' bf16 forms: plain versions against the reference's kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,din,dout", [(8, 256, 64), (5, 100, 37), (512, 1024, 128)])
def test_wm_fc_bf16_equals_reference_kernel(b, din, dout):
    rng = np.random.default_rng(b * din + dout)
    s = jnp.asarray(rng.random((b, din)) < 0.5, jnp.bfloat16)
    w = jnp.asarray((rng.random((din, dout)) < 0.4) * rng.normal(size=(din, dout)),
                    jnp.bfloat16)
    want = ref_wm_fc(s, w)
    assert want.dtype == jnp.bfloat16
    assert_bits(wm_fc_matmul_bf16_ref(bf(s), bf(w)), want)
    # the dtype-generic wrapper takes the bf16 form (and f32 spikes)
    assert_bits(wm_fc_matmul(bf(s).float(), bf(w)), want)


@pytest.mark.parametrize("bo,bk", [(8, 16), (8, 32)])
def test_goap_conv_bf16_equals_reference_kernel(bo, bk):
    rng = np.random.default_rng(bo * bk)
    r, mt, nk, oi = 3, 4, 5, 64
    blocks = jnp.asarray(rng.normal(size=(r, mt, bo, bk)), jnp.bfloat16)
    cols = jnp.asarray(rng.integers(0, nk, (r, mt)), jnp.int32)
    x = jnp.asarray(rng.random((nk * bk, oi)) < 0.5, jnp.bfloat16)
    want = ref_goap_raw(blocks, cols, x, block_oc=bo, block_k=bk, block_oi=oi)
    tcols = torch.from_numpy(np.asarray(cols))
    assert_bits(goap_conv_block_sparse_bf16_ref(bf(blocks), tcols, bf(x)), want)
    assert_bits(goap_conv_block_sparse(bf(blocks), tcols, bf(x), block_oc=bo,
                                       block_k=bk), want)


@pytest.mark.parametrize("tt,n", [(1, 16), (4, 128), (8, 200), (3, 1030), (16, 7)])
def test_lif_bf16_equals_reference_kernel(tt, n):
    rng = np.random.default_rng(tt * n)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (
        rng.normal(size=(tt, n)), rng.normal(size=n), rng.uniform(0.5, 0.99, n),
        rng.uniform(0.5, 1.5, n), rng.uniform(0.3, 1.2, n))]
    sp_r, vf_r = ref_lif_raw(*args)
    for fn in (lif_update_fused_ref, lif_update_fused):
        sp, vf = fn(*(bf(a) for a in args))
        assert_bits(sp, sp_r)
        assert_bits(vf, vf_r)


@pytest.mark.parametrize("tt,din,dout", [(6, 300, 37), (8, 1024, 128)])
def test_wm_fc_layer_bf16_equals_reference(tt, din, dout):
    """The ``stream`` interpreter's FC layer on bf16 weights: each product
    in f32 rounded once to bf16, then the bf16 LIF, as the reference's scan."""
    rng = np.random.default_rng(tt * din + dout)
    s = jnp.asarray(rng.random((tt, din)) < 0.5, jnp.bfloat16)
    w = jnp.asarray((rng.random((din, dout)) < 0.5) * rng.normal(size=(din, dout))
                    * 0.2, jnp.bfloat16)
    lif = [jnp.asarray(a, jnp.bfloat16) for a in (
        rng.normal(size=dout) + 1, rng.uniform(0.5, 1.5, dout),
        rng.uniform(0.3, 1.2, dout))]
    sp_r, v_r = ref_wm_fc_layer(s, w, RefLIF(*lif))
    sp, v = wm_fc_layer(bf(s), bf(w), LIFParams(*(bf(a) for a in lif)))
    assert_bits(sp, sp_r)
    assert_bits(v, v_r)
    assert 0 < float(sp.float().mean()) < 1


def test_bf16_sigmoid_and_its_promotion_match_the_reference():
    """alpha in bf16 rounds every op; promoted against an f32 membrane in
    the reference's traced step, the last divide stays f32."""
    rng = np.random.default_rng(7)
    n = 2048
    logit = jnp.asarray(rng.normal(size=(n, 1)) * 2 + 2, jnp.bfloat16)
    big = jnp.full((n, 1), 100.0, jnp.bfloat16)       # no spike, no reset
    ref = RefLIF(logit, big, big)
    port = LIFParams(bf(logit), bf(big), bf(big))
    assert_bits(port.alpha, ref.alpha)
    # zero currents isolate alpha's value: XLA contracts an f32 alpha * v + c
    # into one FMA on the CPU, where the port (and its kernels) round the
    # product, so with currents a membrane may differ by one f32 ulp
    v = rng.normal(size=(n, 8)).astype(np.float32)
    zero = np.zeros_like(v)
    want, _ = jax.jit(ref_lif_step)(jnp.asarray(v), jnp.asarray(zero), ref)
    got, _ = lif_step(t(v), t(zero), port)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = rng.normal(size=(n, 8)).astype(np.float32)
    vb, cb = jnp.asarray(v, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16)
    want, _ = jax.jit(ref_lif_step)(vb, cb, ref)
    assert_bits(lif_step(bf(vb), bf(cb), port)[0], want)


def test_init_snn_bf16_casts_the_f32_draw():
    p32, p16 = init_snn(3, SMALL), init_snn(3, SMALL, dtype=BF16)
    ref = ref_init_snn(jax.random.PRNGKey(0), SMALL_REF, dtype=jnp.bfloat16)
    for g in ("conv", "fc"):
        for a, b, r in zip(p32[g], p16[g], ref[g]):
            assert b["w"].dtype == BF16
            assert torch.equal(b["w"], a["w"].to(BF16))
            for f in ("alpha_logit", "theta", "v_th"):
                assert_bits(getattr(b["lif"], f), getattr(r["lif"], f))


def test_convert_keeps_each_leaf_dtype():
    ref = ref_init_snn(jax.random.PRNGKey(1), SMALL_REF, dtype=jnp.bfloat16)
    port = params_from_numpy(params_to_numpy(ref))
    assert_bits(port["fc"][0]["w"], ref["fc"][0]["w"])
    assert_bits(port["conv"][1]["lif"].v_th, ref["conv"][1]["lif"].v_th)
    tree32 = {g: [{"w": f32(lp["w"]), "lif": {
        f: f32(getattr(lp["lif"], f)) for f in ("alpha_logit", "theta", "v_th")}}
        for lp in ref[g]] for g in ("conv", "fc")}
    port32 = params_from_numpy(tree32)
    assert port32["conv"][0]["w"].dtype == torch.float32
    np.testing.assert_array_equal(port32["conv"][0]["w"].numpy(),
                                  tree32["conv"][0]["w"])


# ---------------------------------------------------------------------------
# The whole model in bf16, every backend pair.
# ---------------------------------------------------------------------------

def _frames(cfg, seed, batch):
    rng = np.random.default_rng(100 + seed)
    return (rng.random((batch, cfg.timesteps, cfg.conv_specs[0][1],
                        cfg.input_width)) < 0.5).astype(np.float32)


MODEL_CASES = [  # (config, masks dtype, LIF spread, seed)
    ("small", None, False, 0),
    ("small", jnp.bfloat16, True, 1),
    ("small", jnp.float32, True, 2),     # f32 masks promote the weights
    ("paper", jnp.bfloat16, False, 0),
]


@pytest.mark.parametrize("cfg_name,mask_dtype,trained,seed", MODEL_CASES)
@pytest.mark.parametrize("port,ref", BACKENDS)
def test_bf16_model_matches_reference_backend(port, ref, cfg_name, mask_dtype,
                                              trained, seed):
    ref_cfg, cfg = (SMALL_REF, SMALL) if cfg_name == "small" else (PAPER_REF, PAPER)
    params, masks, tparams, tmasks = setup_bf16(ref_cfg, seed, mask_dtype, trained)
    frames_b = _frames(cfg, seed, 4)
    ref_program, program = ref_compile_snn(ref_cfg), compile_snn(cfg)
    want = ref_program.apply_batch(params, jnp.asarray(frames_b), ref, masks=masks)
    got = program.apply_batch(tparams, frames_b, port, masks=tmasks, device="cpu")
    assert_logits(got, want)
    if port == "stream":   # one sample through apply, with the counters
        want1, wc = ref_program.apply(params, jnp.asarray(frames_b[0]), ref,
                                      masks=masks, return_counters=True)
        got1, gc = program.apply(tparams, frames_b[0], port, masks=tmasks,
                                 return_counters=True, device="cpu")
        assert_logits(got1, want1)
        assert set(gc) == set(wc)
        for layer in wc:
            for k in COUNTER_KEYS:
                assert float(gc[layer][k]) == float(wc[layer][k]), (layer, k)


@pytest.mark.parametrize("port,ref", [("goap", "goap"), ("stream", "stream"),
                                      ("cuda_fused", "pallas_fused")])
def test_bf16_plan_batch_matches_reference_plan(port, ref):
    """The plans' batched executors: the streaming loop, and for
    ``cuda_fused`` the whole-network kernel, which casts its operands and
    so returns f32 logits, as the reference's does."""
    params, masks, tparams, tmasks = setup_bf16(SMALL_REF, 4, jnp.bfloat16, True)
    frames_b = _frames(SMALL, 4, 4)
    want = ref_compile_plan(ref_compile_snn(SMALL_REF), params, masks=masks,
                            assignment=ref).batch(jnp.asarray(frames_b))
    plan = compile_plan(compile_snn(SMALL), tparams, masks=tmasks,
                        assignment=port, device="cpu")
    got = plan.batch(t(frames_b))
    assert_logits(got, want)
    assert (got.dtype == torch.float32) == (port == "cuda_fused")


def test_bf16_model_and_its_upcast_never_share_a_plan():
    params = init_snn(0, SMALL, dtype=BF16)
    up = {g: [{"w": lp["w"].float(), "lif": LIFParams(
        lp["lif"].alpha_logit.float(), lp["lif"].theta.float(),
        lp["lif"].v_th.float())} for lp in params[g]] for g in ("conv", "fc")}
    program = compile_snn(SMALL)
    for backend in ("goap", "cuda_fused"):
        p16 = compile_plan(program, params, assignment=backend, device="cpu")
        p32 = compile_plan(program, up, assignment=backend, device="cpu")
        assert p16 is not p32 and p16.digest != p32.digest
        assert compile_plan(program, params, assignment=backend,
                            device="cpu") is p16
    frames_b = t(_frames(SMALL, 5, 3))
    # the layered paths keep bf16 on the bf16 model, f32 on its upcast
    assert compile_plan(program, params, assignment="dense",
                        device="cpu").bound.batch(frames_b).dtype == BF16
    assert compile_plan(program, up, assignment="dense",
                        device="cpu").bound.batch(frames_b).dtype == torch.float32
    # the fused kernel casts: bf16 weights serve exactly their upcast
    fused16 = compile_plan(program, params, assignment="cuda_fused", device="cpu")
    fused32 = compile_plan(program, up, assignment="cuda_fused", device="cpu")
    assert torch.equal(fused16.batch(frames_b), fused32.batch(frames_b))


# ---------------------------------------------------------------------------
# Serving a bf16 model.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port,ref", [("goap", "goap"), ("cuda", "pallas")])
def test_bf16_engines_match_the_reference_sync_engine(port, ref):
    params, masks, tparams, tmasks = setup_bf16(SMALL_REF, 6, jnp.bfloat16, True)
    iq = np.random.default_rng(6).normal(
        size=(32, SMALL.conv_specs[0][1], SMALL.input_width)).astype(np.float32)
    want = RefSync(params, SMALL_REF, masks, batch_size=8, backend=ref).classify(iq)
    sync = AMCServeEngine(tparams, SMALL, tmasks, batch_size=8, backend=port,
                          device="cpu")
    np.testing.assert_array_equal(sync.classify(iq), want)
    with AsyncAMCServeEngine(tparams, SMALL, tmasks, backend=port, max_batch=8,
                             device="cpu") as engine:
        got = np.array([f.result(timeout=60) for f in
                        [engine.submit(frame) for frame in iq]])
        logits = engine.step(iq[:8])
    np.testing.assert_array_equal(got, want)
    # bf16 logits reach the host widened to f32, values unchanged
    assert logits.dtype == np.float32
    want_logits = ref_compile_plan(ref_compile_snn(SMALL_REF), params, masks=masks,
                                   assignment=ref).bound.batch(
        jnp.asarray(sigma_delta_encode_np(iq[:8], SMALL.timesteps)))
    assert want_logits.dtype == jnp.bfloat16
    np.testing.assert_array_equal(logits, f32(want_logits))


def test_lif_op_refuses_parameters_wider_than_bf16_currents():
    from repro_torch.kernels.ops import lif_op

    with pytest.raises(TypeError, match="float32 against torch.bfloat16"):
        lif_op(torch.zeros(2, 3, dtype=BF16), init_lif_params((3,)))
