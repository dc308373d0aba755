"""The port's Algorithm-2 interpreter and ``stream`` backend, held to the
live reference (CPU).

Spikes and counters exactly, membranes and logits within atol 1e-5,
against ``repro``'s ``schedule_interpreter`` and its ``stream`` backend;
the port's ``cuda_fused`` plain-path counters equal to the port's
``stream`` counters.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import PAPER, PAPER_REF, SMALL, SMALL_REF, setup, spike_frames, t
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.api import compile_snn as ref_compile_snn
from repro.core import lif as ref_lif
from repro.core import saocds as ref_saocds
from repro.core.sparse_format import build_schedule as ref_build_schedule
from repro.core.sparse_format import coo_from_dense as ref_coo_from_dense
from repro.models.graph import stream_totals as ref_stream_totals
from repro_torch.api import compile_plan, compile_snn
from repro_torch.core.lif import init_lif_params
from repro_torch.core.saocds import (
    channel_slots,
    make_schedule_step,
    saocds_conv_layer,
    schedule_interpreter,
    sw_conv_layer,
    wm_fc_layer,
)
from repro_torch.core.sparse_format import (
    ITER_COMPUTE,
    Schedule,
    build_schedule,
    coo_from_dense,
    weight_mask_from_dense,
)
from repro_torch.models.graph import stream_totals

COUNTER_KEYS = ("reps_per_timestep", "compute_iters", "extra_iters",
                "empty_iters", "accumulations", "timesteps")

# (seed, kw, ic, oc, wi, t, weight density): densities down to 0.02 force
# extra and empty iterations and channels of very different lengths
LAYER_CASES = [
    (0, 3, 2, 4, 12, 3, 0.5),
    (1, 1, 1, 1, 5, 1, 1.0),
    (2, 4, 5, 7, 16, 4, 0.02),
    (3, 3, 4, 6, 9, 2, 0.1),
    (4, 2, 3, 5, 8, 4, 1.0),
    (5, 4, 5, 3, 14, 3, 0.1),
    (6, 11, 2, 16, 138, 2, 0.5),     # conv1 of the paper model
]


def _layer_case(seed, kw, ic, oc, wi, t_steps, wd):
    rng = np.random.default_rng(seed)
    k = ((rng.random((kw, ic, oc)) < wd)
         * rng.normal(size=(kw, ic, oc))).astype(np.float32)
    frames = (rng.random((t_steps, ic, wi)) < 0.5).astype(np.float32)
    return k, frames


def _lifs(oc):
    kw = dict(alpha=0.8, theta=0.9, v_th=0.5)
    return ref_lif.init_lif_params((oc, 1), **kw), init_lif_params((oc, 1), **kw)


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: f"seed{c[0]}")
def test_schedule_interpreter_matches_reference(case):
    seed, kw, ic, oc, wi, t_steps, wd = case
    k, frames = _layer_case(*case)
    sched = build_schedule(coo_from_dense(k))
    ref_sched = ref_build_schedule(ref_coo_from_dense(k))
    rlif, tlif = _lifs(oc)
    oi = wi - kw + 1
    want_out, want_v, want_c = ref_saocds.schedule_interpreter(
        jnp.asarray(frames), ref_sched, rlif, oi, oc)
    got_out, got_v, got_c = schedule_interpreter(t(frames), sched, tlif, oi, oc)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5,
                               rtol=0)
    for key in COUNTER_KEYS:
        assert int(got_c[key]) == int(np.asarray(want_c[key])), key
    assert got_c["accumulations"].dtype == torch.float32


@pytest.mark.parametrize("case", LAYER_CASES[:4], ids=lambda c: f"seed{c[0]}")
def test_schedule_interpreter_batched_equals_per_sample(case):
    seed, kw, ic, oc, wi, t_steps, wd = case
    k, _ = _layer_case(*case)
    sched = build_schedule(coo_from_dense(k))
    _, tlif = _lifs(oc)
    frames = spike_frames(seed + 100, (t_steps, 3, ic, wi))
    oi = wi - kw + 1
    outs, v, counts = schedule_interpreter(t(frames), sched, tlif, oi, oc)
    for b in range(3):
        o1, v1, c1 = schedule_interpreter(t(frames[:, b]), sched, tlif, oi, oc)
        assert torch.equal(outs[:, b], o1) and torch.equal(v[b], v1)
        assert float(counts["accumulations"][b]) == float(c1["accumulations"])


def test_channel_slots_keep_every_touching_entry_in_order():
    k, _ = _layer_case(*LAYER_CASES[2])
    sched = build_schedule(coo_from_dense(k))
    oc = k.shape[2]
    slots = channel_slots(sched, oc)
    assert sched.n_empty > 0 and sched.n_extra > 0   # the case covers both
    for c in range(oc):
        entries = np.nonzero(sched.oc == c)[0]
        n = entries.size
        assert slots.valid[c, :n].all() and not slots.valid[c, n:].any()
        np.testing.assert_array_equal(slots.is_compute[c, :n],
                                      sched.kind[entries] == ITER_COMPUTE)
        np.testing.assert_array_equal(slots.emit[c, :n], sched.emit[entries])
        assert slots.first_touch[c, 0] and not slots.first_touch[c, 1:].any()
        assert (slots.weight[c, n:] == 0).all()
    assert slots.n_slots == max(int((sched.oc == c).sum()) for c in range(oc))


def test_untouched_channel_never_decays_or_fires():
    """A channel with no schedule entry keeps its membrane and stays silent;
    a channel that ends early is left alone by the padding slots."""
    sched = Schedule(
        kind=np.array([0, 0, 0], np.int32),
        weight=np.array([2.0, 1.0, 0.5], np.float32),
        oc=np.array([0, 0, 2], np.int32), ic=np.zeros(3, np.int32),
        ci=np.zeros(3, np.int32), emit=np.array([False, True, True]),
        n_compute=3, n_extra=0, n_empty=0)
    lif = init_lif_params((3, 1), alpha=0.5, theta=1.0, v_th=1.0)
    step = make_schedule_step(sched, lif, 3)
    v0 = torch.full((3, 4), 0.75)
    ifm = torch.ones((1, 4))
    v, (out, acc) = step(v0, ifm)
    np.testing.assert_allclose(v[1].numpy(), 0.75)           # untouched
    assert not out[1].any()
    np.testing.assert_allclose(v[0].numpy(), 0.375 + 3.0 - 1.0)
    np.testing.assert_allclose(v[2].numpy(), 0.375 + 0.5)
    assert out[0].all() and not out[2].any()
    assert int(acc) == 12


@pytest.mark.parametrize("case", LAYER_CASES[:4], ids=lambda c: f"seed{c[0]}")
def test_vectorized_layers_match_reference(case):
    seed, kw, ic, oc, wi, t_steps, wd = case
    k, frames = _layer_case(*case)
    rlif, tlif = _lifs(oc)
    want, want_v = ref_saocds.saocds_conv_layer(
        jnp.asarray(frames), ref_coo_from_dense(k), rlif)
    got, got_v = saocds_conv_layer(t(frames), coo_from_dense(k), tlif)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)
    want, want_v = ref_saocds.sw_conv_layer(jnp.asarray(frames),
                                            jnp.asarray(k), rlif)
    got, got_v = sw_conv_layer(t(frames), torch.from_numpy(k), tlif)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)
    # the weight-masked FC layer over the flattened frames
    rng = np.random.default_rng(seed)
    w = ((rng.random((ic * wi, oc)) < 0.5)
         * rng.normal(size=(ic * wi, oc))).astype(np.float32)
    x = frames.reshape(t_steps, -1)
    r_fc = ref_lif.init_lif_params((oc,), alpha=0.8, theta=0.9, v_th=0.5)
    t_fc = init_lif_params((oc,), alpha=0.8, theta=0.9, v_th=0.5)
    want, want_v = ref_saocds.wm_fc_layer(
        jnp.asarray(x), ref_saocds.WeightMask(w, w != 0), r_fc)
    got, got_v = wm_fc_layer(t(x), weight_mask_from_dense(w), t_fc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)


def _stream_pair(ref_cfg, cfg, seed, density):
    params, masks, tparams, tmasks = setup(ref_cfg, seed, density)
    frames = spike_frames(seed, (cfg.timesteps, cfg.conv_specs[0][1],
                                 cfg.input_width))
    want_l, want_c = ref_compile_snn(ref_cfg).apply(
        params, jnp.asarray(frames), "stream", masks=masks,
        return_counters=True)
    return tparams, tmasks, frames, np.asarray(want_l), want_c


def _assert_counters(got, want):
    assert set(got) == set(want)
    for name in want:
        for key in COUNTER_KEYS:
            assert int(got[name][key]) == int(np.asarray(want[name][key])), \
                f"{name}.{key}"


@pytest.mark.parametrize("seed,density", [(0, 0.5), (1, 0.3), (2, 0.05)])
def test_stream_backend_matches_reference(seed, density):
    tparams, tmasks, frames, want_l, want_c = _stream_pair(
        SMALL_REF, SMALL, seed, density)
    program = compile_snn(SMALL)
    got_l, got_c = program.apply(tparams, frames, "stream", masks=tmasks,
                                 return_counters=True, device="cpu")
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=1e-5, rtol=0)
    _assert_counters(got_c, want_c)
    plan = compile_plan(program, tparams, masks=tmasks, assignment="stream",
                        device="cpu")
    streamed, counters = plan.run_streaming(t(frames))
    np.testing.assert_allclose(streamed.numpy(), want_l, atol=1e-5, rtol=0)
    _assert_counters(counters, want_c)
    assert plan.supports_live_counters
    logits, accs = plan.batch_counters(t(frames[None]))
    np.testing.assert_allclose(logits[0].numpy(), want_l, atol=1e-5, rtol=0)
    for name in want_c:
        assert float(accs[name][0]) == float(np.asarray(
            want_c[name]["accumulations"]))
    # whole-network totals
    want_tot = ref_stream_totals(want_c)
    got_tot = stream_totals(got_c)
    for key in want_tot:
        assert int(got_tot[key]) == int(np.asarray(want_tot[key])), key


def test_stream_backend_matches_reference_paper_config():
    tparams, tmasks, frames, want_l, want_c = _stream_pair(
        PAPER_REF, PAPER, 0, 0.5)
    plan = compile_plan(compile_snn(PAPER), tparams, masks=tmasks,
                        assignment="stream", device="cpu")
    got_l, got_c = plan.run_layered(t(frames))
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=1e-5, rtol=0)
    _assert_counters(got_c, want_c)
    # the fused operands' plain path counts the same events
    fused = compile_plan(compile_snn(PAPER), tparams, masks=tmasks,
                         assignment="cuda_fused", device="cpu")
    _, fused_c = fused.run_streaming(t(frames))
    _assert_counters(fused_c, want_c)


@pytest.mark.parametrize("seed", range(3))
def test_cuda_fused_plain_counters_equal_stream_counters(seed):
    _, _, tparams, tmasks = setup(SMALL_REF, seed, 0.5)
    frames_b = t(spike_frames(seed, (5, SMALL.timesteps, SMALL.conv_specs[0][1],
                                     SMALL.input_width)))
    program = compile_snn(SMALL)
    stream = compile_plan(program, tparams, masks=tmasks, assignment="stream",
                          device="cpu")
    fused = compile_plan(program, tparams, masks=tmasks,
                         assignment="cuda_fused", device="cpu")
    s_logits, s_accs = stream.batch_counters(frames_b)
    f_logits, f_accs = fused.batch_counters(frames_b)
    assert set(s_accs) == set(f_accs)
    for name in s_accs:
        assert torch.equal(s_accs[name], f_accs[name]), name
    torch.testing.assert_close(s_logits, f_logits, atol=1e-5, rtol=0)


def test_batch_counters_of_a_plan_without_counters_is_empty():
    """As in the reference: the logits of the streaming executor and no
    counter for backends that count nothing."""
    _, _, tparams, tmasks = setup(SMALL_REF, 0, 0.5)
    plan = compile_plan(compile_snn(SMALL), tparams, masks=tmasks,
                        assignment="goap", device="cpu")
    assert not plan.supports_live_counters
    frames_b = t(spike_frames(4, (2, SMALL.timesteps, 2, SMALL.input_width)))
    logits, accs = plan.batch_counters(frames_b)
    assert accs == {}
    torch.testing.assert_close(logits, plan.batch(frames_b), atol=1e-5, rtol=0)


def test_fused_conv_order_fires_what_the_stream_and_layered_paths_fire():
    """Frame 213 of 256 seeded paper-model requests puts a conv1 membrane
    within rounding of its threshold: summed in another order than the
    schedule's ic-major one, the fused plain path fired a spike the
    ``stream`` and layer-by-layer paths do not (179 more conv2 events)."""
    from repro_torch.api import init_snn, make_mask_pytree
    from repro_torch.data.pipeline import sigma_delta_encode_batch

    params = init_snn(0, PAPER)
    masks = make_mask_pytree(params, 0.5)
    iq = np.random.default_rng(0).normal(size=(256, 2, 128)).astype(np.float32)
    frames = sigma_delta_encode_batch(torch.from_numpy(iq[213:214]),
                                      PAPER.timesteps)
    program = compile_snn(PAPER)
    fused = compile_plan(program, params, masks=masks, assignment="cuda_fused",
                         device="cpu")
    stream = compile_plan(program, params, masks=masks, assignment="stream",
                          device="cpu")
    f_logits, f_accs = fused.batch_counters(frames)
    s_logits, s_accs = stream.batch_counters(frames)
    for name in s_accs:
        assert torch.equal(f_accs[name], s_accs[name]), name
    assert torch.equal(f_logits, fused.bound.batch(frames))
    assert torch.equal(f_logits, s_logits)
