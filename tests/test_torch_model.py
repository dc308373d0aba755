"""Port backends and plans held to the live reference (CPU).

Each port backend against the same reference backend (``cuda`` is the
port of ``pallas``, ``cuda_fused`` of ``pallas_fused``) within atol 1e-5;
the fused counters equal to the reference ``stream`` backend's exactly;
one paper-config pin against the live reference, never against the
golden literals.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import PAPER, PAPER_REF, SMALL, SMALL_REF, setup, spike_frames, t
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.api import compile_plan as ref_compile_plan, compile_snn as ref_compile_snn
from repro_torch.api import PlanCache, compile_plan, compile_snn
from repro_torch.models.graph import artifact_build_count

BACKENDS = [("dense", "dense"), ("goap", "goap"), ("cuda", "pallas"),
            ("cuda_fused", "pallas_fused")]
COUNTER_KEYS = ("reps_per_timestep", "compute_iters", "extra_iters",
                "empty_iters", "accumulations", "timesteps")


def _frames(cfg, seed, batch=None):
    shape = (cfg.timesteps, cfg.conv_specs[0][1], cfg.input_width)
    return spike_frames(seed, shape if batch is None else (batch,) + shape)


@pytest.mark.parametrize("seed,density", [(0, 0.3), (1, 0.6), (2, 0.5)])
@pytest.mark.parametrize("port,ref", BACKENDS)
def test_backend_logits_match_reference_backend(port, ref, seed, density):
    params, masks, tparams, tmasks = setup(SMALL_REF, seed, density)
    frames = _frames(SMALL, seed)
    want = np.asarray(ref_compile_snn(SMALL_REF).apply(
        params, jnp.asarray(frames), ref, masks=masks))
    program = compile_snn(SMALL)
    got = program.apply(tparams, frames, port, masks=tmasks, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    plan = compile_plan(program, tparams, masks=tmasks, assignment=port,
                        device="cpu")
    # run_streaming ≡ run_layered ≡ reference
    streamed, _ = plan.run_streaming(t(frames))
    np.testing.assert_allclose(streamed.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("port,ref", BACKENDS)
def test_batch_paths_match_reference_batch(port, ref):
    params, masks, tparams, tmasks = setup(SMALL_REF, 3, 0.5)
    frames_b = _frames(SMALL, 3, batch=4)
    want = np.asarray(ref_compile_snn(SMALL_REF).apply_batch(
        params, jnp.asarray(frames_b), ref, masks=masks))
    plan = compile_plan(compile_snn(SMALL), tparams, masks=tmasks,
                        assignment=port, device="cpu")
    for fn in (plan.batch, plan.bound.batch, plan.preferred_batch()):
        np.testing.assert_allclose(fn(t(frames_b)).numpy(), want, atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("seed", range(3))
def test_fused_counters_equal_reference_stream_backend(seed):
    params, masks, tparams, tmasks = setup(SMALL_REF, seed, 0.5)
    frames = _frames(SMALL, seed)
    _, want = ref_compile_snn(SMALL_REF).apply(
        params, jnp.asarray(frames), "stream", masks=masks,
        return_counters=True)
    plan = compile_plan(compile_snn(SMALL), tparams, masks=tmasks,
                        assignment="cuda_fused", device="cpu")
    _, got = plan.run_streaming(t(frames))
    assert set(got) == set(want)
    for name in want:
        for key in COUNTER_KEYS:
            assert int(got[name][key]) == int(np.asarray(want[name][key])), \
                f"{name}.{key}"
    # the batched counter path carries the same accumulations
    _, accs = plan.batch_counters(t(frames[None]))
    for name in want:
        assert int(accs[name][0]) == int(np.asarray(want[name]["accumulations"]))


def test_paper_config_pin_against_live_reference():
    """SNNConfig() at 50% density: cuda_fused logits against the reference
    dense backend, conv_accs against the reference stream counters."""
    params, masks, tparams, tmasks = setup(PAPER_REF, 0, 0.5)
    frames = _frames(PAPER, 0)
    ref_program = ref_compile_snn(PAPER_REF)
    want = np.asarray(ref_program.apply(params, jnp.asarray(frames), "dense",
                                        masks=masks))
    plan = compile_plan(compile_snn(PAPER), tparams, masks=tmasks,
                        assignment="cuda_fused", device="cpu")
    logits, counters = plan.run_streaming(t(frames))
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-5, rtol=0)
    ref_plan = ref_compile_plan(ref_program, params, masks=masks,
                                assignment="stream")
    _, want_counters = ref_plan.run_streaming(jnp.asarray(frames))
    assert set(counters) == set(want_counters)
    for name in want_counters:
        for key in COUNTER_KEYS:
            assert int(counters[name][key]) == \
                int(np.asarray(want_counters[name][key])), f"{name}.{key}"


def test_plan_cache_returns_same_plan_and_builds_once():
    _, _, tparams, tmasks = setup(SMALL_REF, 4, 0.5)
    cache = PlanCache()
    program = compile_snn(SMALL)
    first = compile_plan(program, tparams, masks=tmasks, assignment="cuda_fused",
                         cache=cache, device="cpu")
    builds = artifact_build_count()
    again = compile_plan(program, tparams, masks=tmasks, assignment="cuda_fused",
                         cache=cache, device="cpu")
    assert again is first
    assert artifact_build_count() == builds
    assert cache.stats["plan_hits"] == 1
    # another backend on the same weights reuses the layer artifacts
    compile_plan(program, tparams, masks=tmasks, assignment="cuda", cache=cache,
                 device="cpu")
    assert artifact_build_count() == builds
    assert first.fused_stack() is first.fused_stack()


def test_assignment_and_device_validation():
    _, _, tparams, tmasks = setup(SMALL_REF, 0, 0.5)
    program = compile_snn(SMALL)
    with pytest.raises(ValueError, match="unknown backend"):
        compile_plan(program, tparams, assignment="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown layers"):
        compile_plan(program, tparams, assignment={"conv9": "cuda"},
                     device="cpu")
    mixed = compile_plan(program, tparams, masks=tmasks,
                         assignment={"conv1": "cuda_fused"},
                         default_backend="goap", device="cpu")
    assert mixed.fused_stack() is None    # partial assignment: no fusion
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_plan(program, tparams, masks=tmasks, assignment="dense")
