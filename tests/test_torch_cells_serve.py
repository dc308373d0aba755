"""The port's prefill and decode cells against the reference's, on the
CPU at the reduced configs, with the tolerances (and llama4-scout's f32
prefill) set out in ``tests/test_torch_cells.py``, whose helpers this
file shares."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro.models.lm import init_decode_state as ref_init_decode_state
from repro.models.whisper import (init_whisper_decode_state as
                                  ref_init_whisper_decode_state)
from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.convert import lm_params_from_numpy, lm_state_from_numpy
from repro_torch.launch import steps
from repro_torch.tree import tree_leaves

from test_torch_cells import (DECODE, F32_ARCHS, LOGITS_TOL, PREFILL,
                              _check_state, batches, port_mesh, port_np,
                              ref_mesh, ref_params, scaled_gap, to_np)

@pytest.fixture(autouse=True)
def short_whisper_encoder(monkeypatch):
    """Whisper's cells at a 128-frame encoder stub on both sides (the
    cells read WHISPER_S_ENC, 2048, when they are built), so its reduced
    config runs in seconds on the CPU."""
    monkeypatch.setattr(ref_steps, "WHISPER_S_ENC", 128)
    monkeypatch.setattr(steps, "WHISPER_S_ENC", 128)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_cell_matches_the_reference(arch):
    rcfg, cfg = ref_registry.reduced_config(arch), reduced_config(arch)
    params = ref_params(rcfg, jnp.float32 if arch in F32_ARCHS else jnp.bfloat16)
    rb, pb = batches(rcfg, PREFILL, seed=1)
    want_logits, want_state = ref_steps._prefill_cell(
        arch, PREFILL, rcfg, ref_mesh()).jitted()(params, rb)
    got_logits, got_state = steps._prefill_cell(
        arch, PREFILL, cfg, port_mesh()).jitted("cpu")(
        lm_params_from_numpy(to_np(params)), pb)
    assert tuple(got_logits.shape) == tuple(want_logits.shape)
    assert scaled_gap(port_np(got_logits)[..., :cfg.vocab],
                      np.asarray(want_logits, np.float32)[..., :cfg.vocab]) <= LOGITS_TOL
    _check_state(got_state, want_state)


def _random_state(state, rng, ctx):
    """A reference decode state's layout filled with seeded values: caches
    half full (``len = ctx // 2``), positive int8 scales."""
    def fill(path, leaf):
        name = str(getattr(path[-1], "key", getattr(path[-1], "idx", "")))
        if name == "len":
            return jnp.full(leaf.shape, ctx // 2, leaf.dtype)
        if leaf.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, leaf.shape), jnp.int8)
        vals = rng.normal(size=leaf.shape).astype(np.float32)
        if name.endswith("_scale"):
            vals = np.abs(vals) * 0.01 + 1e-3
        return jnp.asarray(vals * 0.5, leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, state)


@pytest.mark.parametrize("arch,kv_int8", [
    (a, q) for a in ARCH_IDS for q in (False, True)
    if not (q and a == "whisper-large-v3")])    # whisper has no int8 cache
def test_decode_cell_matches_the_reference(arch, kv_int8):
    rcfg, cfg = ref_registry.reduced_config(arch), reduced_config(arch)
    b, ctx = DECODE.global_batch, DECODE.seq_len
    params = ref_params(rcfg, jnp.bfloat16)
    if rcfg.family == "encdec":
        state = ref_init_whisper_decode_state(rcfg, b, ctx, ref_steps.WHISPER_S_ENC)
    else:
        state = ref_init_decode_state(rcfg, b, ctx, kv_int8=kv_int8)
    state = _random_state(state, np.random.default_rng(2), ctx)
    token = np.random.default_rng(3).integers(0, rcfg.vocab, (b, 1)).astype(np.int32)
    port_state = lm_state_from_numpy(to_np(state))
    port_params = lm_params_from_numpy(to_np(params))
    want_logits, want_state = ref_steps._decode_cell(
        arch, DECODE, rcfg, ref_mesh(), kv_int8=kv_int8).jitted()(
        params, state, jnp.asarray(token))
    got_logits, got_state = steps._decode_cell(
        arch, DECODE, cfg, port_mesh(), kv_int8=kv_int8).jitted("cpu")(
        port_params, port_state, torch.from_numpy(token))
    assert scaled_gap(port_np(got_logits)[..., :cfg.vocab],
                      np.asarray(want_logits, np.float32)[..., :cfg.vocab]) <= LOGITS_TOL
    _check_state(got_state, want_state)
    # the donated state came back as the step's buffers, not the input
    assert all(g is not p for g, p in zip(tree_leaves(got_state),
                                          tree_leaves(port_state)))
