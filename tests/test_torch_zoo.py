"""The port's language-model zoo against the live reference, on the CPU.

Every architecture of ``ARCH_IDS`` at its reduced config: the reference's
params (``repro.models.lm.init_lm`` / ``init_whisper`` with a jax key)
reach the port through ``repro_torch.convert.lm_params_from_numpy``, and
both packages run the same numpy inputs.  Each arch's reference params and
outputs are built once per module (``case``).

Tolerances (f32 throughout unless a bf16 state is named):
* forward logits: atol 1e-4, rtol 1e-4;
* ``lm_loss`` / ``whisper_loss``: 1e-5 relative;
* gradients: every leaf within 1e-4 in relative norm (``|g - g_ref| /
  |g_ref|``), except the leaves whose gradient is zero in exact
  arithmetic (``exact_zero_grad``), where both sides must be noise below 1e-6
  of the whole gradient's norm;
* prefill logits and every cache leaf: atol 1e-4, rtol 1e-4;
* one decode step from the same bf16 state: 2e-2 (the reference's own
  serving tolerance);
* the port's own prefill + decode against its forward: 2e-2, MoE at
  capacity factor 8.0, as ``tests/test_arch_smoke.py`` checks the
  reference;
* int8 KV codes within one quantization step of the reference's, scales
  within 1e-6 relative, decode logits within 0.1 of the f32-state decode.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as ref_registry
from repro.data.pipeline import lm_token_batches as ref_token_batches
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import whisper as ref_whisper
from repro_torch import configs as port_configs
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, lm_state_from_numpy
from repro_torch.data.pipeline import lm_token_batches
from repro_torch.models import layers, lm, whisper
from repro_torch.tree import tree_leaves, tree_unflatten

from _torch_parity import exact_zero_grad, leaf_names

B, S = 2, 16
ARCHS = registry.ARCH_IDS
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_TOL = dict(atol=2e-2, rtol=2e-2)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_np(x):
    """A port tensor as numpy (bf16 through f32)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def f32(x):
    return np.asarray(x).astype(np.float32)


def _bf16_state(tree):
    """A reference decode state with every float leaf cast to bf16."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    cfg_ref = ref_registry.reduced_config(arch)
    cfg = registry.reduced_config(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    if cfg.family == "encdec":
        ref_params = ref_whisper.init_whisper(key, cfg_ref, max_dec_pos=4 * S)
    else:
        ref_params = ref_lm.init_lm(key, cfg_ref)
    port_params = lm_params_from_numpy(to_np(ref_params))
    return dict(arch=arch, cfg=cfg, cfg_ref=cfg_ref, toks=toks, labels=labels,
                extra=extra, ref_params=ref_params, port_params=port_params)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def ref_forward(c, params=None):
    params = c["ref_params"] if params is None else params
    if c["cfg"].family == "encdec":
        return ref_whisper.whisper_forward(params, _j(c["extra"]),
                                           _j(c["toks"]), c["cfg_ref"])
    return ref_lm.lm_forward(params, _j(c["toks"]), c["cfg_ref"],
                             patch_embeds=_j(c["extra"]))


def port_forward(c, params=None):
    params = c["port_params"] if params is None else params
    if c["cfg"].family == "encdec":
        return whisper.whisper_forward(params, _t(c["extra"]), _t(c["toks"]),
                                       c["cfg"])
    return lm.lm_forward(params, _t(c["toks"]), c["cfg"],
                         patch_embeds=_t(c["extra"]))


def ref_loss_fn(c):
    def loss(p):
        if c["cfg"].family == "encdec":
            return ref_whisper.whisper_loss(p, _j(c["extra"]), _j(c["toks"]),
                                            _j(c["labels"]), c["cfg_ref"])
        return ref_lm.lm_loss(p, _j(c["toks"]), _j(c["labels"]), c["cfg_ref"],
                              patch_embeds=_j(c["extra"]))
    return loss


def port_loss(c, params):
    if c["cfg"].family == "encdec":
        return whisper.whisper_loss(params, _t(c["extra"]), _t(c["toks"]),
                                    _t(c["labels"]), c["cfg"])
    return lm.lm_loss(params, _t(c["toks"]), _t(c["labels"]), c["cfg"],
                      patch_embeds=_t(c["extra"]))


# ---------------------------------------------------------------------------
# configs, registry, token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for fn in ("get_config", "reduced_config"):
        got = getattr(registry, fn)(arch)
        want = getattr(ref_registry, fn)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), fn
        assert got.param_count() == want.param_count()
        assert got.param_count(active_only=True) == want.param_count(active_only=True)
        for prop in ("hd", "padded_vocab", "padded_experts", "is_subquadratic",
                     "has_decode"):
            assert getattr(got, prop) == getattr(want, prop), prop


def test_registry_equals_the_reference():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert registry.all_cells() == ref_registry.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in registry.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_registry.SHAPES.items()}
    assert [registry.cell_applicable(a, "long_500k") for a in ARCHS] == \
        [ref_registry.cell_applicable(a, "long_500k") for a in ARCHS]
    # the package exports the reference's names
    for name in ("ARCH_IDS", "SHAPES", "get_config", "reduced_config",
                 "all_cells", "cell_applicable"):
        assert getattr(port_configs, name) is getattr(registry, name)


@pytest.mark.parametrize("vocab,seed", [(128, 1), (151936, 7)])
def test_lm_token_batches_equal_the_reference(vocab, seed):
    got, want = lm_token_batches(4, 32, vocab, seed), ref_token_batches(4, 32, vocab, seed)
    for _ in range(3):
        (gt, gl), (wt, wl) = next(got), next(want)
        assert gt.dtype == wt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


def test_params_cross_with_their_dtypes():
    rng = np.random.default_rng(2)
    bf16 = np.asarray(jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16))
    ref = {"w": bf16, "stacks": [{"b": bf16[0]}, {"n": np.arange(4, dtype=np.int32)}]}
    port = lm_params_from_numpy(ref)
    assert port["w"].dtype == port["stacks"][0]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port["w"].to(torch.float32).numpy(),
                                  bf16.astype(np.float32))
    assert port["stacks"][1]["n"].dtype == torch.int32
    cfg_ref = ref_registry.reduced_config("llama3-8b")
    state = to_np(ref_lm.init_decode_state(cfg_ref, 2, 8, kv_int8=True))
    got = lm_state_from_numpy(state)
    assert [t.dtype for t in tree_leaves(got)] == [
        torch.int8, torch.float32, torch.int32, torch.int8, torch.float32]
    want = lm.init_decode_state(registry.reduced_config("llama3-8b"), 2, 8,
                                kv_int8=True)
    assert [(t.dtype, t.shape) for t in tree_leaves(want)] == \
        [(t.dtype, t.shape) for t in tree_leaves(got)]


def test_port_init_has_the_reference_tree(case):
    cfg = case["cfg"]
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "encdec":
        got = whisper.init_whisper(gen, cfg, max_dec_pos=4 * S)
    else:
        got = lm.init_lm(gen, cfg)
    want = jax.tree_util.tree_leaves(case["ref_params"])
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [tuple(a.shape) for a in want]
    assert leaf_names(got) == leaf_names(case["port_params"])
    # the reference's distributions: each leaf's spread within 30% of the
    # reference's draw, constants equal
    for t, a in zip(tree_leaves(got), want):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            np.testing.assert_allclose(t.numpy(), a, rtol=1e-6)
        else:
            sd_t, sd_a = float(t.std()), float(np.std(a))
            assert abs(sd_t - sd_a) <= 0.3 * sd_a, t.shape


# ---------------------------------------------------------------------------
# per arch: forward, loss, gradients, prefill, decode
# ---------------------------------------------------------------------------

def test_forward_matches_reference(case):
    want = np.asarray(ref_forward(case))
    got = port_forward(case)
    assert tuple(got.shape) == want.shape == (B, S, case["cfg"].padded_vocab)
    with torch.no_grad():
        np.testing.assert_allclose(t_np(port_forward(case)), want, **FWD_TOL)


def test_loss_matches_reference(case):
    want = float(ref_loss_fn(case)(case["ref_params"]))
    got = float(port_loss(case, case["port_params"]))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_gradients_match_reference(case):
    want = jax.grad(ref_loss_fn(case))(case["ref_params"])
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(case["port_params"])]
    loss = port_loss(case, tree_unflatten(case["port_params"], leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    names = leaf_names(case["port_params"])
    ref_leaves = jax.tree_util.tree_leaves(want)
    assert len(ref_leaves) == len(grads) == len(names)
    total = float(np.sqrt(sum(float(np.sum(np.square(w))) for w in ref_leaves)))
    for name, g, w in zip(names, grads, ref_leaves):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        diff = float(np.linalg.norm(g - w))
        if exact_zero_grad(case["cfg"], name):
            # noise on both sides, held to 1e-6 of the whole gradient
            assert max(float(np.linalg.norm(g)), float(np.linalg.norm(w))) \
                <= 1e-6 * total, name
            continue
        ref = float(np.linalg.norm(w))
        assert ref > 0, name
        assert diff <= 1e-4 * ref, (name, diff / ref)


def _prefill(c, params, port: bool, headroom: int = 4):
    toks = c["toks"][:, : S - 1]
    if c["cfg"].family == "encdec":
        if port:
            return whisper.whisper_prefill(params, _t(c["extra"]), _t(toks),
                                           c["cfg"])
        return ref_whisper.whisper_prefill(params, _j(c["extra"]), _j(toks),
                                           c["cfg_ref"])
    if port:
        return lm.lm_prefill(params, _t(toks), c["cfg"],
                             patch_embeds=_t(c["extra"]), cache_headroom=headroom)
    return ref_lm.lm_prefill(params, _j(toks), c["cfg_ref"],
                             patch_embeds=_j(c["extra"]), cache_headroom=headroom)


def test_prefill_matches_reference(case):
    want_logits, want_state = _prefill(case, case["ref_params"], port=False)
    with torch.no_grad():
        got_logits, got_state = _prefill(case, case["port_params"], port=True)
    np.testing.assert_allclose(t_np(got_logits), np.asarray(want_logits), **FWD_TOL)
    want_leaves = jax.tree_util.tree_leaves(want_state)
    got_leaves = tree_leaves(got_state)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(t_np(g), w, **FWD_TOL)


def _whisper_room(state, cfg_ref):
    """The reference test's decode state with room for one more token."""
    big = ref_whisper.init_whisper_decode_state(cfg_ref, B, S, S,
                                                dtype=state["self_k"].dtype)
    big["self_k"] = big["self_k"].at[:, :, : S - 1].set(state["self_k"])
    big["self_v"] = big["self_v"].at[:, :, : S - 1].set(state["self_v"])
    big["cross_k"], big["cross_v"] = state["cross_k"], state["cross_v"]
    big["len"] = state["len"]
    return big


def test_decode_step_on_a_bf16_state_matches_reference(case):
    cfg, cfg_ref = case["cfg"], case["cfg_ref"]
    _, state = _prefill(case, case["ref_params"], port=False)
    if cfg.family == "encdec":
        state = _whisper_room(state, cfg_ref)
    state = _bf16_state(state)
    tok = case["toks"][:, -1:]
    port_state = lm_state_from_numpy(to_np(state))
    if cfg.family == "encdec":
        want, want_state = ref_whisper.whisper_decode_step(
            case["ref_params"], state, _j(tok), cfg_ref)
        with torch.no_grad():
            got, got_state = whisper.whisper_decode_step(
                case["port_params"], port_state, _t(tok), cfg)
    else:
        want, want_state = ref_lm.lm_decode_step(case["ref_params"], state,
                                                 _j(tok), cfg_ref)
        with torch.no_grad():
            got, got_state = lm.lm_decode_step(case["port_params"], port_state,
                                               _t(tok), cfg)
    np.testing.assert_allclose(t_np(got), np.asarray(want), **SERVE_TOL)
    for g, w in zip(tree_leaves(got_state), jax.tree_util.tree_leaves(want_state)):
        assert str(g.dtype).rsplit(".", 1)[-1] == str(w.dtype), (g.dtype, w.dtype)
        np.testing.assert_allclose(t_np(g), f32(w), **SERVE_TOL)


def test_prefill_decode_consistency(case):
    """The port's serving path agrees with its training path on the same
    tokens: prefill(t[:-1]) + decode(t[-1]) == forward(t)'s last logits."""
    cfg = case["cfg"]
    params = case["port_params"]
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    c = {**case, "cfg": cfg}
    with torch.no_grad():
        full = port_forward(c)
        if cfg.family == "encdec":
            _, state = whisper.whisper_prefill(params, _t(c["extra"]),
                                               _t(c["toks"][:, : S - 1]), cfg)
            big = whisper.init_whisper_decode_state(cfg, B, S, S,
                                                    dtype=state["self_k"].dtype)
            big["self_k"][:, :, : S - 1] = state["self_k"]
            big["self_v"][:, :, : S - 1] = state["self_v"]
            big.update(cross_k=state["cross_k"], cross_v=state["cross_v"],
                       len=state["len"])
            step, _ = whisper.whisper_decode_step(params, big,
                                                  _t(c["toks"][:, -1:]), cfg)
        else:
            _, states = lm.lm_prefill(params, _t(c["toks"][:, : S - 1]), cfg,
                                      patch_embeds=_t(c["extra"]),
                                      cache_headroom=1)
            step, _ = lm.lm_decode_step(params, states, _t(c["toks"][:, -1:]), cfg)
    np.testing.assert_allclose(t_np(step[:, -1, : cfg.vocab]),
                               t_np(full[:, -1, : cfg.vocab]), **SERVE_TOL)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-14b"])
def test_int8_kv_cache_matches_reference(arch):
    cfg_ref, cfg = ref_registry.reduced_config(arch), registry.reduced_config(arch)
    ref_params = ref_lm.init_lm(jax.random.PRNGKey(0), cfg_ref)
    params = lm_params_from_numpy(to_np(ref_params))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ctx = S + 4
    ref_q = ref_lm.init_decode_state(cfg_ref, B, ctx, kv_int8=True)
    port_q = lm.init_decode_state(cfg, B, ctx, kv_int8=True)
    port_f = lm.init_decode_state(cfg, B, ctx, dtype=torch.float32)
    with torch.no_grad():
        for t in range(4):
            tok = toks[:, t: t + 1]
            want, ref_q = ref_lm.lm_decode_step(ref_params, ref_q, _j(tok), cfg_ref)
            got, port_q = lm.lm_decode_step(params, port_q, _t(tok), cfg)
            exact, port_f = lm.lm_decode_step(params, port_f, _t(tok), cfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    (rq,), (pq,) = ref_q, port_q
    for name in ("k", "v"):
        assert pq[name].dtype == torch.int8
        codes = pq[name].numpy().astype(np.int32)
        assert np.abs(codes - np.asarray(rq[name]).astype(np.int32)).max() <= 1
        assert np.abs(codes).max() == 127                  # it quantized
        np.testing.assert_allclose(pq[f"{name}_scale"].numpy(),
                                   np.asarray(rq[f"{name}_scale"]),
                                   rtol=1e-6, atol=0)
    assert int(pq["len"]) == int(rq["len"]) == 4
    # decode logits within quantization tolerance of the exact cache
    np.testing.assert_allclose(got[..., : cfg.vocab].numpy(),
                               exact[..., : cfg.vocab].numpy(), rtol=0.1, atol=0.1)


# ---------------------------------------------------------------------------
# MoE routing
# ---------------------------------------------------------------------------

def _ref_slot_table(monkeypatch, params, x, cfg_ref):
    """The reference's (B, nb, blk, k) slot table, read off the one-hot
    calls of its dispatch matrix, and its MoE output."""
    calls = []
    one_hot = jax.nn.one_hot

    def spy(idx, num_classes, *args, **kwargs):
        calls.append((num_classes, np.asarray(idx)))
        return one_hot(idx, num_classes, *args, **kwargs)

    monkeypatch.setattr(jax.nn, "one_hot", spy)
    out = ref_layers.moe(params, x, cfg_ref)
    monkeypatch.setattr(jax.nn, "one_hot", one_hot)
    n_slots = [n for n, _ in calls if n != cfg_ref.n_experts][0]
    slots = [a for n, a in calls if n == n_slots][: cfg_ref.top_k]
    return np.stack(slots, -1), np.asarray(out), n_slots - 1


@pytest.mark.parametrize("ties", [False, True], ids=["random", "forced_ties"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
def test_moe_slot_table_matches_reference(monkeypatch, arch, ties):
    cfg_ref = dataclasses.replace(ref_registry.reduced_config(arch),
                                  capacity_factor=1.0, moe_block=8)
    cfg = dataclasses.replace(registry.reduced_config(arch), capacity_factor=1.0,
                              moe_block=8)
    ref_params = ref_layers.init_moe(jax.random.PRNGKey(3), cfg_ref)
    if ties:
        # experts 1 and 2 (and 0 and 3) share router columns: every token's
        # probabilities tie pairwise, so the order among ties decides
        r = np.asarray(ref_params["router"])
        r = np.stack([r[:, 0], r[:, 1], r[:, 1], r[:, 0]], 1)
        ref_params = {**ref_params, "router": jnp.asarray(r)}
    x = np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want_slots, want_out, n_slots = _ref_slot_table(monkeypatch, ref_params,
                                                    jnp.asarray(x), cfg_ref)
    params = lm_params_from_numpy(to_np(ref_params))
    with torch.no_grad():
        _, slots, cap = layers.moe_routing(params, torch.from_numpy(x), cfg)
        out = layers.moe(params, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    assert (want_slots == cfg.n_experts * cap).any(), "nothing was dropped"
    if ties:
        # the tied pair's lower expert takes the first choice
        first = slots.numpy()[..., 0] // cap
        assert set(np.unique(first)) <= {0, 1, cfg.n_experts}   # or dropped
    np.testing.assert_allclose(out.numpy(), want_out, **FWD_TOL)
    assert n_slots == cfg.padded_experts * cap
