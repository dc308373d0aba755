"""The port's production cells (``launch/steps.py``) against the
reference's, on the CPU at the reduced configs.

Both packages build each cell on a 1-device mesh for the same small
``ShapeSpec`` and run its step on the reference's own params (carried
across by ``repro_torch.convert``): the reference through
``plan.jitted()``, the port through its ``plan.jitted("cpu")`` (the
static-buffer step the card captures in a CUDA graph).  Both compute in
bf16 (the train cell from f32 master params), and the two packages round
bf16 sums in different orders, so the tolerances below were set from the
measured gaps with margin (the worst measured gap in brackets):

* train: the loss within 2e-3 relative [9.9e-4], the gradient norm within
  2e-2 relative [7.7e-3], the updated params within 1e-3 [2.9e-4] and the
  AdamW moments within 1e-1 [3.9e-2] in relative norm;
* prefill: the last logits within 1e-1 of the reference's scale
  (``|a - b| / (1 + |b|)``) [7.1e-2, RG-LRU's scan], each state leaf
  within 5e-2 relative norm [2.6e-2];
* decode (bf16 and int8 caches): the logits within 1e-1 of scale
  [4.9e-2], each float state leaf within 5e-2 relative norm, the int8
  codes within 2 [2], the lengths exactly.

llama4-scout routes each token to its top-1 expert, and a bf16 rounding
difference between two near-equal router logits sends a token to another
expert (its bf16 prefill logits differ by 0.45 of scale).  Its train and
prefill cells therefore run in f32 on both sides (the cells' ``_to_bf16``
patched to the identity, the prefill params f32), where the routing
agrees.

The cell's sharding trees, kinds and donations equal the reference's on a
(2, 4) mesh; the grid, ``cell_applicable`` and the accumulation counts
equal the reference's for the full configs.  The prefill and decode
cells' steps are held in ``tests/test_torch_cells_serve.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.compat import AxisType, abstract_mesh, make_mesh
from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro.models.lm import init_lm as ref_init_lm
from repro.models.whisper import init_whisper as ref_init_whisper
from repro.train.optimizer import adamw as ref_adamw
from repro_torch.configs import registry
from repro_torch.configs.registry import ARCH_IDS, ShapeSpec, reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.sharding import Mesh, NamedSharding
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
from repro_torch.train.optimizer import adamw
from repro_torch.tree import tree_leaves

TRAIN = ShapeSpec("train_small", 16, 2, "train")
PREFILL = ShapeSpec("prefill_small", 16, 2, "prefill")
DECODE = ShapeSpec("decode_small", 16, 2, "decode")

LOSS_RTOL, GNORM_RTOL, PARAMS_RTOL, MOMENTS_RTOL = 2e-3, 2e-2, 1e-3, 1e-1
LOGITS_TOL, STATE_RTOL, INT8_CODES = 1e-1, 5e-2, 2
# top-1 routing flips on bf16 rounding: these cells run in f32 (see above)
F32_ARCHS = ("llama4-scout-17b-a16e",)


@pytest.fixture(autouse=True)
def short_whisper_encoder(monkeypatch):
    """Whisper's cells at a 128-frame encoder stub on both sides (the
    cells read WHISPER_S_ENC, 2048, when they are built), so its reduced
    config runs in seconds on the CPU."""
    monkeypatch.setattr(ref_steps, "WHISPER_S_ENC", 128)
    monkeypatch.setattr(steps, "WHISPER_S_ENC", 128)


def ref_mesh():
    return make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def port_mesh():
    return Mesh((1, 1), ("data", "model"))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def scaled_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def port_np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy()


def ref_params(cfg, dtype=jnp.float32):
    key = jax.random.PRNGKey(3)
    if cfg.family == "encdec":
        return ref_init_whisper(key, cfg, dtype=dtype)
    return ref_init_lm(key, cfg, dtype=dtype)


def batches(cfg, shape, seed=0):
    """The same batch for both packages: (reference's, port's)."""
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    np_batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if shape.kind == "train":
        np_batch["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        np_batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        np_batch["frames"] = rng.normal(
            size=(b, ref_steps.WHISPER_S_ENC, cfg.d_model)).astype(np.float32)
    ref = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else None)
           for k, v in np_batch.items()}
    return ref, lm_params_from_numpy(to_np(ref))


def port_specs_of(tree):
    return [tuple(s.spec) for s in
            tree_leaves(tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def ref_sharding_leaves(tree):
    from jax.sharding import NamedSharding as RefNamedSharding
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, RefNamedSharding))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_plans_match_the_reference(arch):
    """kind, donations and every sharding tree of the three cells on a
    (2, 4) mesh."""
    rmesh = abstract_mesh((2, 4), ("data", "model"))
    pmesh = make_dev_mesh(2, 4)
    rcfg, cfg = ref_registry.reduced_config(arch), reduced_config(arch)
    shape = dataclasses.replace(DECODE, global_batch=4)
    for name, shp in (("_train_cell", dataclasses.replace(TRAIN, global_batch=4)),
                      ("_prefill_cell", dataclasses.replace(PREFILL, global_batch=4)),
                      ("_decode_cell", shape)):
        want = getattr(ref_steps, name)(arch, shp, rcfg, rmesh)
        got = getattr(steps, name)(arch, shp, cfg, pmesh)
        assert got.kind == want.kind and got.donate_argnums == want.donate_argnums
        assert port_specs_of(got.in_shardings) == ref_sharding_leaves(want.in_shardings)
        assert port_specs_of(got.out_shardings) == ref_sharding_leaves(want.out_shardings)
        for field in ("act_sharding", "logits_sharding", "head_sharding"):
            w, g = getattr(want, field), getattr(got, field)
            assert (w is None) == (g is None), field
            if w is not None:
                assert tuple(g.spec) == tuple(w.spec), field
        # the meta arguments have the reference's shapes and dtypes
        want_args = jax.tree_util.tree_leaves(want.args)
        got_args = tree_leaves(got.args)
        assert [tuple(a.shape) for a in got_args] == [tuple(a.shape) for a in want_args]
        assert [str(a.dtype).rsplit(".", 1)[-1] for a in got_args] == \
            [str(a.dtype) for a in want_args]
        assert all(a.device.type == "meta" for a in got_args)


def _train_pair(arch, shape, rcfg, cfg):
    params = ref_params(rcfg)
    r_init = ref_adamw(3e-4, weight_decay=0.1)[0]
    ref_state = {"params": params, "opt": r_init(params)}
    pparams = lm_params_from_numpy(to_np(params))
    port_state = {"params": pparams,
                  "opt": adamw(3e-4, weight_decay=0.1)[0](pparams)}
    rb, pb = batches(rcfg, shape)
    want_state, want_m = ref_steps._train_cell(
        arch, shape, rcfg, ref_mesh()).jitted()(ref_state, rb)
    step = steps._train_cell(arch, shape, cfg, port_mesh()).jitted("cpu")
    got_state, got_m = step(port_state, pb)
    return want_state, want_m, got_state, got_m


def _check_train(want_state, want_m, got_state, got_m):
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= \
        LOSS_RTOL * abs(float(want_m["loss"]))
    assert abs(float(got_m["gnorm"]) - float(want_m["gnorm"])) <= \
        GNORM_RTOL * abs(float(want_m["gnorm"]))

    def flat(tree, port):
        leaves = tree_leaves(tree) if port else jax.tree_util.tree_leaves(tree)
        return np.concatenate([(port_np(x) if port else np.asarray(x, np.float64)
                                ).ravel() for x in leaves])

    assert rel(flat(got_state["params"], True),
               flat(want_state["params"], False)) <= PARAMS_RTOL
    for field in ("mu", "nu"):
        assert rel(flat(getattr(got_state["opt"], field), True),
                   flat(getattr(want_state["opt"], field), False)) <= MOMENTS_RTOL
    assert int(got_state["opt"].step) == int(want_state["opt"].step) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_cell_step_matches_the_reference(arch, monkeypatch):
    if arch in F32_ARCHS:
        monkeypatch.setattr(ref_steps, "_to_bf16", lambda tree: tree)
        monkeypatch.setattr(steps, "_to_bf16", lambda tree: tree)
    rcfg, cfg = ref_registry.reduced_config(arch), reduced_config(arch)
    _check_train(*_train_pair(arch, TRAIN, rcfg, cfg))


def test_train_cell_accumulates_microbatches_as_the_reference(monkeypatch):
    """n_micro = 2 forced on both sides (the reduced configs never reach
    the accumulation threshold)."""
    monkeypatch.setattr(ref_steps, "_grad_accum_steps", lambda cfg, b: 2)
    monkeypatch.setattr(steps, "_grad_accum_steps", lambda cfg, b: 2)
    arch = "llama3-8b"
    shape = dataclasses.replace(TRAIN, global_batch=4)
    _check_train(*_train_pair(arch, shape, ref_registry.reduced_config(arch),
                              reduced_config(arch)))


def _check_state(got, want):
    """Float leaves within STATE_RTOL in relative norm, int8 codes within
    INT8_CODES, lengths exactly."""
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.int8:
            assert np.abs(port_np(g).astype(np.int64) - w).max() <= INT8_CODES
        elif w.dtype.kind in "iu":
            assert np.array_equal(port_np(g), w)
        else:
            assert rel(port_np(g), w.astype(np.float32)) <= STATE_RTOL


def test_grad_accum_steps_equal_the_reference_for_the_full_configs():
    for arch in ARCH_IDS:
        rcfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
        for batch in (256, 32, 6, 3, 1):
            assert steps._grad_accum_steps(cfg, batch) == \
                ref_steps._grad_accum_steps(rcfg, batch), (arch, batch)


def test_grid_and_cell_applicable_equal_the_reference():
    assert registry.all_cells() == ref_registry.all_cells()
    cells = registry.all_cells()
    assert len(cells) == 40
    assert len([c for c in cells if not c[2]]) == 8
    assert {a for a, s, ok, _ in cells if s == "long_500k" and ok} == {
        "mamba2-780m", "recurrentgemma-9b"}
    assert {k: dataclasses.astuple(v) for k, v in registry.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_registry.SHAPES.items()}
    with pytest.raises(ValueError, match="skipped by design"):
        steps.build_cell("llama3-8b", "long_500k", make_dev_mesh())


def test_production_mesh_axes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert multi.axis_names == ("pod", "data", "model")
    want = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert dict(want.shape) == multi.shape
    assert make_dev_mesh(2, 4).shape == {"data": 2, "model": 4}


def test_static_jit_donation_reuses_buffers_and_copies_nothing_back_in():
    """Outputs passed back in are the step's own buffers (no copy); a
    fresh tree is copied in and left untouched."""
    from repro_torch.train.capture import static_jit

    def fn(state, x):
        return {"w": state["w"] + x}, (state["w"] * 2,)

    step = static_jit(fn, torch.device("cpu"), donate_argnums=(0,))
    fresh = {"w": torch.ones(3)}
    s1, (twice,) = step(fresh, torch.full((3,), 2.0))
    assert torch.equal(fresh["w"], torch.ones(3))
    assert torch.equal(s1["w"], torch.full((3,), 3.0)) and torch.equal(twice, 2 * torch.ones(3))
    s2, _ = step(s1, torch.full((3,), 2.0))
    assert s2["w"] is s1["w"] and torch.equal(s2["w"], torch.full((3,), 5.0))
    assert step.static.keys() and len(step.static.keys()) == 1
