"""Shared setup for the port's parity tests (``tests/test_torch_*.py``).

Weights come from the reference (``repro.api.init_snn`` with a jax key,
``repro.train.pruning.make_mask_pytree``) and reach the port as numpy
through :mod:`repro_torch.convert`, so both packages compute on the same
numbers.  Frames are drawn from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api import init_snn as ref_init_snn
from repro.core.lif import LIFParams as RefLIF
from repro.models.snn import SNNConfig as RefConfig
from repro.train.pruning import make_mask_pytree as ref_masks
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.models.snn import SNNConfig

# the reduced config of tests/test_stream_fused.py
SMALL_SPEC = dict(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
                  fc_specs=((64, 16), (16, 5)), input_width=32,
                  timesteps=4, n_classes=5)
SMALL_REF = RefConfig(**SMALL_SPEC).validate()
SMALL = SNNConfig(**SMALL_SPEC).validate()
PAPER_REF = RefConfig()
PAPER = SNNConfig()


@pytest.fixture(scope="module", autouse=True)
def port_plan_cache_in_memory():
    """Keep the port's plan cache off the disk for a whole test module.

    ``tests/conftest.py`` makes only the reference's default cache
    memory-only; the port's disk tier (``~/.cache/repro_torch/plans``)
    would otherwise fill from every plan a test compiles, and stale
    artifacts could hide a change to an artifact derivation.  Import this
    fixture into every module that compiles plans: it installs a
    memory-only default cache and turns the disk tier of every
    ``PlanCache()`` made in the module off.
    """
    from repro_torch.plan import PlanCache, cache, set_default_cache

    old = cache._default
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cache.ENV_DIR, "")
        set_default_cache(PlanCache())
        yield
    set_default_cache(old)


def params_to_numpy(params):
    """Reference param pytree -> nested numpy (LIFParams as dicts)."""
    def layer(lp):
        lif = lp["lif"]
        return {"w": np.asarray(lp["w"]),
                "lif": {"alpha_logit": np.asarray(lif.alpha_logit),
                        "theta": np.asarray(lif.theta),
                        "v_th": np.asarray(lif.v_th)}}
    return {g: [layer(lp) for lp in params[g]] for g in ("conv", "fc")}


def masks_to_numpy(masks):
    return {g: [np.asarray(m) for m in masks[g]] for g in ("conv", "fc")}


def setup(ref_cfg, seed, density):
    """(ref params, ref masks, port params, port masks) on the same numbers."""
    params = ref_init_snn(jax.random.PRNGKey(seed), ref_cfg)
    masks = ref_masks(params, density)
    return (params, masks, params_from_numpy(params_to_numpy(params)),
            masks_from_numpy(masks_to_numpy(masks)))


def setup_bf16(ref_cfg, seed, masks_dtype, trained_lif):
    """The reference's bf16 params (optionally with per-neuron LIF
    parameters spread as training leaves them) and masks in
    ``masks_dtype`` (None: no masks), and their port twins."""
    params = ref_init_snn(jax.random.PRNGKey(seed), ref_cfg, dtype=jnp.bfloat16)
    if trained_lif:
        rng = np.random.default_rng(seed)

        def spread(lif):
            shape = lif.alpha_logit.shape
            return RefLIF(*(jnp.asarray(lo + (hi - lo) * rng.random(shape), jnp.bfloat16)
                            for lo, hi in ((0.5, 4.0), (0.5, 1.5), (0.3, 1.2))))
        params = {g: [{"w": lp["w"], "lif": spread(lp["lif"])} for lp in params[g]]
                  for g in ("conv", "fc")}
    masks = None
    if masks_dtype is not None:
        masks = jax.tree_util.tree_map(lambda m: m.astype(masks_dtype),
                                       ref_masks(params, 0.5))
    tparams = params_from_numpy(params_to_numpy(params))
    tmasks = None if masks is None else masks_from_numpy(
        {g: [np.asarray(m) for m in masks[g]] for g in ("conv", "fc")})
    return params, masks, tparams, tmasks


def spike_frames(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < 0.5).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# the reduced training config of tests/test_checkpoint.py (T = 2, width
# 128, 11 classes), with the threshold at 0.5 so that spikes reach the
# readout within two timesteps (at 1.0 every logit stays 0 and the loss
# stays log 11)
TRAIN_SPEC = dict(conv_specs=((3, 2, 4), (3, 4, 8), (3, 8, 8)),
                  fc_specs=((8 * 16, 16), (16, 11)), timesteps=2,
                  lif_v_th=0.5)
TRAIN_DENSITY = {"conv1": 0.5, "conv2": 0.4, "conv3": 0.3, "fc1": 0.4,
                 "fc2": 0.5}
TRAIN_BASE = dict(total_steps=6, batch_size=4, osr=2)


def ref_trainer(**overrides):
    """A reference ``SNNTrainer`` on the reduced training config."""
    from repro.train import SNNTrainer, TrainerConfig

    return SNNTrainer(RefConfig(**TRAIN_SPEC),
                      TrainerConfig(**{**TRAIN_BASE, **overrides}))


def port_trainer(params=None, lsq_scales=None, **overrides):
    """The port's ``SNNTrainer`` on the CPU; given reference ``params`` (and
    LSQ scales), holding those, with a fresh optimizer state."""
    from repro_torch.train import SNNTrainer, TrainerConfig

    tr = SNNTrainer(SNNConfig(**TRAIN_SPEC),
                    TrainerConfig(**{**TRAIN_BASE, **overrides}), device="cpu")
    if params is not None:
        tr.params = params_from_numpy(params_to_numpy(params))
        tr.opt_state = tr.opt_init(tr.params)
    if lsq_scales is not None:
        tr.lsq_scales = {g: [t(s) for s in lsq_scales[g]]
                         for g in ("conv", "fc")}
    return tr


def ref_leaves(tree):
    """A reference pytree's leaves as numpy, in jax order."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def port_leaves(tree):
    """A port tree's leaves as numpy, in the port's (jax) order."""
    from repro_torch.tree import tree_leaves

    return [x.detach().cpu().numpy() for x in tree_leaves(tree)]


def leaf_names(tree, prefix=""):
    """'/'-joined paths of a nested dict/list tree's leaves, in
    ``jax.tree_util`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


def exact_zero_grad(cfg, name: str) -> bool:
    """Language-model leaves whose gradient is zero in exact arithmetic,
    where both packages give rounding noise: a k-projection bias without
    rope adds q . b_k to every score of a query row, to which the row's
    softmax is invariant (whisper), and a top-1 router's weight
    p / (p + 1e-9) is 1 to f32 precision (llama4-scout)."""
    leaf = name.rsplit("/", 1)[-1]
    return ((leaf == "bk" and (not cfg.rope_enabled or "/cross/" in name))
            or (leaf == "router" and cfg.top_k == 1))
