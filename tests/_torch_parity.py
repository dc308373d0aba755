"""Shared setup for the port's parity tests (``tests/test_torch_*.py``).

Weights come from the reference (``repro.api.init_snn`` with a jax key,
``repro.train.pruning.make_mask_pytree``) and reach the port as numpy
through :mod:`repro_torch.convert`, so both packages compute on the same
numbers.  Frames are drawn from numpy seeds.
"""
import numpy as np
import torch

import jax

from repro.api import init_snn as ref_init_snn
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


def spike_frames(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < 0.5).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))
