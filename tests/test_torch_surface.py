"""The rest of the reference's public surface in the SNN modules (CPU).

Each name against the reference's on the same numbers: the deprecated
forward shims (both warn ``DeprecationWarning``), ``SNNConfig.
feature_widths``, ``SNNProgram.bind`` / ``BoundProgram.__call__`` /
``timestep_template``, the GOAP oracles (``goap_conv_nnz`` within 1e-6:
a scatter-add in f32; the float64 Algorithm-1 emulators bit for bit),
``PackedCoo.s``, ``sigma_delta_decode`` and ``lif_unroll``; and the
port's ``repro_torch.core`` facade exports what ``repro.core`` does.
Logits within 1e-5, as the reference holds its own backends.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import SMALL, SMALL_REF, setup, spike_frames, t
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
import repro_torch.core as port_core
from repro.core import encoder as ref_encoder, goap as ref_goap, lif as ref_lif
from repro.core.sparse_format import coo_from_dense as ref_coo
from repro.models import graph as ref_graph, snn as ref_snn
from repro_torch.core import encoder, goap, lif
from repro_torch.core.sparse_format import coo_from_dense
from repro_torch.models import graph, snn

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _frames(seed, batch=None):
    shape = (SMALL.timesteps, SMALL.conv_specs[0][1], SMALL.input_width)
    return spike_frames(seed, shape if batch is None else (batch,) + shape)


@pytest.mark.parametrize("name", ["snn_forward", "snn_forward_batch",
                                  "snn_forward_sparse"])
def test_deprecated_forward_shims_warn_and_match_the_reference(name):
    params, masks, tparams, tmasks = setup(SMALL_REF, 0, 0.5)
    frames = _frames(1, batch=3 if name == "snn_forward_batch" else None)
    with pytest.warns(DeprecationWarning, match=name):
        if name == "snn_forward_sparse":
            want = ref_snn.snn_forward_sparse(
                ref_snn.sparsify_params(params, masks), jnp.asarray(frames),
                SMALL_REF)
        else:
            want = getattr(ref_snn, name)(params, jnp.asarray(frames), SMALL_REF,
                                          masks=masks)
    with pytest.warns(DeprecationWarning, match=name):
        if name == "snn_forward_sparse":
            got = snn.snn_forward_sparse(snn.sparsify_params(tparams, tmasks),
                                         frames, SMALL, device="cpu")
        else:
            got = getattr(snn, name)(tparams, frames, SMALL, masks=tmasks,
                                     device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("spec", [{}, dict(input_width=100, pool=3)])
def test_feature_widths(spec):
    cfg = dict(conv_specs=((3, 2, 4), (3, 4, 8)), fc_specs=((64, 16), (16, 5)),
               n_classes=5, **spec)
    assert snn.SNNConfig(**cfg).feature_widths() == \
        ref_snn.SNNConfig(**cfg).feature_widths()


def test_bind_is_deprecated_and_its_program_calls_like_the_reference():
    params, masks, tparams, tmasks = setup(SMALL_REF, 2, 0.5)
    frames = _frames(3)
    with pytest.warns(DeprecationWarning, match="bind"):
        want = ref_graph.compile_snn(SMALL_REF).bind(params, "goap", masks=masks)
    with pytest.warns(DeprecationWarning, match="bind"):
        bound = graph.compile_snn(SMALL).bind(tparams, "goap", masks=tmasks,
                                              device="cpu")
    assert isinstance(bound, graph.BoundProgram)
    np.testing.assert_allclose(bound(t(frames)).numpy(),
                               np.asarray(want(jnp.asarray(frames))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(bound(t(frames)).numpy(),
                               bound.run(t(frames))[0].numpy(), atol=0, rtol=0)


def test_timestep_template_has_one_timestep_of_each_sequence():
    xs = (torch.zeros(4, 3, 5), torch.zeros(4, 7, dtype=torch.bfloat16))
    want = ref_graph.timestep_template((jnp.zeros((4, 3, 5)),
                                        jnp.zeros((4, 7), jnp.bfloat16)))
    got = graph.timestep_template(xs)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16]
    assert tuple(graph.timestep_template(xs[0]).shape) == (3, 5)


@pytest.mark.parametrize("kw,ic,oc,density,seed", [
    (3, 2, 4, 0.5, 0), (5, 3, 6, 0.3, 1), (11, 2, 16, 0.5, 2), (3, 4, 5, 0.0, 3)])
def test_goap_oracles_match_the_reference(kw, ic, oc, density, seed):
    rng = np.random.default_rng(seed)
    w = ((rng.random((kw, ic, oc)) < density)
         * rng.normal(size=(kw, ic, oc))).astype(np.float32)
    ifm = (rng.random((ic, 20 + kw)) < 0.5).astype(np.float32)
    rcoo, pcoo = ref_coo(w), coo_from_dense(w)
    want = np.asarray(ref_goap.goap_conv_nnz(jnp.asarray(ifm), rcoo))
    got = goap.goap_conv_nnz(t(ifm), pcoo)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # batched: the leading dims are carried through
    both = goap.goap_conv_nnz(t(np.stack([ifm, ifm])), pcoo)
    np.testing.assert_array_equal(both[1].numpy(), got.numpy())
    for name in ("goap_conv_reference", "goap_conv_reference_loop"):
        np.testing.assert_array_equal(getattr(goap, name)(ifm, pcoo),
                                      getattr(ref_goap, name)(ifm, rcoo))
    assert goap.goap_pack(pcoo).s == ref_goap.goap_pack(rcoo).s


def test_sigma_delta_decode_and_lif_unroll_match_the_reference():
    rng = np.random.default_rng(5)
    x = rng.random((2, 16)).astype(np.float32)
    bits = np.asarray(ref_encoder.sigma_delta_encode(jnp.asarray(x), 8))
    np.testing.assert_allclose(encoder.sigma_delta_decode(t(bits)).numpy(),
                               np.asarray(ref_encoder.sigma_delta_decode(
                                   jnp.asarray(bits))), atol=0, rtol=0)
    cur = rng.normal(size=(6, 4, 9)).astype(np.float32)
    ref_p = ref_lif.init_lif_params((4, 1), 0.8, 0.7, 0.4)
    sp_r, v_r = ref_lif.lif_unroll(jnp.asarray(cur), ref_p)
    sp, v = lif.lif_unroll(t(cur), lif.init_lif_params((4, 1), 0.8, 0.7, 0.4))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_r))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_r), atol=1e-5, rtol=0)


def test_core_facade_exports_what_the_reference_core_exports():
    tree = ast.parse((SRC / "repro" / "core" / "__init__.py").read_text())
    names = [a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) > 40
    missing = [n for n in names if not hasattr(port_core, n)]
    assert not missing, missing
