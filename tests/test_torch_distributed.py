"""The port's ``distributed/`` for the SNN held to the reference (CPU).

Compression: ``quantize_int8``, ``ef_compress`` and ``compression_ratio``
bit-equal to ``repro.distributed.compression`` on the same numpy inputs;
``compressed_psum`` over two ``gloo`` ranks equal (atol 0) to the
reference's 2-device ``shard_map`` result, each computed in subprocesses.
Pipeline: ``spmd_pipeline`` equal to the sequential stages within 2e-5
(the reference's own case), and the example's 4-stage SNN pipeline within
1e-5 of the reference's ``apply_batch(..., "dense")`` on the reference's
params.  Serving mesh: ``AsyncAMCServeEngine(mesh=serve_mesh(2,
device_type="cpu"))`` with buckets aligned to 2, its predictions equal to
the unsharded engine's and to the reference engine's on its
``test_async_engine_shard_map_path`` case; gauges off under a mesh.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import PAPER, PAPER_REF, params_to_numpy
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.api import compile_snn as ref_compile_snn
from repro.api import init_snn as ref_init_snn
from repro.distributed import compression as ref_comp
from repro.distributed.sharding import serve_mesh as ref_serve_mesh
from repro.models.snn import SNNConfig as RefConfig
from repro.serve import AsyncAMCServeEngine as RefEngine
from repro.train.pruning import make_mask_pytree as ref_masks
from repro_torch.api import AsyncAMCServeEngine, SNNConfig
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.distributed import compression, pipeline, sharding
from repro_torch.examples import snn_pipeline
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reduced config of tests/test_serve.py
SERVE_SPEC = dict(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
                  fc_specs=((32, 16), (16, 5)), input_width=16, timesteps=3,
                  n_classes=5)


def _grad_tree(seed, workers=None):
    """A gradient tree of three leaves (one all zero), as numpy; with
    ``workers`` a leading worker axis."""
    rng = np.random.default_rng(seed)
    lead = () if workers is None else (workers,)
    return {"w": rng.normal(size=lead + (64,)).astype(np.float32),
            "b": [(rng.normal(size=lead + (3, 5)) * 1e-3).astype(np.float32),
                  np.zeros(lead + (4,), np.float32)]}


def _torch_tree(tree):
    return {"w": torch.from_numpy(tree["w"]),
            "b": [torch.from_numpy(x) for x in tree["b"]]}


def _jax_tree(tree):
    return {"w": jnp.asarray(tree["w"]), "b": [jnp.asarray(x) for x in tree["b"]]}


def _assert_leaves_equal(port_tree, ref_tree):
    got = [x.numpy() for x in tree_leaves(port_tree)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_error_feedback_bit_equal_to_reference(seed):
    g, ef = _grad_tree(seed), _grad_tree(seed + 100)
    _assert_leaves_equal(compression.quantize_int8(_torch_tree(g))[0],
                         ref_comp.quantize_int8(_jax_tree(g))[0])
    _assert_leaves_equal(compression.quantize_int8(_torch_tree(g))[1],
                         ref_comp.quantize_int8(_jax_tree(g))[1])
    got = compression.ef_compress(_torch_tree(g), _torch_tree(ef))
    want = ref_comp.ef_compress(_jax_tree(g), _jax_tree(ef))
    for a, b in zip(got, want):
        _assert_leaves_equal(a, b)
    _assert_leaves_equal(compression.dequantize_int8(*got[:2]),
                         ref_comp.dequantize_int8(*want[:2]))
    assert compression.compression_ratio(_torch_tree(g)) == \
        ref_comp.compression_ratio(_jax_tree(g))


_RANK = r"""
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.distributed.compression import compressed_psum
store, rank, data, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
d = np.load(data)
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
try:
    g = {"w": torch.from_numpy(d["gw"][rank]),
         "b": [torch.from_numpy(d["gb0"][rank]), torch.from_numpy(d["gb1"][rank])]}
    e = {"w": torch.from_numpy(d["ew"][rank]),
         "b": [torch.from_numpy(d["eb0"][rank]), torch.from_numpy(d["eb1"][rank])]}
    mean, ef = compressed_psum(g, e)
finally:
    dist.destroy_process_group()
np.savez(out, mw=mean["w"].numpy(), mb0=mean["b"][0].numpy(),
         mb1=mean["b"][1].numpy(), ew=ef["w"].numpy(), eb0=ef["b"][0].numpy(),
         eb1=ef["b"][1].numpy())
"""

_REF = r"""
import functools, sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import AxisType, make_mesh, shard_map
from repro.distributed.compression import compressed_psum
d = np.load(sys.argv[1])
mesh = make_mesh((2,), ("dp",), axis_types=(AxisType.Auto,))
@functools.partial(shard_map, mesh=mesh, in_specs=(P("dp"),) * 6,
                   out_specs=(P("dp"),) * 6, check_vma=False)
def step(gw, gb0, gb1, ew, eb0, eb1):
    mean, ef = compressed_psum({"w": gw[0], "b": [gb0[0], gb1[0]]},
                               {"w": ew[0], "b": [eb0[0], eb1[0]]}, "dp")
    return (mean["w"][None], mean["b"][0][None], mean["b"][1][None],
            ef["w"][None], ef["b"][0][None], ef["b"][1][None])
out = step(*(jnp.asarray(d[k]) for k in ("gw", "gb0", "gb1", "ew", "eb0", "eb1")))
np.savez(sys.argv[2], **dict(zip(("mw", "mb0", "mb1", "ew", "eb0", "eb1"),
                                  (np.asarray(o) for o in out))))
"""


def test_compressed_psum_over_two_gloo_ranks_equals_the_reference(tmp_path):
    g, ef = _grad_tree(3, workers=2), _grad_tree(4, workers=2)
    data = tmp_path / "data.npz"
    np.savez(data, gw=g["w"], gb0=g["b"][0], gb1=g["b"][1],
             ew=ef["w"] * 1e-2, eb0=ef["b"][0], eb1=ef["b"][1])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ref_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
               "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(tmp_path / "store"), str(r),
         str(data), str(tmp_path / f"rank{r}.npz")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REF, str(data), str(tmp_path / "ref.npz")],
        env=ref_env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-2000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ref = np.load(tmp_path / "ref.npz")
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k in ("mw", "mb0", "mb1", "ew", "eb0", "eb1"):
            np.testing.assert_array_equal(got[k], ref[k][r], err_msg=k)
    # both ranks hold the one mean
    np.testing.assert_array_equal(np.load(tmp_path / "rank0.npz")["mw"],
                                  np.load(tmp_path / "rank1.npz")["mw"])


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("collect", ["psum", "stack"])
def test_spmd_pipeline_equals_sequential(collect):
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.3)
    mbs = torch.from_numpy(rng.normal(size=(6, 8, 16)).astype(np.float32))
    out = pipeline.spmd_pipeline(lambda w, x: torch.tanh(x @ w), ws, mbs,
                                 ["cpu"] * 4, collect=collect)
    ref = mbs
    for i in range(4):
        ref = torch.tanh(ref @ ws[i])
    assert out.shape == (6, 8, 16)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_pipeline_ticks_and_stage_index():
    """The fixed schedule: every stage runs every one of n_micro +
    n_stages - 1 ticks, stage_index() names the stage being called."""
    calls = []

    def stage_fn(p, x):
        calls.append(pipeline.stage_index())
        return x + p

    params = pipeline.stack_stage_params(
        [torch.tensor(float(10 ** i)) for i in range(3)])
    mbs = torch.arange(5, dtype=torch.float32)[:, None]
    out = pipeline.spmd_pipeline(stage_fn, params, mbs, ["cpu"] * 3)
    assert calls == [0, 1, 2] * (5 + 3 - 1)
    np.testing.assert_array_equal(out.numpy()[:, 0], np.arange(5) + 111.0)
    with pytest.raises(RuntimeError, match="inside a stage_fn"):
        pipeline.stage_index()


def test_snn_four_stage_pipeline_matches_reference_dense_forward():
    params = ref_init_snn(jax.random.PRNGKey(0), PAPER_REF)
    rng = np.random.default_rng(7)
    frames = (rng.random((8, PAPER.timesteps, 2, PAPER.input_width))
              < 0.5).astype(np.float32)
    got = snn_pipeline.pipeline_logits(
        PAPER, params_from_numpy(params_to_numpy(params)), frames,
        ["cpu"] * 4).numpy()
    want = np.asarray(ref_compile_snn(PAPER_REF).apply_batch(
        params, jnp.asarray(frames), "dense"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# serving mesh
# ---------------------------------------------------------------------------

def test_serve_mesh_and_shard_serve_fn_on_the_cpu(monkeypatch):
    mesh = sharding.serve_mesh(2, device_type="cpu")
    assert mesh.shape == {"data": 2} and mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert sharding.serve_batch_pspec(mesh) == ("data",)
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x * 2

    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    out = sharding.shard_serve_fn(fn, mesh)(x)
    np.testing.assert_array_equal(out.numpy(), x * 2)
    assert seen == [3, 3]
    per_device = sharding.shard_serve_fn([lambda x: x, lambda x: -x], mesh)
    np.testing.assert_array_equal(per_device(torch.ones(4)).numpy(),
                                  [1, 1, -1, -1])
    with pytest.raises(ValueError, match="split evenly"):
        sharding.shard_serve_fn(fn, mesh)(np.zeros((5, 2), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.serve_mesh()


def _serve_setup():
    ref_cfg = RefConfig(**SERVE_SPEC)
    params = ref_init_snn(jax.random.PRNGKey(0), ref_cfg)
    masks = ref_masks(params, 0.5)
    port_p = params_from_numpy(params_to_numpy(params))
    port_m = masks_from_numpy({g: [np.asarray(m) for m in masks[g]]
                               for g in ("conv", "fc")})
    return ref_cfg, params, masks, SNNConfig(**SERVE_SPEC), port_p, port_m


def test_mesh_engine_matches_unsharded_and_the_reference_shard_map_case():
    ref_cfg, r_params, r_masks, cfg, params, masks = _serve_setup()
    iq = np.random.default_rng(5).normal(
        size=(6, 2, cfg.input_width)).astype(np.float32)
    with RefEngine(r_params, ref_cfg, masks=r_masks, backend="dense",
                   mesh=ref_serve_mesh(1), max_batch=4, max_delay_ms=5.0,
                   warmup=False) as ref:
        want = ref.classify(iq)
    with AsyncAMCServeEngine(params, cfg, masks, backend="dense",
                             device="cpu", max_batch=4) as single:
        unsharded = single.classify(iq)
    with AsyncAMCServeEngine(params, cfg, masks, backend="dense",
                             mesh=sharding.serve_mesh(2, device_type="cpu"),
                             max_batch=4, max_delay_ms=5.0,
                             warmup=False) as engine:
        assert engine.mesh.size == 2 and engine.device == torch.device("cpu")
        assert engine.batcher.buckets == (2, 4)
        preds = engine.classify(iq)
        assert engine.step(iq[:4]).shape == (4, cfg.n_classes)
    np.testing.assert_array_equal(preds, unsharded)
    np.testing.assert_array_equal(preds, want)


def test_mesh_serves_without_gauges_as_the_reference():
    _, _, _, cfg, params, masks = _serve_setup()
    iq = np.random.default_rng(6).normal(
        size=(8, 2, cfg.input_width)).astype(np.float32)
    with AsyncAMCServeEngine(params, cfg, masks, backend="stream",
                             device="cpu", max_batch=4) as gauged:
        assert gauged.activity is not None
        want_logits, accs = gauged.serve_step(iq[:4])
        assert accs is not None
        want = gauged.classify(iq)
    with AsyncAMCServeEngine(params, cfg, masks, backend="stream",
                             activity_gauges=True, max_batch=4,
                             mesh=sharding.serve_mesh(2, device_type="cpu"),
                             ) as engine:
        assert engine.activity is None
        logits, accs = engine.serve_step(iq[:4])
        assert accs is None
        np.testing.assert_allclose(logits, want_logits, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(engine.classify(iq), want)


def test_mesh_and_device_must_agree():
    _, _, _, cfg, params, masks = _serve_setup()
    with pytest.raises(ValueError, match="first device of the mesh"):
        AsyncAMCServeEngine(params, cfg, masks, backend="dense",
                            device="cpu", warmup=False,
                            mesh=sharding.ServeMesh(["cuda:0"]))
