"""The port's sharding rule table against the reference's, on the CPU.

Spec trees are compared entry for entry (the reference's ``PartitionSpec``
and the port's as tuples) on the same shapes: the port's from meta
tensors (``launch.steps._param_shapes``), the reference's from
``jax.eval_shape``.  The reference's four rule tests
(``tests/test_distributed.py``: TP/FSDP, MoE EP vs TP, the divisibility
fallback, decode-state ctx sharding) run on the port as well.  Two gloo
ranks (subprocesses) place a tree through ``named_tree`` as DTensors and
read it back, and restore a checkpoint saved under one mesh layout onto
another (the elastic-reshard contract).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from repro.compat import abstract_mesh
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import reduced_config as ref_reduced_config
from repro.distributed import sharding as ref
from repro.models.lm import init_decode_state as ref_init_decode_state
from repro.models.lm import init_lm as ref_init_lm
from repro.models.whisper import init_whisper as ref_init_whisper
from repro.models.whisper import (init_whisper_decode_state as
                                  ref_init_whisper_decode_state)
from repro.train.optimizer import adamw as ref_adamw
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.distributed import sharding as port
from repro_torch.launch.steps import WHISPER_S_ENC, _param_shapes
from repro_torch.models.lm import init_decode_state
from repro_torch.models.whisper import init_whisper_decode_state
from repro_torch.train.optimizer import adamw
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV_MESH = ((2, 4), ("data", "model"))
POD_MESH = ((2, 2, 4), ("pod", "data", "model"))
PROD_MESH = ((16, 16), ("data", "model"))


def meshes(shape_names):
    return abstract_mesh(*shape_names), port.Mesh(*shape_names)


def ref_specs(tree):
    return [tuple(s) for s in
            jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def port_specs(tree):
    out = tree_leaves(tree, is_leaf=lambda x: isinstance(x, port.PartitionSpec))
    assert all(isinstance(s, port.PartitionSpec) for s in out)
    return [tuple(s) for s in out]


def ref_param_shapes(cfg):
    init = ref_init_whisper if cfg.family == "encdec" else ref_init_lm
    return jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))


def both_params(arch, full=False):
    ref_cfg = (ref_get_config if full else ref_reduced_config)(arch)
    cfg = (get_config if full else reduced_config)(arch)
    return ref_cfg, ref_param_shapes(ref_cfg), cfg, _param_shapes(cfg, torch.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_train_state_specs_equal_reference(arch):
    """partition_params over the params and over the train cell's
    {params, AdamW state} (NamedTuple paths) on a (2, 4) mesh, and
    spec_report's text."""
    rmesh, pmesh = meshes(DEV_MESH)
    ref_cfg, rshapes, cfg, pshapes = both_params(arch)
    kw = dict(n_experts=cfg.padded_experts, head_dim=cfg.hd)
    want = ref.partition_params(rshapes, rmesh, **kw)
    got = port.partition_params(pshapes, pmesh, **kw)
    assert port_specs(got) == ref_specs(want)
    assert port.spec_report(got, pshapes) == ref.spec_report(want, rshapes)

    rstate = {"params": rshapes,
              "opt": jax.eval_shape(ref_adamw(3e-4)[0], rshapes)}
    pstate = {"params": pshapes, "opt": adamw(3e-4)[0](pshapes)}
    assert (port_specs(port.partition_params(pstate, pmesh, **kw))
            == ref_specs(ref.partition_params(rstate, rmesh, **kw)))
    # no FSDP: weights resident
    assert (port_specs(port.partition_params(pshapes, pmesh, fsdp_axis=None, **kw))
            == ref_specs(ref.partition_params(rshapes, rmesh, fsdp_axis=None, **kw)))


@pytest.mark.parametrize("arch,kv_int8", [
    (a, q) for a in ARCH_IDS for q in (False, True)
    if not (q and a == "whisper-large-v3")])    # whisper has no int8 cache
def test_decode_state_specs_equal_reference(arch, kv_int8):
    rmesh, pmesh = meshes(DEV_MESH)
    ref_cfg, cfg = ref_reduced_config(arch), reduced_config(arch)
    if cfg.family == "encdec":
        rstate = jax.eval_shape(lambda: ref_init_whisper_decode_state(
            ref_cfg, 4, 16, WHISPER_S_ENC))
        pstate = init_whisper_decode_state(cfg, 4, 16, WHISPER_S_ENC,
                                           device="meta")
    else:
        rstate = jax.eval_shape(lambda: ref_init_decode_state(
            ref_cfg, 4, 16, kv_int8=kv_int8))
        pstate = init_decode_state(cfg, 4, 16, kv_int8=kv_int8, device="meta")
    for batch in (4, 3):
        assert (port_specs(port.decode_state_specs(pstate, pmesh, batch))
                == ref_specs(ref.decode_state_specs(rstate, rmesh, batch)))


@pytest.mark.parametrize("mesh_shape", [DEV_MESH, POD_MESH, PROD_MESH])
def test_batch_activation_and_logit_specs_equal_reference(mesh_shape):
    rmesh, pmesh = meshes(mesh_shape)
    assert port.dp_axes(pmesh) == ref.dp_axes(rmesh)
    for batch in (1, 3, 4, 32, 256):
        for rank in (2, 3):
            assert (tuple(port.train_batch_spec(pmesh, batch, rank=rank))
                    == tuple(ref.train_batch_spec(rmesh, batch, rank=rank)))
        for seq in (1, 7, 16, 4096):
            for shard in (True, False):
                assert (tuple(port.act_pspec(pmesh, batch, seq, seq_shard=shard))
                        == tuple(ref.act_pspec(rmesh, batch, seq, seq_shard=shard)))
            for vocab in (128, 151936, 151937):
                assert (tuple(port.logits_pspec(pmesh, batch, seq, vocab))
                        == tuple(ref.logits_pspec(rmesh, batch, seq, vocab)))


def test_partition_rules_tp_and_fsdp():
    """The reference's test_partition_rules_tp_and_fsdp on the port, and
    the whole tree equal to the reference's (16 x 16 mesh)."""
    rmesh, pmesh = meshes(PROD_MESH)
    ref_cfg, rshapes, cfg, pshapes = both_params("llama3-8b", full=True)
    specs = port.partition_params(pshapes, pmesh, n_experts=cfg.n_experts)
    assert port_specs(specs) == ref_specs(
        ref.partition_params(rshapes, rmesh, n_experts=cfg.n_experts))
    stack = specs["stacks"][0]
    assert stack["attn"]["wq"][-1] == "model"
    assert stack["attn"]["wo"][-2] == "model"
    assert stack["mlp"]["wg"][-1] == "model"
    assert stack["mlp"]["wd"][-2] == "model"
    assert "data" in tuple(stack["attn"]["wq"])
    assert tuple(stack["attn"]["wq"])[0] is None
    assert specs["emb"]["tok"][0] == "model"
    assert stack["norm1"][0] is None


def test_partition_rules_moe_ep_vs_tp():
    rmesh, pmesh = meshes(PROD_MESH)
    for arch, ep in (("llama4-scout-17b-a16e", True), ("qwen2-moe-a2.7b", False)):
        ref_cfg, rshapes, cfg, pshapes = both_params(arch, full=True)
        specs = port.partition_params(pshapes, pmesh, n_experts=cfg.n_experts)
        assert port_specs(specs) == ref_specs(
            ref.partition_params(rshapes, rmesh, n_experts=cfg.n_experts))
        moe = specs["stacks"][0]["moe"]
        if ep:      # 16 experts % 16 == 0: expert parallelism
            assert moe["wg"][1] == "model"
        else:       # 60 experts: TP inside the experts
            assert moe["wg"][1] is None and "model" in tuple(moe["wg"])


def test_divisibility_fallback_never_invalid():
    rmesh, pmesh = meshes(PROD_MESH)
    for arch in ("mamba2-780m", "recurrentgemma-9b", "internvl2-1b"):
        ref_cfg, rshapes, cfg, pshapes = both_params(arch, full=True)
        specs = port.partition_params(pshapes, pmesh, n_experts=cfg.n_experts)
        assert port_specs(specs) == ref_specs(
            ref.partition_params(rshapes, rmesh, n_experts=cfg.n_experts))
        for spec, leaf in zip(port_specs(specs), tree_leaves(pshapes)):
            for ax, dim in zip(spec, leaf.shape):
                if ax is not None:
                    n = (pmesh.shape[ax] if isinstance(ax, str)
                         else int(np.prod([pmesh.shape[a] for a in ax])))
                    assert dim % n == 0, (arch, spec, leaf.shape)


def test_decode_state_specs_shard_ctx():
    rmesh, pmesh = meshes(PROD_MESH)
    cfg = get_config("llama3-8b")
    state = init_decode_state(cfg, 128, 32768, device="meta")
    specs = port.decode_state_specs(state, pmesh, 128)
    kv = specs[0]
    assert kv["k"][2] == "model" and kv["k"][1] in ("data", ("data",))
    assert kv["len"] == port.PartitionSpec() == ()
    rstate = jax.eval_shape(lambda: ref_init_decode_state(
        ref_get_config("llama3-8b"), 128, 32768))
    assert port_specs(specs) == ref_specs(
        ref.decode_state_specs(rstate, rmesh, 128))


def test_specs_print_as_the_reference_prints_them():
    for dims in ((), (None,), (None, "model"), (("pod", "data"), None, "model")):
        assert repr(port.PartitionSpec(*dims)) == repr(P(*dims))
        assert port.PartitionSpec(*dims) == tuple(P(*dims))


def test_named_sharding_shapes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = port.Mesh((2, 2, 4), ("pod", "data", "model"))
    sh = port.NamedSharding(mesh, port.PartitionSpec(("pod", "data"), None, "model"))
    assert sh.shard_shape((8, 3, 16)) == (2, 3, 4)
    assert sh.placements() == [Shard(0), Shard(0), Shard(2)]
    assert port.NamedSharding(mesh, port.PartitionSpec()).placements() == \
        [Replicate()] * 3
    tree = port.named_tree({"a": port.PartitionSpec("data"),
                            "b": [port.PartitionSpec(None, "model")]}, mesh)
    assert tree["b"][0] == port.NamedSharding(mesh, port.PartitionSpec(None, "model"))
    with pytest.raises(ValueError):
        sh.place(torch.zeros(8, 3, 16))         # an arithmetic mesh


_RANKS = r"""
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.distributed.sharding import Mesh, PartitionSpec, named_tree
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import tree_leaves, tree_map
store, rank, ckdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
try:
    gen = torch.Generator().manual_seed(7)
    tree = {"w": torch.randn(8, 6, generator=gen),
            "b": [torch.randn(4, generator=gen), torch.randn(2, 3, generator=gen)]}
    mesh = Mesh((2, 1), ("data", "model"), device_type="cpu")
    specs = {"w": PartitionSpec("data", "model"), "b": [PartitionSpec("data"),
             PartitionSpec()]}
    placed = tree_map(lambda s, t: s.place(t), named_tree(specs, mesh), tree)
    # each rank holds its own slice of the sharded leaves
    assert placed["w"].to_local().shape == (4, 6)
    assert torch.equal(placed["w"].to_local(), tree["w"][4 * rank:4 * rank + 4])
    assert placed["b"][0].to_local().shape == (2,)
    assert placed["b"][1].to_local().shape == (2, 3)
    for got, want in zip(tree_leaves(placed), tree_leaves(tree)):
        assert torch.equal(got.full_tensor(), want)
    # elastic reshard: save under (data 2, model 1), restore onto
    # (data 1, model 2) with the spec transposed
    ck = CheckpointManager(ckdir, keep=2)
    ck.save(1, {"w": placed["w"]}, extra={"step": 1})
    ck.wait()
    mesh_b = Mesh((1, 2), ("data", "model"), device_type="cpu")
    target = named_tree({"w": PartitionSpec("model", "data")}, mesh_b)
    like = {"w": target["w"].place(torch.zeros(8, 6))}
    got, manifest = ck.restore(like)
    assert got["w"].device_mesh is mesh_b.device_mesh
    assert got["w"].to_local().shape == (4, 6)
    assert torch.equal(got["w"].full_tensor(), tree["w"])
    assert manifest["extra"]["step"] == 1
finally:
    dist.destroy_process_group()
print("OK", rank)
"""


def test_named_tree_places_dtensors_and_checkpoints_reshard(tmp_path):
    """Two gloo ranks: a tree placed by named_tree reads back equal, each
    rank holding its slice; a checkpoint saved under one mesh layout
    restores onto another (tests/test_distributed.py's elastic test)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS, str(tmp_path / "store"), str(r),
         str(tmp_path / f"ck{r}")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-3000:]
            assert f"OK {r}" in out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
