"""The port's checkpoints: the reference's contracts, and one on-disk format
for both packages (CPU).

Atomic save, async save with errors on ``wait()``, keep-N GC, latest by
default, half-written checkpoints invisible, structure mismatches
rejected, restore onto an explicit device; the port's trainer resumes bit
for bit; a checkpoint the reference's trainer saves resumes in the port's
with every leaf bit-equal, and one the port saves restores in the
reference's ``CheckpointManager`` to the same arrays.
"""
import os

import numpy as np
import pytest
import torch

from _torch_parity import (
    TRAIN_DENSITY,
    port_leaves,
    port_trainer,
    ref_leaves,
    ref_trainer,
)
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch.core.lif import LIFParams
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import adamw
from repro_torch.tree import tree_leaves


def _tree(seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    params = {"w": f(8, 4),
              "nested": {"b": f(4), "lif": LIFParams(f(4, 1), f(4, 1), f(4, 1))}}
    return {"params": params, "opt": adamw(1e-3)[0](params), "masks": None,
            "step": torch.tensor(3, dtype=torch.int32)}


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _tree()
    mgr.save(10, tree, extra={"note": "x"})
    restored, manifest = mgr.restore(tree)
    _assert_trees_equal(tree, restored)
    assert isinstance(restored["params"]["nested"]["lif"], LIFParams)
    assert type(restored["opt"]).__name__ == "AdamWState"
    assert restored["opt"].step.dtype == torch.int32
    assert restored["masks"] is None
    assert manifest["step"] == 10 and manifest["extra"]["note"] == "x"
    # sorted keys ("masks" has no leaves): the first leaf is opt's step
    assert mgr.read_manifest()["leaves"]["leaf_00000"] == {"shape": [],
                                                          "dtype": "int32"}


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = _tree()
    saved = tree["params"]["w"].clone()
    mgr.save(1, tree)
    tree["params"]["w"].add_(1.0)   # the host copy was taken before save returned
    mgr.wait()
    assert mgr.all_steps() == [1]
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["params"]["w"], saved)


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=True)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []
    mgr.wait()   # the error was surfaced once


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_restore_latest_by_default(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t1, t2 = _tree(1), _tree(2)
    mgr.save(1, t1)
    mgr.save(5, t2)
    restored, manifest = mgr.restore(t1)
    assert manifest["step"] == 5 and mgr.latest_step() == 5
    assert torch.equal(restored["params"]["w"], t2["params"]["w"])


def test_half_written_checkpoint_invisible(tmp_path):
    """A crash mid-save (tmp dir left behind) must not corrupt discovery."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    os.makedirs(tmp_path / ".tmp.step_9")
    os.makedirs(tmp_path / "step_7")
    assert mgr.all_steps() == [1]
    _, manifest = mgr.restore(_tree())
    assert manifest["step"] == 1


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    bad_shape = _tree()
    bad_shape["params"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(bad_shape)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"only": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree())


def test_restore_onto_an_explicit_device(tmp_path):
    """Checkpoints hold unplaced host arrays: a restore places every leaf
    on the device it is given, whatever device the like-tree is on."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _tree()
    mgr.save(1, tree)
    like = _tree(9)
    restored, _ = mgr.restore(like, device=torch.device("cpu"))
    assert all(x.device.type == "cpu" for x in tree_leaves(restored))
    _assert_trees_equal(tree, restored)


_QUANT = dict(use_lsq=True, per_layer_density=TRAIN_DENSITY, prune_every=2)


def test_port_trainer_resume_bitwise_identical(tmp_path):
    """Train 6 steps with checkpoints at 3 and 6; a new trainer resumes at
    3, trains 3 more and matches every leaf bit for bit."""
    a = port_trainer(ckpt_dir=str(tmp_path), ckpt_every=3, **_QUANT)
    a.run(steps=6, log_every=3)
    assert a.ckpt.all_steps() == [3, 6]
    b = port_trainer(ckpt_dir=str(tmp_path), ckpt_every=3, **_QUANT)
    assert b.resume(step=3) and b.step == 3
    b.run(steps=3, log_every=3)
    assert b.step == a.step == 6
    for x, y in zip(port_leaves(a._state_tree()), port_leaves(b._state_tree())):
        np.testing.assert_array_equal(x, y)
    c = port_trainer(ckpt_dir=str(tmp_path), ckpt_every=3, **_QUANT)
    assert c.resume() and c.step == 6


def test_checkpoints_cross_between_packages(tmp_path):
    """The reference trainer saves; the port's trainer resumes every leaf
    bit-equal (params, AdamWState, masks, LSQ scales).  The port then
    trains and saves; the reference's manager restores the same arrays."""
    ref = ref_trainer(ckpt_dir=str(tmp_path / "ref"), ckpt_every=2, **_QUANT)
    ref.run(steps=2, log_every=2)
    port = port_trainer(ckpt_dir=str(tmp_path / "ref"), **_QUANT)
    assert port.resume() and port.step == 2
    got, want = port_leaves(port._state_tree()), ref_leaves(ref._state_tree())
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert int(port.opt_state.step) == 2 and port.opt_state.step.dtype == torch.int32

    port.ckpt = type(port.ckpt)(str(tmp_path / "port"))
    port.run(steps=1, log_every=1)
    restored, manifest = RefCheckpointManager(str(tmp_path / "port")).restore(
        ref._state_tree())
    assert manifest["step"] == 3 and manifest["extra"]["step"] == 3
    for x, y in zip(port_leaves(port._state_tree()), ref_leaves(restored)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
