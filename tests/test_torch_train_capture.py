"""The trainer's static-buffer step (the port of the reference's jitted
train step) held to the live reference on the CPU, and its state contract.

On the CPU the step runs op by op on the same fixed buffers that the
card's CUDA graph reads and writes (``repro_torch.train.capture``); the
graph itself needs the card (``tests/test_torch_cuda.py``).  Six steps
with per-layer pruning every 2 steps and 16-bit LSQ against the
reference's jitted ``SNNTrainer``: logged losses within 1e-4, params,
optimizer moments and LSQ scales within 1e-5, masks and the evaluated
accuracy equal.  The contract: a tree read from the trainer never changes
after later steps, and an assigned tree takes effect at the next step.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (
    TRAIN_DENSITY,
    TRAIN_SPEC,
    SNNConfig,
    port_leaves,
    port_trainer,
    ref_leaves,
    ref_trainer,
)
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro_torch.api import compile_snn
from repro_torch.train import SNNTrainer, TrainerConfig, lsq
from repro_torch.train.capture import StaticStep, TrainState
from repro_torch.tree import tree_leaves, tree_map

QUANT = dict(use_lsq=True, per_layer_density=TRAIN_DENSITY, prune_every=2)


@pytest.fixture(scope="module")
def ref_quant():
    """A reference trainer with pruning and LSQ, its initial state kept."""
    ref = ref_trainer(**QUANT)
    return ref, {"params": ref.params, "lsq": ref.lsq_scales}


def _copy(tree):
    return [x.clone() for x in tree_leaves(tree)]


def _equal(tree, leaves) -> bool:
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), leaves))


def test_static_buffer_steps_match_the_reference_jitted_trainer(ref_quant):
    ref, start = ref_quant
    tr = port_trainer(start["params"], start["lsq"], **QUANT)
    assert not tr.capture          # the CPU: op by op on the buffers
    r_hist = ref.run(steps=6, log_every=1)
    p_hist = tr.run(steps=6, log_every=1)
    np.testing.assert_allclose(p_hist["loss"], r_hist["loss"], rtol=0,
                               atol=1e-4)
    for got, want in ((tr.params, ref.params), (tr.lsq_scales, ref.lsq_scales),
                      (tr.opt_state.mu, ref.opt_state.mu),
                      (tr.opt_state.nu, ref.opt_state.nu)):
        for a, b in zip(port_leaves(got), ref_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert int(tr.opt_state.step) == int(ref.opt_state.step) == 6
    for a, b in zip(port_leaves(tr.masks), ref_leaves(ref.masks)):
        np.testing.assert_array_equal(a, b)
    # one variant (masks on, one batch shape) across the three reprunes
    assert tr._steps.keys() == ((True, (4, 2, 2, 128)),)
    assert tr.evaluate(n_batches=2, snr_db=10.0) == \
        ref.evaluate(n_batches=2, snr_db=10.0)


def test_a_tree_read_before_a_step_is_unchanged_after_it():
    tr = port_trainer(**QUANT)
    tr.run(steps=1)
    trees = {"params": tr.params, "opt": tr.opt_state,
             "lsq": tr.lsq_scales, "masks": tr.masks}
    copies = {k: _copy(v) for k, v in trees.items()}
    assert tr.params is trees["params"]        # one copy until the next step
    tr.run(steps=2)
    for name, tree in trees.items():
        assert _equal(tree, copies[name]), name
    assert not _equal(tr.params, copies["params"])    # the steps moved them
    assert int(tr.opt_state.step) == 3 and int(trees["opt"].step) == 1


def test_assigned_params_take_effect_at_the_next_step():
    tr = port_trainer(**QUANT)
    other = port_trainer(seed=5)
    params = tree_map(torch.clone, other.params)
    tr.params = params
    tr.opt_state = tr.opt_init(params)
    frames, labels, _ = tr._batch(tr.cfg.seed * 7_919, tr.cfg.snr_db)
    tr._maybe_reprune()
    want = tr._train_step(tr.params, tr.opt_state, tr.lsq_scales, tr.masks,
                          frames, labels)
    tr.run(steps=1, log_every=1)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tr.params), tree_leaves(want[0])))
    # the assigned tree itself is left as it was
    assert _equal(params, _copy(other.params))


def test_evaluate_on_the_buffers_equals_the_dense_plan():
    tr = port_trainer(**QUANT)
    tr.run(steps=2)
    frames, _ = tr._host_batch(10_000, 10.0)
    got = tr._eval_logits(frames, True)
    want = compile_snn(tr.model_cfg).apply_batch(
        tr.params, frames, "dense", masks=tr.masks, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert tr._evals.keys() == ((True, frames.shape),)


def test_resume_copies_the_checkpoint_into_the_buffers(tmp_path):
    a = port_trainer(ckpt_dir=str(tmp_path), ckpt_every=2, **QUANT)
    a.run(steps=2)
    b = port_trainer(ckpt_dir=str(tmp_path), **QUANT)
    b.run(steps=1)                      # buffers hold another state
    assert b.resume() and b.step == 2
    a.run(steps=2, log_every=1)
    b.run(steps=2, log_every=1)
    for x, y in zip(tree_leaves(a._state_tree()), tree_leaves(b._state_tree())):
        assert torch.equal(x, y)


def test_capture_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        StaticStep(torch.device("cpu"), capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        SNNTrainer(SNNConfig(**TRAIN_SPEC), TrainerConfig(), device="cpu",
                   capture=True)


def test_state_rejects_an_assigned_tree_of_another_shape():
    state = TrainState(torch.device("cpu"))
    state.set("params", {"w": torch.zeros(3)})
    bufs = state.buffers()
    state.set("params", {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="does not match"):
        state.buffers()
    state.set("params", {"w": torch.ones(3)})
    assert state.buffers()["params"]["w"] is bufs["params"]["w"]
    assert torch.equal(bufs["params"]["w"], torch.ones(3))


def test_static_step_copies_inputs_into_fixed_buffers():
    step = StaticStep(torch.device("cpu"), capture=False)
    seen = []

    def fn(inp, commit):
        seen.append(inp["x"])
        return inp["x"] * 2

    for v in (1.0, 2.0):
        out = step("k", {"x": np.full((2,), v, np.float32)}, fn)
        assert torch.equal(out, torch.full((2,), 2 * v))
    assert seen[0] is seen[1] and step.keys() == ("k",)


def test_lsq_grad_scale_is_filled_on_the_device_with_the_same_value():
    w = torch.randn(37, 5)
    got = lsq._grad_scale(w, 2 ** 15 - 1)
    n = torch.tensor(float(w.numel()), dtype=torch.float32)
    assert torch.equal(got, 1.0 / torch.sqrt(n * (2 ** 15 - 1)))
