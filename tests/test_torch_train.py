"""The port's training path held to the live reference (CPU).

Data: ``generate_batch``, ``RadioMLDataset`` and ``SpikeBatchPipeline``
bit-equal to ``repro.data``.  Pruning: the schedule and every mask equal.
Optimizers: AdamW and SGD updates within 1e-7 over 3 steps, in the same
leaf order; the clip within 1e-7.  Trainer: one ``_train_step`` (dense,
masked, masked + LSQ) with the loss within 1e-5, the accuracy equal and
every updated param and LSQ-scale leaf within 1e-6; ``run`` with
per-layer pruning and LSQ with the logged losses within 1e-4, the final
params within 1e-5 and the masks equal; ``evaluate`` equal.  Gradients:
the surrogate bit-equal to ``jax``'s, the max-pool gradient on tied
windows equal to ``jax.grad``'s.

The port runs the batch at once where the reference ``vmap``s one sample
at a time: the same math, summed in another order, hence the
tolerances.  Weights come from the reference (``tests/_torch_parity.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    TRAIN_DENSITY,
    TRAIN_SPEC,
    params_to_numpy,
    port_leaves,
    port_trainer,
    ref_leaves,
    ref_trainer,
    t,
)
from _torch_parity import port_plan_cache_in_memory  # noqa: F401
from repro.core import lif as ref_lif
from repro.core.saocds import max_pool_spikes as ref_max_pool
from repro.data import pipeline as ref_pipeline
from repro.data import radioml as ref_radioml
from repro.models import snn as ref_snn
from repro.train import lsq as ref_lsq
from repro.train import optimizer as ref_opt
from repro.train import pruning as ref_pruning
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.core.lif import spike
from repro_torch.core.saocds import max_pool_spikes
from repro_torch.data import pipeline, radioml
from repro_torch.launch import train as launch_train
from repro_torch.models import snn
from repro_torch.train import lsq, optimizer, pruning
from repro_torch.train.trainer import SNNTrainer, TrainerConfig
from repro_torch.tree import tree_leaves, tree_unflatten

# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("snr_db", [None, 10.0])
@pytest.mark.parametrize("apply_channel", [True, False])
@pytest.mark.parametrize("classes", [None, (0, 3, 5, 8, 10)],
                         ids=["all", "five"])
def test_generate_batch_bit_equal(seed, snr_db, apply_channel, classes):
    got = radioml.generate_batch(seed, 6, snr_db, classes=classes,
                                 apply_channel=apply_channel)
    want = ref_radioml.generate_batch(seed, 6, snr_db, classes=classes,
                                      apply_channel=apply_channel)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_dataset_constants_and_stream_bit_equal():
    assert radioml.MODULATIONS == ref_radioml.MODULATIONS
    assert radioml.N_CLASSES == ref_radioml.N_CLASSES
    assert radioml.SNR_GRID == ref_radioml.SNR_GRID
    np.testing.assert_array_equal(
        radioml.generate_sample(5, "QAM16", 4.0, frame_len=64),
        ref_radioml.generate_sample(5, "QAM16", 4.0, frame_len=64))
    got = iter(radioml.RadioMLDataset(4, seed=3, snr_db=None, frame_len=64))
    want = iter(ref_radioml.RadioMLDataset(4, seed=3, snr_db=None,
                                           frame_len=64))
    for _ in range(3):
        for g, w in zip(next(got), next(want)):
            np.testing.assert_array_equal(g, w)


def test_pipeline_batches_equal_reference_encoded_stream():
    pipe = pipeline.SpikeBatchPipeline(batch_size=4, osr=3, seed=2,
                                       snr_db=10.0, prefetch=2)
    try:
        want = iter(ref_radioml.RadioMLDataset(4, seed=2, snr_db=10.0))
        for _ in range(2):
            frames, labels, snrs = next(pipe)
            iq, w_labels, w_snrs = next(want)
            np.testing.assert_array_equal(
                frames, ref_pipeline.sigma_delta_encode_np(iq, 3))
            np.testing.assert_array_equal(labels, w_labels)
            np.testing.assert_array_equal(snrs, w_snrs)
    finally:
        pipe.close()


def test_pipeline_on_a_device_yields_tensors_and_refuses_scenarios():
    pipe = pipeline.SpikeBatchPipeline(batch_size=2, osr=2, device="cpu",
                                       prefetch=1)
    try:
        frames, labels, _ = next(pipe)
        assert isinstance(frames, torch.Tensor) and frames.shape == (2, 2, 2, 128)
        assert isinstance(labels, torch.Tensor) and labels.shape == (2,)
    finally:
        pipe.close()
    with pytest.raises(NotImplementedError, match="channel"):
        pipeline.SpikeBatchPipeline(batch_size=2, scenario="static_awgn")


def test_pipeline_yields_batches_then_stops_after_close():
    """``__next__`` must raise ``StopIteration`` after ``close()``, not block
    on the empty queue of a stopped producer (the reference's contract)."""
    import threading

    pipe = pipeline.SpikeBatchPipeline(batch_size=4, osr=3, prefetch=2)
    frames, labels, _ = next(pipe)
    assert frames.shape == (4, 3, 2, 128) and labels.shape == (4,)
    pipe.close()
    outcome = {}

    def consume():
        try:
            while True:
                next(pipe)
        except StopIteration:
            outcome["stopped"] = True

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(timeout=5.0)
    assert not th.is_alive() and outcome.get("stopped"), \
        "consumer hung after close()"
    with pytest.raises(StopIteration):
        next(pipe)


# ---------------------------------------------------------------------------
# Pruning, model helpers, LSQ init.
# ---------------------------------------------------------------------------


def test_target_density_schedule_equal():
    for total in (6, 40, 300):
        for final in (0.05, 0.25, 0.5):
            for step in range(total + 2):
                assert pruning.target_density_at(step, total, final) == \
                    ref_pruning.target_density_at(step, total, final)


@pytest.mark.parametrize("density", [1.0, 0.5, 0.2, 0.05])
def test_magnitude_and_block_masks_equal(density):
    rng = np.random.default_rng(int(density * 100))
    w = rng.normal(size=(11, 16, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        pruning.magnitude_masks(t(w), density).numpy(),
        np.asarray(ref_pruning.magnitude_masks(jnp.asarray(w), density)))
    for block in ((8, 128), (4, 32)):
        got = pruning.block_magnitude_masks(t(w), density, *block).numpy()
        want = np.asarray(ref_pruning.block_magnitude_masks(
            jnp.asarray(w), density, *block))
        np.testing.assert_array_equal(got, want)


def test_mask_density_param_count_and_density_report_equal():
    ref_params = ref_snn.init_snn(jax.random.PRNGKey(4),
                                  ref_snn.SNNConfig(**TRAIN_SPEC))
    ref_masks = ref_pruning.make_mask_pytree(ref_params, TRAIN_DENSITY)
    params = params_from_numpy(params_to_numpy(ref_params))
    masks = masks_from_numpy({g: [np.asarray(m) for m in ref_masks[g]]
                              for g in ("conv", "fc")})
    assert pruning.mask_density(masks) == ref_pruning.mask_density(ref_masks)
    assert snn.param_count(params) == ref_snn.param_count(ref_params)
    assert snn.density_report(params, masks) == \
        ref_snn.density_report(ref_params, ref_masks)
    assert snn.density_report(params) == ref_snn.density_report(ref_params)


def test_lsq_scales_have_the_reference_structure():
    """The checkpoint's leaf order depends on it: {"conv": [...], "fc":
    [...]} of 0-d float32 scalars."""
    ref_params = ref_snn.init_snn(jax.random.PRNGKey(1),
                                  ref_snn.SNNConfig(**TRAIN_SPEC))
    want = ref_lsq.init_lsq_scales(ref_params, 16)
    got = lsq.init_lsq_scales(params_from_numpy(params_to_numpy(ref_params)), 16)
    assert sorted(got) == sorted(want)
    for g in ("conv", "fc"):
        assert len(got[g]) == len(want[g])
        for a, b in zip(got[g], want[g]):
            assert a.shape == b.shape == () and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers.
# ---------------------------------------------------------------------------


def _opt_trees(seed):
    """A reference param pytree, the port's copy, and 3 gradient trees."""
    ref_params = ref_snn.init_snn(jax.random.PRNGKey(seed),
                                  ref_snn.SNNConfig(**TRAIN_SPEC))
    params = params_from_numpy(params_to_numpy(ref_params))
    rng = np.random.default_rng(seed)
    grads = [[rng.normal(size=x.shape).astype(np.float32)
              for x in ref_leaves(ref_params)] for _ in range(3)]
    return ref_params, params, grads


_OPTS = {
    "adamw": lambda m: m.adamw(2e-3, weight_decay=1e-4),
    "adamw_schedule": lambda m: m.adamw(lambda step: 1e-3, weight_decay=0.0),
    "sgd": lambda m: m.sgd(1e-2, momentum=0.9),
    "sgd_nesterov": lambda m: m.sgd(1e-2, momentum=0.9, nesterov=True),
}


@pytest.mark.parametrize("name", sorted(_OPTS))
def test_optimizer_updates_match_reference_over_three_steps(name):
    ref_params, params, grads = _opt_trees(3)
    r_init, r_update = _OPTS[name](ref_opt)
    p_init, p_update = _OPTS[name](optimizer)
    r_state, p_state = r_init(ref_params), p_init(params)
    # same leaf order: the port walks its tree as jax walks the reference's
    np.testing.assert_array_equal(
        np.concatenate([x.ravel() for x in port_leaves(params)]),
        np.concatenate([x.ravel() for x in ref_leaves(ref_params)]))
    assert len(port_leaves(p_state)) == len(ref_leaves(r_state))
    for g in grads:
        r_g = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(ref_params), [jnp.asarray(x) for x in g])
        p_g = tree_unflatten(params, [t(x) for x in g])
        r_upd, r_state = r_update(r_g, r_state, ref_params)
        with torch.no_grad():
            p_upd, p_state = p_update(p_g, p_state, params)
        for a, b in zip(port_leaves(p_upd), ref_leaves(r_upd)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
        ref_params = ref_opt.apply_updates(ref_params, r_upd)
        params = optimizer.apply_updates(params, p_upd)
    for a, b in zip(port_leaves(p_state), ref_leaves(r_state)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    for a, b in zip(port_leaves(params), ref_leaves(ref_params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_reference(max_norm):
    ref_params, params, grads = _opt_trees(5)
    r_g = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref_params), [jnp.asarray(x) for x in grads[0]])
    p_g = tree_unflatten(params, [t(x) for x in grads[0]])
    r_out, r_norm = ref_opt.clip_by_global_norm(r_g, max_norm)
    p_out, p_norm = optimizer.clip_by_global_norm(p_g, max_norm)
    np.testing.assert_allclose(float(p_norm), float(r_norm), rtol=1e-6)
    for a, b in zip(port_leaves(p_out), ref_leaves(r_out)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(optimizer.global_norm(p_g)),
                               float(ref_opt.global_norm(r_g)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Gradients of the forward's pieces.
# ---------------------------------------------------------------------------


def test_surrogate_gradient_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    u = rng.normal(scale=2.0, size=4096).astype(np.float32)
    g = rng.normal(size=4096).astype(np.float32)
    ut = t(u).requires_grad_()
    spike(ut).backward(t(g))
    _, vjp = jax.vjp(ref_lif.spike, jnp.asarray(u))
    np.testing.assert_array_equal(ut.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("fill", ["ones", "zeros", "mixed"])
def test_max_pool_gradient_on_tied_windows_equals_jax(fill):
    """Spikes are {0, 1}, so pool windows tie: jax splits the gradient
    equally among the tied entries, and so must the port."""
    rng = np.random.default_rng(1)
    shape = (3, 4, 16)
    x = {"ones": np.ones(shape), "zeros": np.zeros(shape),
         "mixed": (rng.random(shape) < 0.5)}[fill].astype(np.float32)
    r = rng.normal(size=(3, 4, 8)).astype(np.float32)
    xt = t(x).requires_grad_()
    (max_pool_spikes(xt, 2) * t(r)).sum().backward()
    want = jax.grad(lambda a: (ref_max_pool(a, 2) * r).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_dense_bind_gradient_reaches_every_weight_lif_and_lsq_scale():
    ref_params = ref_snn.init_snn(jax.random.PRNGKey(6),
                                  ref_snn.SNNConfig(**TRAIN_SPEC))
    tr = port_trainer(ref_params, ref_lsq.init_lsq_scales(ref_params),
                      use_lsq=True)
    masks = pruning.make_mask_pytree(tr.params, TRAIN_DENSITY)
    frames, labels, _ = tr._batch(11, 10.0)
    _, _, g_params, g_scales, _ = tr._gradients(tr.params, tr.lsq_scales, masks,
                                                frames, labels)
    for group in ("conv", "fc"):
        for g, m in zip(g_params[group], masks[group]):
            assert float(g["w"].abs().sum()) > 0
            assert bool((g["w"][m == 0] == 0).all())
        for s in g_scales[group]:
            assert float(s.abs()) > 0
    assert float(g_params["conv"][0]["lif"].v_th.abs().sum()) > 0


# ---------------------------------------------------------------------------
# The trainer.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def refs():
    """Two reference trainers (jax compiles each step once): a dense one,
    and one with per-layer pruning and LSQ whose initial state is kept."""
    plain = ref_trainer()
    quant = ref_trainer(use_lsq=True, per_layer_density=TRAIN_DENSITY,
                        prune_every=2)
    start = {"params": quant.params, "opt": quant.opt_state,
             "lsq": quant.lsq_scales}
    return {"plain": plain, "quant": quant, "quant_start": start}


def _batch(seed):
    iq, labels, _ = ref_radioml.generate_batch(seed, 4, 10.0, frame_len=128)
    return ref_pipeline.sigma_delta_encode_np(iq, 2), labels


@pytest.mark.parametrize("mode", ["dense", "masked", "masked_lsq"])
def test_one_train_step_matches_reference(refs, mode):
    if mode == "masked_lsq":
        ref, start = refs["quant"], refs["quant_start"]
        r_params, r_opt, r_lsq = start["params"], start["opt"], start["lsq"]
        tr = port_trainer(r_params, r_lsq, use_lsq=True,
                          per_layer_density=TRAIN_DENSITY, prune_every=2)
    else:
        ref = refs["plain"]
        r_params, r_opt, r_lsq = ref.params, ref.opt_state, None
        tr = port_trainer(r_params)
    use_masks = mode != "dense"
    r_masks = (ref_pruning.make_mask_pytree(r_params, TRAIN_DENSITY)
               if use_masks else None)
    masks = (masks_from_numpy({g: [np.asarray(m) for m in r_masks[g]]
                               for g in ("conv", "fc")}) if use_masks else None)
    frames, labels = _batch(21)
    r_out = ref._jit_step(r_params, r_opt, r_lsq, r_masks, jnp.asarray(frames),
                          jnp.asarray(labels), use_masks=use_masks)
    p_out = tr._train_step(tr.params, tr.opt_state, tr.lsq_scales, masks,
                           t(frames), torch.from_numpy(labels.astype(np.int64)))
    assert abs(float(p_out[3]) - float(r_out[3])) <= 1e-5
    assert float(p_out[4]) == float(r_out[4])
    for a, b in zip(port_leaves(p_out[0]), ref_leaves(r_out[0])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    if mode == "masked_lsq":
        for a, b in zip(port_leaves(p_out[2]), ref_leaves(r_out[2])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert int(p_out[1].step) == int(r_out[1].step) == 1
    if use_masks:
        # a pruned weight gets no gradient, so its update is the weight
        # decay alone: the same float32 ops, bit-equal; its effective
        # weight is exactly zero
        for group in ("conv", "fc"):
            for lp, rp, m in zip(p_out[0][group], r_out[0][group], masks[group]):
                pruned = (m == 0).numpy()
                np.testing.assert_array_equal(lp["w"].numpy()[pruned],
                                              np.asarray(rp["w"])[pruned])
                assert bool(((lp["w"] * m)[m == 0] == 0).all())


def test_run_with_pruning_and_lsq_matches_reference(refs):
    """Six steps with per-layer pruning every 2 steps and LSQ: logged
    losses within 1e-4, final params within 1e-5, masks and the
    evaluated accuracy equal."""
    ref = refs["quant"]
    start = refs["quant_start"]
    assert ref.step == 0
    tr = port_trainer(start["params"], start["lsq"], use_lsq=True,
                      per_layer_density=TRAIN_DENSITY, prune_every=2)
    r_hist = ref.run(steps=6, log_every=1)
    p_hist = tr.run(steps=6, log_every=1)
    assert p_hist["step"] == r_hist["step"] == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose(p_hist["loss"], r_hist["loss"], rtol=0, atol=1e-4)
    assert len(set(np.round(r_hist["loss"], 4))) > 1    # the network is live
    for a, b in zip(port_leaves(tr.params), ref_leaves(ref.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for a, b in zip(port_leaves(tr.masks), ref_leaves(ref.masks)):
        np.testing.assert_array_equal(a, b)
    assert pruning.mask_density(tr.masks) == ref_pruning.mask_density(ref.masks)
    assert tr.evaluate(n_batches=2, snr_db=10.0) == \
        ref.evaluate(n_batches=2, snr_db=10.0)


def test_class_subset_rule_for_reduced_configs():
    spec = dict(TRAIN_SPEC, fc_specs=((8 * 16, 16), (16, 5)), n_classes=5)
    tr = SNNTrainer(snn.SNNConfig(**spec),
                    TrainerConfig(total_steps=2, batch_size=8, osr=2),
                    device="cpu")
    assert tr._classes == (0, 1, 2, 3, 4)
    _, labels, _ = tr._batch(3, None)
    assert labels.max() < 5
    assert port_trainer()._classes is None


def test_trainer_and_launcher_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNNTrainer(snn.SNNConfig(**TRAIN_SPEC), TrainerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "saocds-amc", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="channel"):
        SNNTrainer(snn.SNNConfig(**TRAIN_SPEC),
                   TrainerConfig(augment_scenario="static_awgn"), device="cpu")


def test_launcher_trains_on_the_cpu_and_refuses_other_archs(tmp_path, capsys):
    rc = launch_train.main(["--arch", "saocds-amc", "--device", "cpu",
                            "--steps", "2", "--batch", "4", "--lsq",
                            "--density", "0.5", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "final loss" in out and "acc@10dB" in out
    assert (tmp_path / "step_2" / "manifest.json").exists()
    assert launch_train.main(["--arch", "llama3-8b", "--device", "cpu"]) != 0
    assert "model zoo" in capsys.readouterr().err


def test_port_tree_order_is_jax_order():
    """Sorted dict keys, LIF fields in (alpha_logit, theta, v_th) order,
    AdamWState as (step, mu, nu), None with no leaves."""
    ref = ref_snn.init_snn(jax.random.PRNGKey(2), ref_snn.SNNConfig(**TRAIN_SPEC))
    params = params_from_numpy(params_to_numpy(ref))
    state = {"params": params, "opt": optimizer.adamw(1e-3)[0](params),
             "masks": None, "lsq": lsq.init_lsq_scales(params)}
    r_state = {"params": ref, "opt": ref_opt.adamw(1e-3)[0](ref),
               "masks": None, "lsq": ref_lsq.init_lsq_scales(ref)}
    got, want = port_leaves(state), ref_leaves(r_state)
    assert [a.shape for a in got] == [b.shape for b in want]
    assert [a.dtype for a in got] == [b.dtype for b in want]
    n_lsq = len(tree_leaves(state["lsq"]))
    for a, b in zip(got[n_lsq:], want[n_lsq:]):
        np.testing.assert_array_equal(a, b)
