"""The port's LM trainer and zoo entry points against the reference, on
the CPU.

* ``LMTrainer``: the port and the reference start from the reference's
  params (carried by ``repro_torch.convert.lm_params_from_numpy``, the
  optimizer state rebuilt from them), take three steps on the same token
  stream and stub inputs, and agree within 1e-5 relative: every loss, and
  every params leaf in relative norm.
* A checkpoint the reference saves resumes in the port with the same step
  and equal leaves, and the other way round.
* ``launch.train`` trains every architecture with ``--device cpu``;
  ``launch.serve`` generates for the 9 decoder architectures and returns
  1 for ``whisper-large-v3``; ``examples.lm_pretrain`` resumes bit-equal.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs.registry import reduced_config as ref_reduced_config
from repro.launch.train import LMTrainer as RefLMTrainer
from repro.launch import serve as ref_serve
from repro.models.lm import init_lm as ref_init_lm
from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import lm_pretrain
from repro_torch.launch import serve, train
from repro_torch.launch.train import LMTrainer
from repro_torch.models.lm import init_lm
from repro_torch.tree import tree_leaves

from _torch_parity import exact_zero_grad, leaf_names

STEPS = 3
BATCH, SEQ = 2, 16


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **kw):
    ref = RefLMTrainer(ref_reduced_config(arch), lr=5e-3, batch=BATCH, seq=SEQ,
                       **kw)
    port = LMTrainer(reduced_config(arch), lr=5e-3, batch=BATCH, seq=SEQ,
                     device="cpu", **kw)
    port.params = lm_params_from_numpy(to_np(ref.params))
    port.opt_state = port.opt_init(port.params)
    return ref, port


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_three_steps_match_the_reference_trainer(arch):
    """Three steps, one at a time, each from the same state: every loss
    within 1e-5 relative, the params tree within 1e-5 in relative norm,
    and each leaf the reference initialised away from zero (weights,
    norms) within 1e-5 too.  A zero-initialised bias is held only as part
    of the tree: AdamW normalises each gradient component, so a component
    near its eps (1e-8) moves the bias by up to lr either way on rounding
    noise alone.  The leaves whose gradient is zero in exact arithmetic
    (``exact_zero_grad``) are copied from the reference after each step (with
    their moments), so their noise does not compound: a top-1 router that
    drifted would route tokens differently."""
    ref, port = _pair(arch)
    names = leaf_names(port.params)
    init_zero = [not np.any(np.asarray(w))
                 for w in jax.tree_util.tree_leaves(ref.params)]
    for step in range(1, STEPS + 1):
        want = ref.run(1, log_every=1)
        got = port.run(1, log_every=1)
        assert got["step"] == want["step"] == [step]
        assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5 * abs(want["loss"][0])
        ref_leaves = [np.asarray(w) for w in jax.tree_util.tree_leaves(ref.params)]
        port_leaves = tree_leaves(port.params)
        assert len(ref_leaves) == len(port_leaves) == len(names)
        assert _rel(np.concatenate([g.numpy().ravel() for g in port_leaves]),
                    np.concatenate([w.ravel() for w in ref_leaves])) <= 1e-5
        for name, zero, g, w in zip(names, init_zero, port_leaves, ref_leaves):
            if not zero and not exact_zero_grad(port.cfg, name):
                assert _rel(g.numpy(), w) <= 1e-5, (step, name)
        moments = zip(tree_leaves(port.opt_state.mu), tree_leaves(port.opt_state.nu),
                      jax.tree_util.tree_leaves(ref.opt_state.mu),
                      jax.tree_util.tree_leaves(ref.opt_state.nu))
        for name, g, w, (mu, nu, rmu, rnu) in zip(names, port_leaves, ref_leaves,
                                                  moments):
            if exact_zero_grad(port.cfg, name):
                for t, a in ((g, w), (mu, rmu), (nu, rnu)):
                    t.copy_(torch.from_numpy(np.array(a)))
    assert int(port.opt_state.step) == int(ref.opt_state.step) == STEPS


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-1b",
                                  "whisper-large-v3"])
def test_stub_inputs_are_the_reference_draws(arch):
    ref, port = _pair(arch)
    want = ref._extra(np.random.default_rng(17))
    got = port.extra(np.random.default_rng(17))
    if want is None:
        assert got is None
        return
    assert str(got.dtype).rsplit(".", 1)[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m"])
def test_checkpoints_cross_load_both_ways(tmp_path, arch):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    # the reference saves; the port resumes
    ref = RefLMTrainer(ref_reduced_config(arch), lr=5e-3, batch=BATCH, seq=SEQ,
                       ckpt_dir=ref_dir)
    ref.run(2, log_every=2)
    port = LMTrainer(reduced_config(arch), lr=5e-3, batch=BATCH, seq=SEQ,
                     ckpt_dir=ref_dir, device="cpu")
    assert port.resume() and port.step == ref.step == 2
    want = jax.tree_util.tree_leaves({"params": ref.params, "opt": ref.opt_state})
    got = tree_leaves({"params": port.params, "opt": port.opt_state})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the port saves; the reference resumes
    port.ckpt = train.CheckpointManager(port_dir)
    port.run(1, log_every=1)
    ref2 = RefLMTrainer(ref_reduced_config(arch), lr=5e-3, batch=BATCH, seq=SEQ,
                        ckpt_dir=port_dir)
    assert ref2.resume() and ref2.step == port.step == 3
    want = tree_leaves({"params": port.params, "opt": port.opt_state})
    got = jax.tree_util.tree_leaves({"params": ref2.params, "opt": ref2.opt_state})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_train_trains_every_arch_on_the_cpu(arch, capsys):
    rc = train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "16"])
    assert rc == 0
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_serve_generates_on_the_cpu(arch, capsys):
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4"]
    rc = serve.main(argv)
    out = capsys.readouterr().out
    if arch == "whisper-large-v3":
        assert rc == 1 and "decoder-only" in out
        assert ref_serve.main(argv[:2] + argv[4:]) == 1
    else:
        assert rc == 0 and "generated (2, 12)" in out


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b",
                                  "internvl2-1b"])
def test_generate_matches_the_reference(arch):
    cfg = reduced_config(arch)
    rp = ref_init_lm(jax.random.PRNGKey(0), ref_reduced_config(arch))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    want = np.asarray(ref_serve.generate(ref_reduced_config(arch), rp,
                                         jax.numpy.asarray(prompts), 6))
    got = serve.generate(cfg, lm_params_from_numpy(to_np(rp)),
                         torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_need_the_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMTrainer(reduced_config("llama3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3-8b"])


def test_lm_pretrain_resumes_bit_equal(capsys):
    assert lm_pretrain.main(["--device", "cpu", "--steps", "8",
                             "--arch", "qwen1.5-0.5b"]) == 0
    out = capsys.readouterr().out
    assert "params bitwise equal: True" in out and "identical: True" in out


def test_same_seed_gives_the_same_params_on_any_trainer():
    a = LMTrainer(reduced_config("yi-9b"), seed=3, device="cpu")
    b = init_lm(torch.Generator().manual_seed(3), reduced_config("yi-9b"))
    for x, y in zip(tree_leaves(a.params), tree_leaves(b)):
        assert torch.equal(x, y)
