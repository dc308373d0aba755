"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports neither jax nor the reference package, so it also runs where
only PyTorch is installed; there, run it without the repository's
conftest (which loads the reference's plan cache):

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (
    AsyncAMCServeEngine,
    SNNConfig,
    compile_plan,
    compile_snn,
    init_snn,
    make_mask_pytree,
)
from repro_torch.core.lif import init_lif_params
from repro_torch.core.sparse_format import block_sparse_from_dense
from repro_torch.data.pipeline import sigma_delta_encode_batch
from repro_torch.kernels import (
    goap_conv_op,
    launch_counts,
    lif_op,
    reset_launch_counts,
    stream_fused_forward,
    stream_fused_forward_ref,
    wm_fc_matmul,
    wm_fc_matmul_ref,
)

SMALL = SNNConfig(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
                  fc_specs=((64, 16), (16, 5)), input_width=32,
                  timesteps=4, n_classes=5).validate()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _plan(cfg, seed, device, backend="cuda_fused"):
    params = init_snn(seed, cfg)
    masks = make_mask_pytree(params, 0.5)
    return compile_plan(compile_snn(cfg), params, masks=masks,
                        assignment=backend, device=device), params, masks


def _iq(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.conv_specs[0][1], cfg.input_width)
                      ).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SMALL, SNNConfig()], ids=["small", "paper"])
def test_fused_kernel_equals_plain_bit_for_bit(cuda, cfg):
    plan, _, _ = _plan(cfg, 0, cuda)
    stack = plan.fused_stack()
    iq = torch.as_tensor(_iq(cfg, 5, 1), device=cuda)
    frames = sigma_delta_encode_batch(iq, cfg.timesteps)
    analog = 0.5 * (iq / (iq.abs().amax((-2, -1), keepdim=True) + 1e-8) + 1.0)
    for encode, x in ((False, frames), (True, analog)):
        got = stream_fused_forward(stack, x, encode=encode)
        want = stream_fused_forward_ref(stack, x, encode=encode)
        torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)


@pytest.mark.cuda
def test_per_layer_kernels_equal_plain(cuda):
    rng = np.random.default_rng(0)
    s = torch.as_tensor((rng.random((16, 256)) < 0.5).astype(np.float32), device=cuda)
    w = torch.as_tensor(rng.normal(size=(256, 40)).astype(np.float32), device=cuda)
    torch.testing.assert_close(wm_fc_matmul(s, w), wm_fc_matmul_ref(s, w),
                               atol=1e-5, rtol=0)
    k = ((rng.random((5, 8, 16)) < 0.5)
         * rng.normal(size=(5, 8, 16))).astype(np.float32)
    ifm = (rng.random((3, 8, 36)) < 0.5).astype(np.float32)
    bs = block_sparse_from_dense(k, block_oc=8, block_k=32)
    torch.testing.assert_close(
        goap_conv_op(torch.as_tensor(ifm, device=cuda), bs).cpu(),
        goap_conv_op(torch.as_tensor(ifm), bs), atol=1e-5, rtol=0)
    cur = rng.normal(size=(4, 3, 16, 32)).astype(np.float32)
    got = lif_op(torch.as_tensor(cur, device=cuda), init_lif_params((16, 1)).to(cuda))
    want = lif_op(torch.as_tensor(cur), init_lif_params((16, 1)))
    torch.testing.assert_close(got[0].cpu(), want[0], atol=0, rtol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match="float32"):
        wm_fc_matmul(s.double(), w.double())


@pytest.mark.cuda
def test_plan_paths_agree_and_launch_their_kernels(cuda):
    plan, params, masks = _plan(SMALL, 2, cuda)
    frames = sigma_delta_encode_batch(
        torch.as_tensor(_iq(SMALL, 8, 3), device=cuda), SMALL.timesteps)
    reset_launch_counts()
    fused = plan.batch(frames)
    layered = plan.bound.batch(frames)
    counts = launch_counts()
    assert counts["stream_fused_forward"] == 1
    assert counts["goap_conv_block_sparse"] == 2     # one per conv layer
    assert counts["wm_fc_matmul"] == 2               # one per FC layer
    assert counts["lif_update_fused"] == 4           # one per LIF layer
    torch.testing.assert_close(layered, fused, atol=1e-5, rtol=0)
    dense, _, _ = _plan(SMALL, 2, cuda, backend="dense")
    torch.testing.assert_close(dense.bound.batch(frames), fused, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_engine_serves_through_the_fused_kernel(cuda):
    plan, params, masks = _plan(SMALL, 4, cuda)
    iq = _iq(SMALL, 13, 5)
    reset_launch_counts()
    with AsyncAMCServeEngine(params, SMALL, masks, max_batch=8,
                             warmup=False) as engine:
        preds = engine.classify(iq)
    assert launch_counts()["stream_fused_forward"] >= 2
    want = plan.batch(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=cuda), SMALL.timesteps)).argmax(-1)
    np.testing.assert_array_equal(preds, want.cpu().numpy())
