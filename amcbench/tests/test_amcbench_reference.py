"""The reference against the port's backends at full width on a few frames
(CPU), its work counts against a brute-force count, and its control
precisions."""
import json
import pathlib

import numpy as np
import pytest
import torch

from amcbench.frames import make_pool
from amcbench.model import make_model, program_params, snn_config
from amcbench.reference import snn as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "amcbench" / "configs" / f"{name}.json").read_text())


def port_logits(cfg, model, iq, backend):
    from repro_torch.data.pipeline import sigma_delta_encode_batch
    from repro_torch.models.graph import compile_snn
    from repro_torch.plan import compile_plan

    params, masks = program_params(model)
    plan = compile_plan(compile_snn(snn_config(cfg["model"])), params,
                        masks=masks, assignment=backend, device="cpu")
    frames = sigma_delta_encode_batch(torch.from_numpy(iq),
                                      cfg["model"]["timesteps"])
    return plan.preferred_batch()(frames).float()


# the f32 model against the port's dense oracle; the bf16 model against
# the port's layered kernel path (their plain versions on the CPU)
@pytest.mark.parametrize("name,backend", [("snn-f32-fused", "dense"),
                                          ("snn-f32-fused", "cuda_fused"),
                                          ("snn-bf16-layered", "cuda")])
def test_reference_equals_port(name, backend):
    cfg = config(name)
    model = make_model(cfg, 2**31 + 3, "cpu")
    iq, _, _ = make_pool(5, 24, range(-20, 20, 2))
    iq = np.concatenate([iq, np.zeros((1, 2, 128), np.float32)])
    want = ref.forward(model, torch.from_numpy(iq))
    got = port_logits(cfg, model, iq, backend)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,weights", [("snn-f32-fused", "tf32"),
                                          ("snn-bf16-layered", "fp8")])
def test_control_moves_the_logits(name, weights):
    cfg = config(name)
    model = make_model(cfg, 11, "cpu")
    iq = torch.from_numpy(make_pool(6, 32, range(-20, 20, 2))[0])
    exact = ref.forward(model, iq)
    low = ref.forward(model, iq, weights=weights)
    err = (low - exact).abs().amax(-1) / (1 + exact.abs().amax(-1))
    assert (err > 1e-3).float().mean() > 0.5


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-12, -3.14159265], dtype=torch.float32)
    y = ref.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1 + 2**-10 and y[2] == 1 + 2**-10
    bits = y.view(torch.int32) & 0x1FFF
    assert torch.all(bits == 0)


def brute_conv_adds(spikes, w):
    """spikes (T, IC, W) of one frame, w (KW, IC, OC): an add for every
    (timestep, output channel, position, input channel, tap) whose input
    spike is 1 and whose weight is unpruned."""
    t_steps, ic, width = spikes.shape
    kw, _, oc = w.shape
    left = (kw - 1) // 2
    n = 0
    for t in range(t_steps):
        for o in range(oc):
            for p in range(width):
                for i in range(ic):
                    for c in range(kw):
                        q = p + c - left
                        if 0 <= q < width and spikes[t, i, q] and w[c, i, o] != 0:
                            n += 1
    return n


def test_work_counts_brute_force():
    cfg = config("snn-f32-fused")
    cfg["model"] = dict(cfg["model"], conv_specs=[[5, 2, 3], [3, 3, 4], [3, 4, 2]],
                        fc_specs=[[32, 6], [6, 11]])
    model = make_model(cfg, 21, "cpu")
    iq = torch.from_numpy(make_pool(8, 3, range(-20, 20, 2))[0])
    _, counts = ref.forward(model, iq, work=True)
    # the spikes each layer sees, stage by stage, for the brute force
    x = ref.encode(iq, 8)
    for li, layer in enumerate(model.convs()):
        w = (layer.w * layer.mask)
        for b in range(3):
            assert counts[f"conv{li + 1}"][b] == brute_conv_adds(x[:, b], w)
        t, bsz, ic, width = x.shape
        cur = ref.conv_currents(x.reshape(t * bsz, ic, width), w).reshape(t, bsz, -1, width)
        s = ref._lif(cur, ref._alpha(layer.alpha_logit, torch.float32),
                     layer.theta, layer.v_th)
        x = ref.pool(s, 2)
    x = x.reshape(8, 3, -1)
    w = model.fcs()[0].w * model.fcs()[0].mask
    for b in range(3):
        want = sum(int((w[i] != 0).sum()) for t in range(8) for i in range(w.shape[0])
                   if x[t, b, i])
        assert counts["fc1"][b] == want


def test_lif_neurons():
    from amcbench.work.step import lif_neurons

    # every conv neuron before its pool, every FC neuron but the readout's
    assert lif_neurons(config("snn-f32-fused")["model"]) == {
        "conv1": 16 * 128, "conv2": 32 * 64, "conv3": 64 * 32, "fc1": 128}
