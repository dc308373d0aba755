"""The O'Shea-2018 SNN on the whole-network kernel, and what serving it
changed around the kernel.

The CNN of O'Shea, Roy and Clancy (arXiv:1712.04578, Table III) for
RadioML 2018.01A: 2 x 1,024 I/Q frames, seven Conv1D of 64 filters, each
3 wide with a max-pool of 2, FC 512-128-128-24; as an SNN a LIF after each
conv and each FC but the last, the ``current_sum`` readout, T = 8.  No f32
spike layout of it fits the H100's shared memory at any cluster size; the
planner holds its spikes as bits.  Held here: the planner's bit layout for
every bucket, the paper model's launches as they were planned before the
bit layout existed, the bit layout's offsets against a packed input, an
O'Shea-shaped SNN served through the fused backend against the plain
reference, the serving stats' samples a frame and the fused launch's
counters.  The tests marked ``cuda`` hold the O'Shea model's bit-layout
kernel to the layered ``cuda`` path and the plain version on the card and
skip without one (``tests/test_torch_cuda.py`` holds the bit layout to
the plain version at every cluster size on smaller networks).  The module imports neither jax nor the reference package; where
only PyTorch is installed run it with ``--noconftest``.
"""
import dataclasses
import pathlib
import sys

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
from repro_torch.data.pipeline import sigma_delta_encode_batch
from repro_torch.kernels import (
    launch_counts,
    reset_launch_counts,
    stream_fused_forward,
    stream_fused_forward_ref,
)
from repro_torch.kernels.launches import (
    add_launches,
    count_launch,
    record_counts,
    record_details,
    recording,
)
from repro_torch.kernels.stream_fused import (
    BITS_SLACK,
    CLUSTERS,
    MAX_SMEM,
    FusedConv,
    FusedFC,
    FusedLaunch,
    conv_weight_lists,
    launch_plan,
    max_active_clusters,
    plan_stream_fused_launch,
)
from repro_torch.obs import metrics
from repro_torch.obs.trace import disable_tracing, enable_tracing, span_window
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeStats

ROOT = pathlib.Path(__file__).resolve().parents[1]

OSHEA = SNNConfig(conv_specs=((3, 2, 64),) + ((3, 64, 64),) * 6, pool=2,
                  fc_specs=((512, 128), (128, 128), (128, 24)),
                  input_width=1024, timesteps=8, n_classes=24).validate()
# the same stack at 8 channels over 128 samples: the last pool leaves one
OSHEA_SMALL = SNNConfig(conv_specs=((3, 2, 8),) + ((3, 8, 8),) * 6, pool=2,
                        fc_specs=((8, 16), (16, 16), (16, 24)), input_width=128,
                        timesteps=8, n_classes=24).validate()
PAPER = SNNConfig()
SMALL = SNNConfig(conv_specs=((3, 2, 4), (3, 4, 8)), pool=2,
                  fc_specs=((64, 16), (16, 5)), input_width=32,
                  timesteps=4, n_classes=5).validate()


@pytest.fixture(scope="module", autouse=True)
def plan_cache_in_memory():
    """Keep the port's plan cache off the disk while these tests run."""
    from repro_torch.plan import PlanCache, cache, set_default_cache

    old = cache._default
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cache.ENV_DIR, "")
        set_default_cache(PlanCache())
        yield
    set_default_cache(old)


def _plan(cfg, seed, density, device="cpu", backend="cuda_fused"):
    params = init_snn(seed, cfg)
    masks = make_mask_pytree(params, density)
    return compile_plan(compile_snn(cfg), params, masks=masks,
                        assignment=backend, device=device), params, masks


@pytest.fixture(scope="module")
def oshea_stack():
    return _plan(OSHEA, 7, 0.2)[0].fused_stack()


def _assert_regions(plan):
    """Regions 16-byte aligned, disjoint and inside the CTA's memory."""
    spans = sorted((off, off + words) for _, off, words in plan.layout)
    assert all(off % 4 == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert 4 * spans[-1][1] == plan.smem_bytes <= MAX_SMEM


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def test_fused_plan_holds_the_oshea_model_in_the_bit_layout_for_every_bucket(oshea_stack):
    for b in range(1, 65):
        plan = plan_stream_fused_launch(oshea_stack, b)
        assert (plan.spikes, plan.cluster, plan.threads) == ("bits", 8, 512)
        # every FC slice resident: nothing staged, nothing read from L2
        assert all(plan.fc_resident) and plan.fc_staged == (0, 0, 0)
        assert plan.waves == -(-b // (plan.ctas_per_sm * 132 // 8))
        _assert_regions(plan)
    regions = dict((name, words) for name, _, words in plan.layout)
    # a conv input: 64 rows of a zero word and the positions, 32 a word,
    # in two parities; the frames' T x 2 rows of 32 words and the flags
    # share the encoder's region of 2 x 1,024 analog values
    assert regions["in1"] == 2 * (64 * (1 + 512 // 32) + BITS_SLACK)
    assert regions["in6"] == 2 * (64 * 2 + BITS_SLACK)
    assert regions["frm"] == 2 * 1024 and regions["spk"] == 8 * 1024 // 32
    # no f32 layout fits at any cluster size, the bit layout only at 8
    for c in CLUSTERS:
        with pytest.raises(ValueError, match="232448"):
            plan_stream_fused_launch(oshea_stack, 64, cluster=c, spikes="f32")
        if c < 8:
            with pytest.raises(ValueError, match="232448"):
                plan_stream_fused_launch(oshea_stack, 64, cluster=c)
    # the card's occupancy is asked for the bit layout's kernel
    asked = []
    plan_stream_fused_launch(oshea_stack, 64, active_clusters=lambda c, t, m, spikes:
                             asked.append(spikes) or 16)
    assert set(asked) == {"bits"}


def test_fused_plan_raises_where_neither_layout_fits(oshea_stack):
    # the same convs over 8,192 samples: the first conv's membranes alone
    # take 8 x 8,192 words a CTA at cluster 8
    fc1 = next(l for l in oshea_stack.layers if isinstance(l, FusedFC))
    wide_fc = dataclasses.replace(fc1, w=np.ones((64 * 64, 128), np.float32))
    wide = dataclasses.replace(
        oshea_stack, layers=tuple(wide_fc if l is fc1 else l for l in oshea_stack.layers),
        in_width=8192, _packed={})
    with pytest.raises(ValueError, match="232448"):
        plan_stream_fused_launch(wide, 64)
    # the bit layout's own limits: T past the frames' 32 flags, a kernel
    # wider than two zero words of padding, an FC where the frames enter
    conv1 = oshea_stack.layers[0]
    wide_kw = dataclasses.replace(conv1, kw=67)
    fc_last = oshea_stack.layers[-2]
    for bad, match in (
            (dataclasses.replace(oshea_stack, timesteps=33, _packed={}), "timesteps"),
            (dataclasses.replace(oshea_stack, layers=(wide_kw,) + oshea_stack.layers[1:],
                                 _packed={}), "wider than 65"),
            (dataclasses.replace(oshea_stack, layers=oshea_stack.layers[-2:],
                                 in_ic=2, in_width=fc_last.w.shape[0] // 2, _packed={}),
             "not a conv")):
        with pytest.raises(ValueError, match=match):
            plan_stream_fused_launch(bad, 1, spikes="bits")
    with pytest.raises(ValueError, match="spikes"):
        plan_stream_fused_launch(oshea_stack, 1, spikes="bytes")


# The paper model's launches (SNNConfig(), init_snn(0), masks at density
# 0.5) as the planner gave them before the bit layout existed, per
# cluster size; the waves are the batch over 132 SMs' clusters, and the
# planner's own choice is 8 up to 16 frames, 4 up to 33 and 2 past them.
PAPER_LAUNCHES = {
    1: dict(
        threads=512, smem_bytes=231536, ctas_per_sm=1,
        fc_resident=(False, True), fc_rows=(0, 128),
        fc_staged=(144, 0), positions=(4, 2, 1),
        owned=(
            ((0, 16),),
            ((0, 32),),
            ((0, 64),),
            ((0, 128),),
            ((0, 11),),
        ),
        layout=(
            ('meta', 0, 232), ('in0', 232, 404), ('list0', 636, 416),
            ('rowptr0', 1052, 17), ('cmap0', 1072, 256), ('v0', 1328, 2048),
            ('lif0', 3376, 48), ('in1', 3424, 2624), ('list1', 6048, 5744),
            ('rowptr1', 11792, 33), ('cmap1', 11828, 1024), ('v1', 12852, 2048),
            ('lif1', 14900, 96), ('in2', 14996, 2560), ('list2', 17556, 10456),
            ('rowptr2', 28012, 65), ('cmap2', 28080, 1024), ('v2', 29104, 2048),
            ('lif2', 31152, 192), ('in3', 31344, 2048), ('v3', 33392, 128),
            ('lif3', 33520, 384), ('in4', 33904, 256), ('w4', 34160, 1536),
            ('v4', 35696, 11), ('lif4', 35708, 33), ('mbar', 35744, 20), ('spk', 35764, 1),
            ('stage', 35768, 18432), ('idx', 54200, 1064), ('mask', 55264, 33),
            ('logit', 55300, 11), ('accs', 55312, 9), ('frm', 55324, 2048),
            ('integ', 57372, 256), ('yprev', 57628, 256),
        )),
    2: dict(
        threads=512, smem_bytes=226800, ctas_per_sm=1,
        fc_resident=(False, True), fc_rows=(224, 128),
        fc_staged=(256, 0), positions=(2, 2, 1),
        owned=(
            ((0, 8), (8, 16),),
            ((0, 16), (16, 32),),
            ((0, 32), (32, 64),),
            ((0, 64), (64, 128),),
            ((0, 6), (6, 11),),
        ),
        layout=(
            ('meta', 0, 232), ('in0', 232, 404), ('list0', 636, 232), ('rowptr0', 868, 9),
            ('cmap0', 880, 128), ('v0', 1008, 1024), ('lif0', 2032, 24),
            ('in1', 2056, 2624), ('list1', 4680, 2888), ('rowptr1', 7568, 17),
            ('cmap1', 7588, 512), ('v1', 8100, 1024), ('lif1', 9124, 48),
            ('in2', 9172, 2560), ('list2', 11732, 5264), ('rowptr2', 16996, 33),
            ('cmap2', 17032, 512), ('v2', 17544, 1024), ('lif2', 18568, 96),
            ('in3', 18664, 2048), ('w3', 20712, 14336), ('v3', 35048, 64),
            ('lif3', 35112, 192), ('in4', 35304, 256), ('w4', 35560, 1024),
            ('v4', 36584, 6), ('lif4', 36592, 18), ('mbar', 36612, 20), ('spk', 36632, 1),
            ('stage', 36636, 16384), ('idx', 53020, 1064), ('mask', 54084, 33),
            ('logit', 54120, 6), ('accs', 54128, 9), ('frm', 54140, 2048),
            ('integ', 56188, 256), ('yprev', 56444, 256),
        )),
    4: dict(
        threads=512, smem_bytes=207136, ctas_per_sm=1,
        fc_resident=(True, True), fc_rows=(1024, 128),
        fc_staged=(0, 0), positions=(1, 1, 1),
        owned=(
            ((0, 4), (4, 8), (8, 12), (12, 16),),
            ((0, 8), (8, 16), (16, 24), (24, 32),),
            ((0, 16), (16, 32), (32, 48), (48, 64),),
            ((0, 32), (32, 64), (64, 96), (96, 128),),
            ((0, 3), (3, 6), (6, 9), (9, 11),),
        ),
        layout=(
            ('meta', 0, 232), ('in0', 232, 404), ('list0', 636, 128), ('rowptr0', 764, 5),
            ('cmap0', 772, 64), ('v0', 836, 512), ('lif0', 1348, 12), ('in1', 1360, 2624),
            ('list1', 3984, 1496), ('rowptr1', 5480, 9), ('cmap1', 5492, 256),
            ('v1', 5748, 512), ('lif1', 6260, 24), ('in2', 6284, 2560),
            ('list2', 8844, 2672), ('rowptr2', 11516, 17), ('cmap2', 11536, 256),
            ('v2', 11792, 512), ('lif2', 12304, 48), ('in3', 12352, 2048),
            ('w3', 14400, 32768), ('v3', 47168, 32), ('lif3', 47200, 96),
            ('in4', 47296, 256), ('w4', 47552, 512), ('v4', 48064, 3), ('lif4', 48068, 9),
            ('mbar', 48080, 20), ('spk', 48100, 1), ('stage', 48104, 1),
            ('idx', 48108, 1064), ('mask', 49172, 33), ('logit', 49208, 3),
            ('accs', 49212, 9), ('frm', 49224, 2048), ('integ', 51272, 256),
            ('yprev', 51528, 256),
        )),
    8: dict(
        threads=512, smem_bytes=128496, ctas_per_sm=1,
        fc_resident=(True, True), fc_rows=(1024, 128),
        fc_staged=(0, 0), positions=(1, 1, 1),
        owned=(
            ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 14), (14, 16),),
            ((0, 4), (4, 8), (8, 12), (12, 16), (16, 20), (20, 24), (24, 28), (28, 32),),
            ((0, 8), (8, 16), (16, 24), (24, 32), (32, 40), (40, 48), (48, 56), (56, 64),),
            ((0, 16), (16, 32), (32, 48), (48, 64), (64, 80), (80, 96), (96, 112),
             (112, 128),),
            ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 11), (11, 11), (11, 11),),
        ),
        layout=(
            ('meta', 0, 232), ('in0', 232, 404), ('list0', 636, 80), ('rowptr0', 716, 3),
            ('cmap0', 720, 32), ('v0', 752, 256), ('lif0', 1008, 6), ('in1', 1016, 2624),
            ('list1', 3640, 768), ('rowptr1', 4408, 5), ('cmap1', 4416, 128),
            ('v1', 4544, 256), ('lif1', 4800, 12), ('in2', 4812, 2560),
            ('list2', 7372, 1352), ('rowptr2', 8724, 9), ('cmap2', 8736, 128),
            ('v2', 8864, 256), ('lif2', 9120, 24), ('in3', 9144, 2048),
            ('w3', 11192, 16384), ('v3', 27576, 16), ('lif3', 27592, 48),
            ('in4', 27640, 256), ('w4', 27896, 512), ('v4', 28408, 2), ('lif4', 28412, 6),
            ('mbar', 28420, 20), ('spk', 28440, 1), ('stage', 28444, 1),
            ('idx', 28448, 1064), ('mask', 29512, 33), ('logit', 29548, 2),
            ('accs', 29552, 9), ('frm', 29564, 2048), ('integ', 31612, 256),
            ('yprev', 31868, 256),
        )),
}


def test_fused_plan_on_the_paper_model_is_unchanged_for_every_bucket_and_cluster():
    stack = _plan(PAPER, 0, 0.5)[0].fused_stack()
    for cluster in (None,) + CLUSTERS:
        for b in range(1, 65):
            c = cluster or (8 if b <= 16 else 4 if b <= 33 else 2)
            want = FusedLaunch(cluster=c, waves=-(-b // (132 // c)),
                               **PAPER_LAUNCHES[c])
            got = plan_stream_fused_launch(stack, b, cluster=cluster)
            assert got == want, (cluster, b)
            assert got.spikes == "f32"


# ---------------------------------------------------------------------------
# the bit layout's offsets
# ---------------------------------------------------------------------------

def _pack_rows(x: np.ndarray) -> np.ndarray:
    """(IC, W) spikes in the bit layout: each row a zero word, then bit
    p % 32 of word 1 + p // 32; the slack after the last row."""
    ic, width = x.shape
    rw = 1 + -(-width // 32)
    words = np.zeros(ic * rw + BITS_SLACK, np.uint64)
    for i, p in zip(*np.nonzero(x)):
        words[i * rw + 1 + p // 32] |= np.uint64(1) << np.uint64(p % 32)
    return words


@pytest.mark.parametrize("width", [1, 5, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("kw", [1, 3, 4, 11, 65])
def test_bit_layout_offsets_read_the_padded_input_across_word_edges(width, kw):
    """Entry (w, off) of a channel's list reads bit off + p for output
    position p: the zero-padded input at (its input channel, its tap + p),
    across word edges, at odd widths and with more padding on the right."""
    rng = np.random.default_rng(16 * width + kw)
    ic, oc, cluster = 3, 5, 2
    w_cm = (rng.normal(size=(oc, kw * ic)) * (rng.random((oc, kw * ic)) < 0.7)
            ).astype(np.float32)
    layer = FusedConv(name="conv", kw=kw, ic=ic, oc=oc, w_cm=w_cm,
                      counts=np.zeros((1, kw * ic), np.float32),
                      lif=np.zeros((3, oc), np.float32), static_counts={})
    x = rng.random((ic, width)) < 0.5
    words = _pack_rows(x)
    left = (kw - 1) // 2
    xp = np.pad(x, ((0, 0), (left, kw - 1 - left)))
    entries, rowptr = conv_weight_lists(layer, width, cluster, bits=True)
    f32_entries, f32_rowptr = conv_weight_lists(layer, width, cluster)
    np.testing.assert_array_equal(rowptr, f32_rowptr)
    np.testing.assert_array_equal(entries[..., 0], f32_entries[..., 0])
    per = -(-oc // cluster)
    for ch in range(oc):
        q, cl = divmod(ch, per)
        e = entries[q, rowptr[q, cl]:rowptr[q, cl + 1]]
        nz = np.flatnonzero(w_cm[ch])
        nz = nz[np.argsort((nz % ic) * kw + nz // ic)]    # ascending k
        off = e[:len(nz), 1].view(np.int32).astype(np.int64)
        for p in range(width):
            bit = off + p
            got = (words[bit >> 5] >> (bit & 31).astype(np.uint64)) & np.uint64(1)
            np.testing.assert_array_equal(got.astype(bool), xp[nz % ic, nz // ic + p])


# ---------------------------------------------------------------------------
# the served path on the CPU
# ---------------------------------------------------------------------------

def _bench_model(spec, seed, density):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from amcbench.model import make_model, program_params, snn_config

    names = [f"conv{i + 1}" for i in range(len(spec["conv_specs"]))] + [
        f"fc{i + 1}" for i in range(len(spec["fc_specs"]))]
    model = make_model({"model": spec, "dtype": "float32",
                        "densities": {n: density for n in names}}, seed, "cpu")
    params, masks = program_params(model)
    return model, params, masks, snn_config(spec)


def _spec(cfg):
    return {"conv_specs": [list(c) for c in cfg.conv_specs], "pool": cfg.pool,
            "fc_specs": [list(f) for f in cfg.fc_specs],
            "input_width": cfg.input_width, "timesteps": cfg.timesteps,
            "n_classes": cfg.n_classes, "readout": cfg.readout,
            "lif_alpha": 0.9, "lif_theta": 1.0, "lif_v_th": 1.0}


def test_an_oshea_shaped_snn_served_through_the_fused_backend_equals_the_reference():
    from amcbench.reference.snn import forward

    model, params, masks, cfg = _bench_model(_spec(OSHEA_SMALL), 5, 0.5)
    iq = np.random.default_rng(3).normal(size=(12, 2, 128)).astype(np.float32)
    want = forward(model, torch.as_tensor(iq))
    with AsyncAMCServeEngine(params, cfg, masks, backend="cuda_fused",
                             max_batch=8, device="cpu") as engine:
        preds = engine.classify(iq)
        logits, accs = engine.serve_step(iq)
    assert engine.backend == "cuda_fused"
    np.testing.assert_allclose(logits, want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(preds, want.argmax(-1).numpy())
    # spikes reach the last conv and the logits move
    assert accs["conv7"].sum() > 0 and np.abs(logits).max() > 0
    stream = compile_plan(compile_snn(cfg), params, masks=masks,
                          assignment="stream", device="cpu")
    _, want_accs = stream.batch_counters(
        sigma_delta_encode_batch(torch.as_tensor(iq), cfg.timesteps))
    assert sorted(accs) == sorted(want_accs) and len(accs) == 7
    for name, a in want_accs.items():
        np.testing.assert_array_equal(accs[name], a.numpy(), err_msg=name)


def test_serve_stats_count_the_served_models_samples_a_frame():
    st = ServeStats(requests=1000, wall_s=2.0, frame_len=1024)
    assert st.summary()["throughput_samples_per_s"] == 512_000.0
    assert st.throughput_samples_per_s() == 512_000.0
    assert st.throughput_samples_per_s(128) == 64_000.0
    # stats that name no model count 128 samples a frame, as before
    plain = ServeStats(requests=1000, wall_s=2.0)
    assert plain.throughput_samples_per_s() == 64_000.0
    assert plain.summary()["throughput_samples_per_s"] == 64_000.0
    params = init_snn(0, OSHEA)
    with AsyncAMCServeEngine(params, OSHEA, make_mask_pytree(params, 0.2),
                             backend="dense", max_batch=2, warmup=False,
                             device="cpu") as engine:
        engine.classify(np.zeros((2, 2, 1024), np.float32))
        summary = engine.stats.summary()
        versions = engine.version_stats()
    assert engine.stats.frame_len == 1024
    assert summary["throughput_samples_per_s"] == pytest.approx(
        2 * 1024 / summary["wall_s"])
    assert all(v.frame_len == 1024 for v in versions.values())


def _served_with_tracing(monkeypatch, launches_of, trace: bool):
    """Serve 13 frames of SMALL through the fused backend on the CPU with
    the fused launches ``launches_of(version, shape)`` in place of what a
    capture on the card notes: ``(registry, span window, stats)``."""
    monkeypatch.setattr(engine_mod, "step_launches", launches_of)
    fresh = metrics.MetricsRegistry()
    old = metrics.set_default_registry(fresh)
    params = init_snn(4, SMALL)
    if trace:
        enable_tracing()
    try:
        import time

        t0 = time.perf_counter()
        with AsyncAMCServeEngine(params, SMALL, make_mask_pytree(params, 0.5),
                                 backend="cuda_fused", max_batch=8, name="bits",
                                 device="cpu") as engine:
            engine.classify(np.random.default_rng(1).normal(
                size=(13, 2, 32)).astype(np.float32))
            stats = engine.stats
        window = span_window(t0, time.perf_counter()) if trace else None
    finally:
        disable_tracing()
        metrics.set_default_registry(old)
    return fresh, window, stats


def _two_sm_launches(seen):
    """``step_launches`` on a two-SM card (a wave holds two frames), each
    bucket's launch kept in ``seen``."""
    def launches_of(ver, shape):
        b = shape[0]
        seen[b] = plan_stream_fused_launch(ver.plan.fused_stack(), b,
                                           cluster=1, threads=512, n_sms=2,
                                           spikes="bits")
        return (seen[b],)
    return launches_of


def _assert_counted(reg, seen, want, batches):
    assert reg.value("repro_fused_launches_total", engine="bits",
                     layout="bits") == batches
    assert reg.value("repro_fused_waves_total", engine="bits",
                     layout="bits") == sum(want)
    for b, launch in seen.items():
        assert reg.value("repro_fused_smem_bytes", engine="bits",
                         bucket=str(b)) == launch.smem_bytes


def test_fused_launch_counters_and_waves_while_the_span_log_records(monkeypatch):
    seen = {}
    reg, w, stats = _served_with_tracing(monkeypatch, _two_sm_launches(seen),
                                         trace=True)
    assert w is not None and len(w.batches["waves"]) == stats.batches >= 2
    want = [seen[b].waves for b in w.batches["bucket"].tolist()]
    assert max(want) > 1
    np.testing.assert_array_equal(w.batches["waves"], want)
    assert [b["waves"] for b in w.to_json()["batches"]] == want
    _assert_counted(reg, seen, want, stats.batches)


def test_fused_launch_counters_count_while_nothing_records(monkeypatch):
    seen, buckets = {}, []
    launches_of = _two_sm_launches(seen)

    def recorded(ver, shape):
        buckets.append(shape[0])
        return launches_of(ver, shape)

    reg, _, stats = _served_with_tracing(monkeypatch, recorded, trace=False)
    assert stats.batches >= 2 and len(buckets) == stats.batches
    _assert_counted(reg, seen, [seen[b].waves for b in buckets], stats.batches)


def test_the_cpu_serves_no_fused_launch(monkeypatch):
    plan = _plan(SMALL, 4, 0.5)[0]
    ver = engine_mod.BoundVersion(label="v", backend="cuda_fused",
                                  serve_step=None, plan=plan, sparse=None,
                                  stats=ServeStats(), graphs=None)
    assert engine_mod.step_launches(ver, (8, 2, 32)) == ()
    reg, w, stats = _served_with_tracing(monkeypatch, engine_mod.step_launches,
                                         trace=True)
    assert len(w.batches["waves"]) == stats.batches
    assert not w.batches["waves"].any()
    assert reg.value("repro_fused_launches_total", engine="bits", layout="f32") == 0


def test_a_capture_keeps_what_its_launches_noted():
    def kernel():
        pass
    kernel.launches = 0
    with recording() as record:
        count_launch(kernel, "first")
        count_launch(kernel)
        count_launch(kernel, "second")
    assert record_counts(record) == {"kernel": 3}
    assert record_details(record) == ("first", "second")
    assert kernel.launches == 0
    count_launch(kernel, "eager")      # counted; only a capture keeps it
    add_launches(record)
    assert kernel.launches == 4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _iq(cfg, n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.conv_specs[0][1], cfg.input_width)).astype(np.float32)


@pytest.mark.cuda
def test_oshea_fused_kernel_equals_the_layered_path_and_counts_as_stream(cuda):
    """At its published widths: the planner's bit layout for every bucket
    on the card, the logits equal to the layered ``cuda`` path's and the
    plain version's bit for bit, the conv counters the interpreter's."""
    fused, params, masks = _plan(OSHEA, 7, 0.2, cuda)
    stack = fused.fused_stack()
    for b in (1, 2, 4, 8, 16, 32, 64):
        launch = launch_plan(stack, b, cuda)
        assert launch.spikes == "bits" and max_active_clusters(launch) > 0
    layered = compile_plan(compile_snn(OSHEA), params, masks=masks,
                           assignment="cuda", device=cuda)
    stream = compile_plan(compile_snn(OSHEA), params, masks=masks,
                          assignment="stream", device=cuda)
    frames = sigma_delta_encode_batch(torch.as_tensor(_iq(OSHEA, 64, 5), device=cuda),
                                      OSHEA.timesteps)
    logits, accs = stream_fused_forward(stack, frames)
    torch.testing.assert_close(logits, layered.bound.batch(frames), atol=0, rtol=0)
    want, want_accs = stream_fused_forward_ref(stack, frames)
    torch.testing.assert_close(logits, want, atol=0, rtol=0)
    torch.testing.assert_close(accs, want_accs, atol=0, rtol=0)
    _, stream_accs = stream.batch_counters(frames)
    for i, name in enumerate(stack.conv_names):
        assert torch.equal(stream_accs[name], accs[:, i]), name
    assert bool((accs[:, -1] > 0).all())


@pytest.mark.cuda
def test_oshea_served_by_one_fused_launch_a_replay(cuda):
    _, params, masks = _plan(OSHEA, 7, 0.2, cuda)
    layered = compile_plan(compile_snn(OSHEA), params, masks=masks,
                           assignment="cuda", device=cuda)
    iq = _iq(OSHEA, 40, 9)
    with AsyncAMCServeEngine(params, OSHEA, masks, backend="cuda_fused",
                             max_batch=64) as engine:
        graphs = engine.get_version("default").graphs
        reset_launch_counts()
        replays = graphs.replays
        preds = engine.classify(iq)
        launched = {k: n for k, n in launch_counts().items() if n}
        assert launched == {"stream_fused_forward": graphs.replays - replays}
        stack = engine.plan.fused_stack()
        for shape in graphs.shapes():
            assert engine_mod.step_launches(engine.get_version("default"),
                                            shape) == (
                launch_plan(stack, shape[0], cuda),)
    want = layered.bound.batch(sigma_delta_encode_batch(
        torch.as_tensor(iq, device=cuda), OSHEA.timesteps)).argmax(-1)
    np.testing.assert_array_equal(preds, want.cpu().numpy())


@pytest.mark.cuda
def test_paper_model_keeps_the_f32_layout_on_the_card(cuda):
    stack = _plan(PAPER, 0, 0.5, cuda)[0].fused_stack()
    for b in range(1, 65):
        assert launch_plan(stack, b, cuda).spikes == "f32"
