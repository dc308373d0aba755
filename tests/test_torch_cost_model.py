"""The port's numpy sparse-format helpers and cost model, held to the live
reference: every array and count exactly, model outputs within 1e-12."""
import dataclasses

import numpy as np
import pytest

from repro.core import cost_model as ref_cm
from repro.core import sparse_format as ref_sf
from repro_torch.core import cost_model as cm
from repro_torch.core import sparse_format as sf

SHAPES = [(11, 2, 16), (11, 16, 32), (5, 32, 64), (3, 4, 8), (1, 1, 1)]


def _kernel(seed, shape, density):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.normal(size=shape)).astype(np.float32)


def _frames(seed, t, ic, wi):
    rng = np.random.default_rng(seed)
    return (rng.random((t, ic, wi)) < 0.4).astype(np.float32)


def _assert_same_dataclass(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
def test_coo_properties_and_bit_widths_equal_reference(shape, density):
    k = _kernel(sum(shape), shape, density)
    got, want = sf.coo_from_dense(k), ref_sf.coo_from_dense(k)
    _assert_same_dataclass(got, want)
    assert got.density == want.density
    for i in range(min(got.nnz, 40)):
        assert (got.oc_of(i), got.ic_of(i)) == (want.oc_of(i), want.ic_of(i))
    for bits in (8, 16):
        assert sf.coo_bit_widths(*shape, bits) == ref_sf.coo_bit_widths(*shape, bits)
        assert (sf.dense_storage_bits(*shape, bits)
                == ref_sf.dense_storage_bits(*shape, bits))
        assert (sf.coo_storage_bits(*shape, density, bits)
                == ref_sf.coo_storage_bits(*shape, density, bits))
        assert (sf.break_even_density(*shape, bits)
                == ref_sf.break_even_density(*shape, bits))


@pytest.mark.parametrize("seed", range(3))
def test_weight_mask_equals_reference(seed):
    rng = np.random.default_rng(seed)
    w = _kernel(seed, (64, 16), 0.3)
    got, want = sf.weight_mask_from_dense(w), ref_sf.weight_mask_from_dense(w)
    _assert_same_dataclass(got, want)
    assert got.density == want.density
    spikes = rng.random((5, 64)) < 0.5
    np.testing.assert_array_equal(got.fetch_mask(spikes), want.fetch_mask(spikes))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("blocks", [(8, 32), (8, 128), (4, 16)])
def test_block_sparse_layout_equals_reference(shape, blocks):
    k = _kernel(7, shape, 0.3)
    got = sf.block_sparse_from_dense(k, *blocks)
    want = ref_sf.block_sparse_from_dense(k, *blocks)
    _assert_same_dataclass(got, want)
    for prop in ("n_oc_tiles", "max_tiles", "padded_oc", "padded_k",
                 "tile_density"):
        assert getattr(got, prop) == getattr(want, prop), prop
    back = sf.block_sparse_to_dense(got)
    np.testing.assert_array_equal(back, ref_sf.block_sparse_to_dense(want))
    np.testing.assert_array_equal(back, k)


@pytest.mark.parametrize("shape,wi", [((3, 4, 8), 12), ((5, 2, 3), 9),
                                      ((11, 2, 16), 138)])
@pytest.mark.parametrize("density", [0.1, 0.5])
def test_conv_counts_equal_reference(shape, wi, density):
    k = _kernel(3, shape, density)
    frames = _frames(4, 3, shape[1], wi)
    got = cm.goap_conv_counts(frames, sf.coo_from_dense(k))
    want = ref_cm.goap_conv_counts(frames, ref_sf.coo_from_dense(k))
    assert got.asdict() == want.asdict()
    got = cm.sw_conv_counts(frames, shape)
    assert got.asdict() == ref_cm.sw_conv_counts(frames, shape).asdict()
    # a single (IC, WI) frame is one timestep
    assert (cm.goap_conv_counts(frames[0], sf.coo_from_dense(k)).asdict()
            == ref_cm.goap_conv_counts(frames[0],
                                       ref_sf.coo_from_dense(k)).asdict())
    for bits in ((1, 16), (1, 8)):
        assert cm.bits_fetched(got, *bits) == ref_cm.bits_fetched(
            ref_cm.sw_conv_counts(frames, shape), *bits)


def test_fc_counts_equal_reference():
    w = _kernel(5, (1024, 128), 0.5)
    spikes = np.random.default_rng(6).random((8, 1024)) < 0.2
    assert (cm.fc_traditional_counts(spikes, w).asdict()
            == ref_cm.fc_traditional_counts(spikes, w).asdict())
    got = cm.fc_wm_counts(spikes, sf.weight_mask_from_dense(w))
    want = ref_cm.fc_wm_counts(spikes, ref_sf.weight_mask_from_dense(w))
    assert got.asdict() == want.asdict()
    assert cm.bits_fetched(got) == ref_cm.bits_fetched(want)


def test_cycle_and_power_models_equal_reference():
    assert cm.PAPER_TABLE5 == ref_cm.PAPER_TABLE5
    assert cm.PAPER_BASELINE == ref_cm.PAPER_BASELINE
    assert cm.fom(1234.0, 0.47, 23.5) == ref_cm.fom(1234.0, 0.47, 23.5)
    counts = (11 * 2 * 16, 11 * 16 * 32, 5 * 32 * 64)
    got = cm.CycleModel(counts).calibrate()
    want = ref_cm.CycleModel(counts).calibrate()
    assert abs(got.cpi_conv - want.cpi_conv) <= 1e-12
    for d in sorted(cm.PAPER_TABLE5):
        assert abs(got.latency_us(d) - want.latency_us(d)) <= 1e-12
    assert got.throughput_msps() == want.throughput_msps()
    rng = np.random.default_rng(0)
    rows = rng.random((8, 3))
    powers = np.array([v[0] for v in cm.PAPER_TABLE5.values()])
    got = cm.PowerModel().fit(rows, powers)
    want = ref_cm.PowerModel().fit(rows, powers)
    for c in ("c_acc", "c_bit", "c_util"):
        assert abs(getattr(got, c) - getattr(want, c)) <= 1e-12, c
    assert abs(got.predict(1e6, 2e7, 0.5) - want.predict(1e6, 2e7, 0.5)) <= 1e-12


def test_paper_conv2_counts_equal_reference():
    """Paper pin: conv2's Table I counts on one encoded-like input."""
    k = _kernel(11, (11, 16, 32), 0.5)
    frames = _frames(12, 8, 16, 64 + 10)
    coo, ref_coo = sf.coo_from_dense(k), ref_sf.coo_from_dense(k)
    assert (cm.goap_conv_counts(frames, coo).asdict()
            == ref_cm.goap_conv_counts(frames, ref_coo).asdict())
    sched, ref_sched = sf.build_schedule(coo), ref_sf.build_schedule(ref_coo)
    _assert_same_dataclass(sched, ref_sched)
