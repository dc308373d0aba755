"""The port's channel scenarios held to the live reference (CPU).

The port draws its channel variates from host numpy streams, the
reference from ``jax.random`` keys, so the two never give the same frames
from one seed.  :func:`ref_draws` therefore re-derives, with ``jax.random``
and the reference's own key splits (``_apply_single``'s seven-way split,
then each impairment's sub-splits), the variates the reference draws for
a key, in the port's draw layout; given those, every impairment and every
named scenario must compute the reference's frames within 1e-5 on
unit-RMS frames.  The rest pins what ``tests/test_channel.py`` pins, on
the port: power discipline, determinism in the seed, the stage split, the
named suite and the stable seeds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import channel as ref_channel
from repro.channel import impairments as ref_imp
from repro.data.radioml import generate_batch as ref_generate_batch
from repro.deploy.monitor import _snr_bin_seed as ref_snr_bin_seed
from repro.eval import stable_cell_seed as ref_stable_cell_seed
from repro_torch import channel
from repro_torch.channel import impairments as imp
from repro_torch.data import radioml

ATOL = 1e-5
TWO_PI = 2 * jnp.pi


# ---------------------------------------------------------------------------
# the reference's draws, in the port's layout
# ---------------------------------------------------------------------------

def _u(key, shape, lo, hi):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _timing(key, max_sro, max_jitter):
    ks, kt = jax.random.split(key)
    return {"sro": _u(ks, (), -max_sro, max_sro),
            "tau": _u(kt, (), 0.0, max_jitter)}


def _fading(key, n_paths, n_sinusoids=8):
    angles, phases = [], []
    theta = np.float32(0.0)
    for p, kp in enumerate(jax.random.split(key, n_paths)):
        ka, kf, kl = jax.random.split(kp, 3)
        angles.append(_u(ka, (n_sinusoids,), 0.0, TWO_PI))
        phases.append(_u(kf, (n_sinusoids,), 0.0, TWO_PI))
        if p == 0:
            theta = _u(kl, (), 0.0, TWO_PI)
    return {"angles": np.stack(angles), "phases": np.stack(phases),
            "theta": theta}


def _carrier(key, max_cfo, random_phase):
    kc, kp = jax.random.split(key)
    phi0 = _u(kp, (), 0.0, TWO_PI) if random_phase else np.float32(0.0)
    return {"cfo": _u(kc, (), -max_cfo, max_cfo), "phi0": phi0}


def _phase_noise(key, length):
    return {"steps": np.asarray(jax.random.normal(key, (length,)))}


def _iq(key, amp_db, phase_deg):
    kg, kp = jax.random.split(key)
    return {"g_db": _u(kg, (), -amp_db, amp_db),
            "phi_deg": _u(kp, (), -phase_deg, phase_deg)}


def _interferer(key, f_min, f_max, n_tones):
    kf, ks, kp = jax.random.split(key, 3)
    sign = np.where(np.asarray(jax.random.bernoulli(ks, 0.5, (n_tones,))),
                    1.0, -1.0).astype(np.float32)
    return {"f": _u(kf, (n_tones,), f_min, f_max), "sign": sign,
            "phi": _u(kp, (n_tones,), 0.0, TWO_PI)}


def _noise(key, length):
    kr, ki = jax.random.split(key)
    return {"re": np.asarray(jax.random.normal(kr, (length,))),
            "im": np.asarray(jax.random.normal(ki, (length,)))}


def _stack(per_frame):
    """[{name: per-frame draw}] -> {name: batched draw}."""
    return {k: np.stack([d[k] for d in per_frame]) for k in per_frame[0]}


def ref_frame_draws(sc, key, length):
    """One frame's draws by the reference's key splits, per stage."""
    k_t, k_f, k_c, k_p, k_q, k_i, k_n = jax.random.split(key, 7)
    return {
        "timing": _timing(k_t, sc.max_sro, sc.max_jitter),
        "fading": _fading(k_f, len(sc.path_delays)),
        "carrier": _carrier(k_c, sc.max_cfo, sc.random_phase),
        "phase_noise": _phase_noise(k_p, length),
        "iq": _iq(k_q, sc.iq_amp_db, sc.iq_phase_deg),
        "interferer": _interferer(k_i, sc.interferer_f[0], sc.interferer_f[1],
                                  sc.n_tones),
        "noise": _noise(k_n, length),
    }


def ref_draws(sc, key, batch, length):
    """The reference batch's draws: one key per frame, as its vmap splits."""
    frames = [ref_frame_draws(sc, k, length)
              for k in jax.random.split(key, batch)]
    return {stage: _stack([f[stage] for f in frames]) for stage in frames[0]}


# ---------------------------------------------------------------------------
# every impairment, given the reference's draws
# ---------------------------------------------------------------------------

def _unit_frames(batch=4, length=128, seed=0):
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(batch, length)) + 1j * rng.normal(size=(batch, length))
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2, axis=-1, keepdims=True))
    return sig.astype(np.complex64)


# name -> (reference call on one frame, the port's draw of that frame
# from its key, the port's apply on the batch)
IMPAIRMENTS = {
    "carrier_offset": (
        lambda s, k: ref_imp.carrier_offset(s, k, 0.02, True),
        lambda k, n: _carrier(k, 0.02, True),
        lambda s, d: imp.carrier_offset(s, d)),
    "carrier_offset_fixed_phase": (
        lambda s, k: ref_imp.carrier_offset(s, k, 0.02, False),
        lambda k, n: _carrier(k, 0.02, False),
        lambda s, d: imp.carrier_offset(s, d)),
    "phase_noise": (
        lambda s, k: ref_imp.phase_noise(s, k, 3e-3),
        lambda k, n: _phase_noise(k, n),
        lambda s, d: imp.phase_noise(s, d, 3e-3)),
    "timing_offset": (
        lambda s, k: ref_imp.timing_offset(s, k, 2e-3, 0.5),
        lambda k, n: _timing(k, 2e-3, 0.5),
        lambda s, d: imp.timing_offset(s, d)),
    "iq_imbalance": (
        lambda s, k: ref_imp.iq_imbalance(s, k, 1.5, 8.0),
        lambda k, n: _iq(k, 1.5, 8.0),
        lambda s, d: imp.iq_imbalance(s, d)),
    "rayleigh": (
        lambda s, k: ref_imp.multipath_fading(s, k, (0, 2, 5), (1.0, 0.6, 0.3),
                                              doppler=0.01),
        lambda k, n: _fading(k, 3),
        lambda s, d: imp.multipath_fading(s, d, (0, 2, 5), (1.0, 0.6, 0.3),
                                          doppler=0.01)),
    "rician": (
        lambda s, k: ref_imp.multipath_fading(s, k, (0, 3), (1.0, 0.3),
                                              doppler=2e-3, rician_k=4.0),
        lambda k, n: _fading(k, 2),
        lambda s, d: imp.multipath_fading(s, d, (0, 3), (1.0, 0.3),
                                          doppler=2e-3, rician_k=4.0)),
    "interferer_tones": (
        lambda s, k: ref_imp.interferer_tones(s, k, 8.0, 0.1, 0.45, 2),
        lambda k, n: _interferer(k, 0.1, 0.45, 2),
        lambda s, d: imp.interferer_tones(s, d, 8.0)),
    "awgn": (
        lambda s, k: ref_imp.awgn(s, k, 3.5),
        lambda k, n: _noise(k, n),
        lambda s, d: imp.awgn(s, d, 3.5)),
}


@pytest.mark.parametrize("name", sorted(IMPAIRMENTS))
def test_impairment_matches_reference_given_its_draws(name):
    ref_fn, draw, port_fn = IMPAIRMENTS[name]
    sig = _unit_frames()
    keys = jax.random.split(jax.random.PRNGKey(17), sig.shape[0])
    want = np.stack([np.asarray(ref_fn(jnp.asarray(s), k))
                     for s, k in zip(sig, keys)])
    draws = _stack([draw(k, sig.shape[1]) for k in keys])
    got = port_fn(torch.from_numpy(sig), draws).numpy()
    assert got.dtype == np.complex64 and got.shape == sig.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(ref_channel.SCENARIOS))
def test_scenario_matches_reference_given_its_draws(name):
    """Batch 8, per-frame SNRs from -10 to +18 dB, the reference's vmapped
    seven-way key split reproduced frame by frame."""
    iq, _, _ = ref_generate_batch(3, 8, frame_len=128, apply_channel=False)
    snrs = np.array([-10, -4, 0, 0.5, 6, 10, 14, 18], np.float32)
    key = jax.random.PRNGKey(23)
    want = np.asarray(ref_channel.apply_scenario(name, iq, snrs, key))
    sc = channel.SCENARIOS[name]
    draws = ref_draws(sc, key, 8, 128)
    draws = {k: (v if on else None)
             for (k, v), on in zip(draws.items(), sc.active().values())}
    got = channel.apply_scenario_draws(sc, torch.from_numpy(iq),
                                       torch.from_numpy(snrs), draws).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_scenarios_and_suites_are_the_references():
    assert list(channel.SCENARIOS) == list(ref_channel.SCENARIOS)
    for name, sc in channel.SCENARIOS.items():
        ref = ref_channel.SCENARIOS[name]
        assert [f.name for f in type(sc).__dataclass_fields__.values()] == \
            [f.name for f in type(ref).__dataclass_fields__.values()]
        for field in type(ref).__dataclass_fields__:
            assert getattr(sc, field) == getattr(ref, field), (name, field)
    assert channel.SUITES == ref_channel.SUITES


_SNRS = (-20.0, -10.0, -0.5, 0.0, 0.5, 0.9, 1.0, 10.0, 18.0, 19.999)


@pytest.mark.parametrize("which", ["stable_seed", "stable_cell_seed",
                                   "snr_bin_seed"])
def test_stable_seeds_equal_the_references(which):
    from repro_torch.deploy.monitor import _snr_bin_seed
    from repro_torch.eval import stable_cell_seed

    pairs = {
        "stable_seed": (lambda s: channel.stable_seed("urban_fading", s),
                        lambda s: ref_channel.stable_seed("urban_fading", s)),
        "stable_cell_seed": (lambda s: stable_cell_seed("clean", s),
                             lambda s: ref_stable_cell_seed("clean", s)),
        "snr_bin_seed": (_snr_bin_seed, ref_snr_bin_seed),
    }
    port, ref = pairs[which]
    got = [port(s) for s in _SNRS]
    assert got == [ref(s) for s in _SNRS]
    assert len(set(got)) == len(_SNRS)           # 0.5 and 0.9 stay apart


# ---------------------------------------------------------------------------
# the properties tests/test_channel.py pins, on the port
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(5)
MULTIPLICATIVE = {
    "carrier_offset": lambda s: imp.carrier_offset(
        s, imp.carrier_offset_draws(_RNG, len(s), 0.02, True)),
    "phase_noise": lambda s: imp.phase_noise(
        s, imp.phase_noise_draws(_RNG, len(s), s.shape[1]), 3e-3),
    "timing_offset": lambda s: imp.timing_offset(
        s, imp.timing_offset_draws(_RNG, len(s), 2e-3, 0.5)),
    "iq_imbalance": lambda s: imp.iq_imbalance(
        s, imp.iq_imbalance_draws(_RNG, len(s), 1.5, 8.0)),
    "rayleigh": lambda s: imp.multipath_fading(
        s, imp.multipath_fading_draws(_RNG, len(s), 3), (0, 2, 5),
        (1.0, 0.6, 0.3), doppler=0.01),
    "rician": lambda s: imp.multipath_fading(
        s, imp.multipath_fading_draws(_RNG, len(s), 2), (0, 3), (1.0, 0.3),
        doppler=2e-3, rician_k=4.0),
}


@pytest.mark.parametrize("name", sorted(MULTIPLICATIVE))
def test_impairment_preserves_unit_power(name):
    sig = torch.from_numpy(_unit_frames())
    out = MULTIPLICATIVE[name](sig)
    assert out.shape == sig.shape and torch.isfinite(torch.view_as_real(out)).all()
    np.testing.assert_allclose(imp.avg_power(out).numpy(), 1.0, atol=1e-3)


def test_additive_impairments_hit_target_power():
    """E[p] = 1 + 10^(-x/10) on a unit-power frame."""
    sig = torch.from_numpy(_unit_frames(batch=1, length=4096))
    rng = np.random.default_rng(7)
    for x_db in (0.0, 10.0):
        want = 1.0 + 10 ** (-x_db / 10)
        p = float(imp.avg_power(imp.awgn(sig, imp.awgn_draws(rng, 1, 4096),
                                         x_db)))
        assert p == pytest.approx(want, rel=0.1)
        p = float(imp.avg_power(imp.interferer_tones(
            sig, imp.interferer_tones_draws(rng, 1), x_db)))
        assert p == pytest.approx(want, rel=0.1)


def test_iq_complex_roundtrip():
    iq = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2, 32))
                          .astype(np.float32))
    torch.testing.assert_close(imp.to_iq(imp.to_complex(iq)), iq)


@pytest.mark.parametrize("name", sorted(channel.SCENARIOS))
def test_scenario_deterministic_in_its_seed(name):
    iq, _, snrs = radioml.generate_batch(0, 3, frame_len=64,
                                         apply_channel=False)
    a = channel.apply_scenario_np(name, iq, snrs, 11, device="cpu")
    b = channel.apply_scenario_np(name, iq, snrs, 11, device="cpu")
    np.testing.assert_array_equal(a, b)
    c = channel.apply_scenario_np(name, iq, snrs, 12, device="cpu")
    assert not np.array_equal(a, c)
    # the cached closure and the tensor entry point give the same frames
    d = channel.scenario_fn(name)(torch.from_numpy(iq), torch.from_numpy(snrs),
                                  11).numpy()
    np.testing.assert_array_equal(a, d)
    assert a.shape == iq.shape and a.dtype == np.float32 and np.isfinite(a).all()


def test_enabling_a_stage_never_reshuffles_another():
    base = channel.SCENARIOS["static_awgn"]
    more = channel.ChannelScenario(name="x", max_cfo=0.01, random_phase=True,
                                   phase_noise_scale=2e-3, sir_db=8.0,
                                   max_sro=1e-3, fading="rayleigh")
    a = channel.scenario_draws(base, 4, 64, 9)
    b = channel.scenario_draws(more, 4, 64, 9)
    for stage in ("carrier", "phase_noise", "noise"):
        for k in a[stage]:
            np.testing.assert_array_equal(a[stage][k], b[stage][k])
    assert a["interferer"] is None and b["interferer"] is not None


def test_scenario_single_frame_and_per_batch_snr():
    iq, _, _ = radioml.generate_batch(2, 4, frame_len=32, apply_channel=False)
    x = torch.from_numpy(iq)
    one = channel.apply_scenario("urban_fading", x[0], 10.0, 0)
    assert one.shape == (2, 32)
    out = channel.apply_scenario("urban_fading", x,
                                 torch.tensor([-10.0, 0.0, 5.0, 18.0]), 0)
    assert out.shape == iq.shape
    # a frame alone is the batch's first frame (same seed, same draws row)
    torch.testing.assert_close(
        channel.apply_scenario("urban_fading", x[:1], 10.0, 0)[0], one)


def test_scenario_validation_and_lookup():
    with pytest.raises(ValueError, match="fading"):
        channel.ChannelScenario(fading="bogus")
    with pytest.raises(ValueError, match="path_delays"):
        channel.ChannelScenario(path_delays=(0, 1), path_powers=(1.0,))
    with pytest.raises(ValueError, match="unknown channel scenario"):
        channel.apply_scenario("nope", torch.zeros((2, 8)), 0.0, 0)
    assert [s.name for s in channel.suite_scenarios("quick")] == \
        list(channel.SUITES["quick"])
    assert channel.suite_scenarios("static_awgn,iq_impaired")[1].name == \
        "iq_impaired"
    with pytest.raises(ValueError, match="empty scenario suite"):
        channel.suite_scenarios(" , ")


def test_legacy_channel_is_the_channel_packages():
    assert radioml._apply_channel is channel.legacy_awgn_channel
    sig = np.random.default_rng(1).normal(size=128) + 0j
    a = channel.legacy_awgn_channel(np.random.default_rng(5), sig, 6.0)
    b = ref_channel.legacy_awgn_channel(np.random.default_rng(5), sig, 6.0)
    np.testing.assert_array_equal(a, b)


def test_awgn_matches_legacy_noise_math():
    """Given the same noise, the torch AWGN applies the legacy channel's
    normalize-then-add math."""
    rng = np.random.default_rng(9)
    sig64 = rng.normal(size=128) + 1j * rng.normal(size=128)
    noise = rng.normal(size=(2, 128))
    for snr in (-10.0, 0.5, 18.0):
        ref = sig64 / np.sqrt(np.mean(np.abs(sig64) ** 2) + 1e-12)
        ref = ref + (noise[0] + 1j * noise[1]) * np.sqrt(10 ** (-snr / 10) / 2)
        out = imp.awgn(torch.from_numpy(sig64.astype(np.complex64))[None],
                       {"re": noise[0][None], "im": noise[1][None]}, snr)
        np.testing.assert_allclose(out[0].numpy(), ref.astype(np.complex64),
                                   atol=1e-6)


def test_clean_scenario_is_identity_up_to_rms_norm():
    iq, _, _ = radioml.generate_batch(4, 2, frame_len=64, apply_channel=False)
    clean = channel.ChannelScenario(name="clean", add_noise=False)
    out = channel.apply_scenario_np(clean, iq, 10.0, 0, device="cpu")
    np.testing.assert_allclose(out, iq, atol=1e-5)


def test_frame_source_impairs_generated_frames():
    src = channel.make_frame_source("doppler_drift", frame_len=32,
                                    classes=(0, 1, 2), device="cpu")
    iq, labels = src(4, 6, 10.0)
    clean, want_labels, snrs = radioml.generate_batch(
        4, 6, snr_db=10.0, classes=(0, 1, 2), frame_len=32,
        apply_channel=False)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(
        iq, channel.apply_scenario_np("doppler_drift", clean, snrs, 4,
                                      device="cpu"))


def test_channel_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    iq = np.zeros((1, 2, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        channel.apply_scenario_np("static_awgn", iq, 0.0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        channel.make_frame_source("static_awgn")
