"""Pitch tracker + epoch placement (the REAPER replacement)."""
import numpy as np
import pytest

from magphase_jax.epochs.tracker import extract_epochs, track_f0


@pytest.fixture(scope="module")
def sweep():
    fs = 48000
    t = np.arange(int(fs * 1.0)) / fs
    f0_true = 150 + 100 * t
    phase = 2 * np.pi * np.cumsum(f0_true) / fs
    sig = (np.sin(phase) + 0.3 * np.sin(2 * phase)
           + 0.01 * np.random.RandomState(0).randn(len(t)))
    return sig, fs, t, f0_true


def test_f0_sweep_accuracy(sweep):
    sig, fs, t, f0_true = sweep
    f0, voiced, step, _ = track_f0(sig, fs)
    tt = np.arange(len(f0)) * step
    sel = (tt > 0.1) & (tt < 0.9)
    assert voiced[sel].mean() > 0.95
    ref = np.interp(tt[sel], t, f0_true)
    rel = np.abs(f0[sel] - ref) / ref
    assert np.median(rel) < 0.01
    assert np.max(rel) < 0.05


def test_unvoiced_noise_not_voiced():
    fs = 48000
    sig = np.random.RandomState(1).randn(fs // 2) * 0.1
    f0, voiced, step, _ = track_f0(sig, fs)
    assert voiced.mean() < 0.2


def test_epochs_monotonic_and_spaced(sweep):
    sig, fs, t, f0_true = sweep
    pm, voi = extract_epochs(sig, fs)
    assert np.all(np.diff(pm) > 0)
    assert pm[-1] * fs < len(sig) - 1
    # voiced epochs must track the local period
    vm = pm[voi > 0]
    per = np.diff(vm)
    f0_at = np.interp(vm[:-1], t, f0_true)
    rel = np.abs(per - 1.0 / f0_at) * f0_at
    assert np.median(rel) < 0.2    # within 20% of a period


def test_demo_wav_copy_synthesis_quality(demo_wav):
    """Tracker-driven lossless copy synthesis must reconstruct the demo
    utterance to sub-PCM16 accuracy over most samples (the unvoiced 5 ms
    marks and voiced shift round-trips are float-exact)."""
    from magphase_jax.vocoder import (analysis_with_del_comp_from_pm,
                                      synthesis_from_lossless)
    from magphase_jax.epochs.tracker import extract_epochs
    sig, fs = demo_wav
    pm_sec, voi = extract_epochs(sig, fs)
    m_mag, m_real, m_imag, v_f0, v_shift = analysis_with_del_comp_from_pm(
        sig, fs, pm_sec * fs, voi)
    syn = synthesis_from_lossless(m_mag, m_real, m_imag, v_f0, fs)
    n = min(len(sig), len(syn))
    a, b = int(pm_sec[0] * fs), n - 2000
    err = np.abs(syn[a:b] - sig[a:b])
    # allow a small fraction of samples to deviate (pm rounding at
    # voicing boundaries); bulk must be at PCM16 noise level
    assert np.percentile(err, 99) < 2.0 ** -14


def test_tracker_all_supported_rates():
    """f0 must be rate-invariant: the NCCF geometry derives from the
    actual analysis rate (22050/44100 were skewed by fs_a/16000 before)."""
    for fs in (16000, 22050, 44100, 48000):
        t = np.arange(int(1.0 * fs)) / fs
        sig = 0.4 * np.sign(np.sin(2 * np.pi * 150 * t))
        f0, voiced, step, _ = track_f0(sig, fs)
        sel = voiced & (f0 > 0)
        assert sel.mean() > 0.5, fs
        assert abs(np.median(f0[sel]) - 150.0) < 5.0, fs
