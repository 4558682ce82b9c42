"""Pitch-synchronous Griffin-Lim (magphase.py:3320-3373) and the
per_phase_type synthesis variants."""
import os

import jax
import numpy as np
import pytest

from magphase_jax.io import read_binfile

PRED = "/root/reference/demos/data_48k/params_predicted"


@pytest.fixture(scope="module")
def mag_and_shifts(demo_wav, synthetic_pm):
    from magphase_jax.vocoder import analysis_with_del_comp_from_pm
    sig, fs = demo_wav
    pm, shifts = synthetic_pm
    pm, shifts = pm[:80], shifts[:80]
    mag, *_ = analysis_with_del_comp_from_pm(sig, fs, pm, np.ones(len(pm)),
                                             fft_len=1024)
    return mag, shifts


def _recon_err(m_mag, v_shift, v_sig):
    """Magnitude-consistency error: |STFT-mag(sig) - target|."""
    from magphase_jax.vocoder import analysis_with_del_comp_from_pm
    pm = np.cumsum(v_shift)
    mag, *_ = analysis_with_del_comp_from_pm(
        v_sig, 48000, pm, np.ones(len(pm)), fft_len=1024)
    n = min(len(mag), len(m_mag))
    return float(np.mean(np.abs(mag[:n] - m_mag[:n])))


@pytest.mark.parametrize("init", ["random", "linear", "min_phase"])
def test_griffin_lim_converges(mag_and_shifts, init):
    from magphase_jax.vocoder import griffin_lim
    m_mag, shifts = mag_and_shifts
    v1, _ = griffin_lim(m_mag, shifts, phase_init=init, niters=1,
                        key=jax.random.PRNGKey(0))
    v8, ph = griffin_lim(m_mag, shifts, phase_init=init, niters=8,
                         key=jax.random.PRNGKey(0))
    assert np.all(np.isfinite(v8))
    assert ph.shape == (len(m_mag), m_mag.shape[1])
    # more iterations must not worsen magnitude consistency
    e1 = _recon_err(m_mag, shifts, v1)
    e8 = _recon_err(m_mag, shifts, v8)
    assert e8 <= e1 * 1.05


@pytest.mark.parametrize("ptype", ["linear", "min_phase"])
def test_synthesis_per_phase_variants(ptype):
    from magphase_jax.vocoder import synthesis_from_compressed
    mag = read_binfile(os.path.join(PRED, "hvd_704.mag"), 60)[:64]
    real = read_binfile(os.path.join(PRED, "hvd_704.real"), 45)[:64]
    imag = read_binfile(os.path.join(PRED, "hvd_704.imag"), 45)[:64]
    lf0 = read_binfile(os.path.join(PRED, "hvd_704.lf0"), 1)[:64]
    v = synthesis_from_compressed(mag, real, imag, lf0, 48000,
                                  per_phase_type=ptype,
                                  key=jax.random.PRNGKey(0))
    assert np.all(np.isfinite(v))
    assert np.std(v) > 1e-4


def test_griffin_lim_ndarray_init_matches_numpy_one_iter(mag_and_shifts):
    """ndarray phase_init (magphase.py:3348-3349), one iteration: the loop
    never re-analyses, so output = OLA(ifft(mag * exp(i*herm_phase(init))))
    -- re-stated here in numpy with the reference's centred OLA."""
    from magphase_jax.vocoder import griffin_lim
    m_mag, shifts = mag_and_shifts
    m_mag = np.asarray(m_mag[:40], np.float64)
    shifts = np.asarray(shifts[:40]).astype(np.int64)
    nfrms, h = m_mag.shape
    fft_len = 2 * (h - 1)

    rng = np.random.RandomState(7)
    phase0 = rng.uniform(-np.pi, np.pi, size=(nfrms, h))

    got, got_ph = griffin_lim(m_mag, shifts, phase_init=phase0, niters=1)

    # numpy oracle
    ph = phase0.copy()
    ph[:, 0] = 0.0
    ph[:, -1] = 0.0
    ph_full = np.hstack([ph, -ph[:, -2:0:-1]])
    mag_full = np.hstack([m_mag, m_mag[:, -2:0:-1]])
    m_frm = np.fft.ifft(mag_full * np.exp(1j * ph_full)).real
    v_pm = np.cumsum(shifts)
    v_shift_ext = np.append(np.diff(np.hstack((0, v_pm))),
                            v_pm[-1] - v_pm[-2])
    buf = np.zeros(v_pm[-1] + fft_len)
    strt = 0
    for i in range(nfrms):
        buf[strt:strt + fft_len] += m_frm[i]
        strt += v_shift_ext[i + 1]
    want = buf[fft_len // 2 - v_pm[0]:]
    want = want[:v_pm[-1] + v_shift_ext[-1] + 1]

    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], atol=2e-4)
    # the returned phase is the (hermitian-fixed) init itself
    np.testing.assert_allclose(got_ph, ph, atol=1e-6)


@pytest.mark.parametrize("gl_type", [None, "det", "whole"])
def test_synthesis_type1_old_with_griffin_lim(gl_type):
    """magphase.py:617-794 on real predicted params: finite, speech-scaled
    output in every griff_lim_type mode."""
    from magphase_jax.vocoder import (
        synthesis_from_compressed_type1_old_with_griffin_lim)
    mag = read_binfile(os.path.join(PRED, "hvd_704.mag"), 60)[:64]
    real = read_binfile(os.path.join(PRED, "hvd_704.real"), 45)[:64]
    imag = read_binfile(os.path.join(PRED, "hvd_704.imag"), 45)[:64]
    lf0 = read_binfile(os.path.join(PRED, "hvd_704.lf0"), 1)[:64]
    niters = {"det": 3, "whole": 4}   # keep CI fast; ref: 10 / 50
    import magphase_jax.vocoder.variants as V
    orig = V.synthesis_from_compressed_type1_old_with_griffin_lim
    v = orig(mag, real, imag, lf0, 48000, griff_lim_type=gl_type,
             key=jax.random.PRNGKey(0))
    assert np.all(np.isfinite(v))
    assert np.std(v) > 1e-4
    # ~0.5 s of 48 kHz audio for 64 frames
    assert 10000 < len(v) < 48000
