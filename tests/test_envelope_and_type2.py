"""Direct tests for the previously-unexercised implemented paths
(round-2 VERDICT item 4): true_envelope, spectral_smoothing_rceps,
analysis_lossless_type2, and the est-file write round trip."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from oracle import refport


def test_spectral_smoothing_rceps_matches_reference():
    """libaudio.py:203-238 semantics, including the reference's
    odd hanning fade slice."""
    from magphase_jax.core.spectral import spectral_smoothing_rceps
    rng = np.random.RandomState(0)
    m_sp_log = rng.randn(6, 129) * 2.0
    for nc_total, fade in ((60, 0.2), (40, 0.7), (100, 0.5)):
        want = refport.spectral_smoothing_rceps(m_sp_log.copy(),
                                                nc_total=nc_total,
                                                fade_to_total=fade)
        got = np.asarray(spectral_smoothing_rceps(
            jnp.asarray(m_sp_log, jnp.float32), nc_total=nc_total,
            fade_to_total=fade))
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5,
                                   err_msg=f"nc={nc_total} fade={fade}")


def test_true_envelope_matches_reference():
    """libaudio.py:295-340: per-frame iterative max(spec, smoothed) with
    early exit — the framework's freeze-mask scan must reproduce the
    reference's per-frame break semantics, including frames that converge
    at different iteration counts."""
    from magphase_jax.core.spectral import true_envelope
    rng = np.random.RandomState(1)
    h = 129
    # mix of smooth frames (converge immediately) and harmonic-comb frames
    # (many iterations)
    freqs = np.linspace(0, np.pi, h)
    frames = [
        1.0 + 0.2 * np.cos(3 * freqs),
        np.abs(1.0 + 0.9 * np.cos(25 * freqs)) + 0.05,
        np.exp(0.5 * rng.randn(h)),
        np.abs(2.0 + np.cos(40 * freqs) + 0.3 * rng.randn(h)) + 0.05,
    ]
    m_sp = np.asarray(frames)
    for in_type, m_in in (("abs", m_sp), ("db", refport.db(m_sp)),
                          ("log", np.log(m_sp))):
        want = refport.true_envelope(m_in, in_type=in_type, ncoeffs=20,
                                     thres_db=0.1)
        got = np.asarray(true_envelope(jnp.asarray(m_in, jnp.float32),
                                       in_type=in_type, ncoeffs=20,
                                       thres_db=0.1))
        # compare in dB domain regardless of in_type
        if in_type == "abs":
            w, g = refport.db(want), refport.db(got)
        elif in_type == "log":
            w, g = want * 20 / np.log(10), got * 20 / np.log(10)
        else:
            w, g = want, got
        assert np.max(np.abs(w - g)) < 0.05, in_type  # dB


def test_analysis_lossless_type2_matches_reference():
    """magphase.py:2793-2866 (even/odd interleave + true-envelope magnitude
    + type2 phase with gain) vs the oracle port, on a generated
    speech-like slice (utils/stimuli.py)."""
    from magphase_jax.io import wav as wav_io
    from magphase_jax import epochs
    from magphase_jax.utils.stimuli import make_corpus
    from magphase_jax.vocoder import variants

    u = make_corpus(1, 48000, seed=4, min_s=1.0, max_s=1.0)[0]
    fs = u.fs
    # on the PCM16 lattice, so the wav write/read below is exact
    v_sig = np.rint(u.sig[:int(0.6 * fs)] * 32768.0) / 32768.0
    pm_sec, voi = epochs.extract_epochs(v_sig, fs)

    want = refport.analysis_lossless_type2(v_sig, fs, pm_sec, voi)
    w_env, w_real, w_imag, w_f0, _, w_shift, w_gain = want

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        wav_path = os.path.join(d, "slice.wav")
        # PCM16 write/read is exact here: the slice's samples already
        # sit on the PCM16 lattice
        wav_io.write_wav(wav_path, v_sig, fs)
        got = variants.analysis_lossless_type2(wav_path, pm_sec=pm_sec,
                                               voi=voi)
    g_env, g_real, g_imag, g_f0, g_fs, g_shift, g_gain = got

    assert g_fs == fs
    assert g_env.shape == w_env.shape
    np.testing.assert_allclose(g_shift, w_shift, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(g_f0, w_f0)
    # gains: voiced = max|first-half frame|, unvoiced = std of ragged frame
    np.testing.assert_allclose(g_gain, w_gain, rtol=2e-4, atol=1e-7)
    # phase streams (unit phasors)
    assert np.percentile(np.abs(g_real - w_real), 99) < 2e-4
    assert np.percentile(np.abs(g_imag - w_imag), 99) < 2e-4
    # true-envelope magnitude, compared in dB
    err_db = np.abs(refport.db(g_env) - refport.db(w_env))
    assert np.mean(err_db) < 0.05
    assert np.percentile(err_db, 99) < 0.5


def test_write_reaper_est_file_round_trip(tmp_path):
    """io/est.py: write -> read recovers times (1e-6 s precision) and
    voicing exactly, through the reader's REAPER-bug guards."""
    from magphase_jax.io import est as est_io
    rng = np.random.RandomState(3)
    fs = 48000
    shifts = rng.randint(100, 500, 50)
    pm_sec = np.cumsum(shifts) / float(fs)
    voi = (rng.rand(50) > 0.3).astype(np.float64)
    path = str(tmp_path / "t.est")
    est_io.write_reaper_est_file(path, pm_sec, voi)
    pm2, voi2 = est_io.read_reaper_est_file(
        path, check_len_smpls=int(pm_sec[-1] * fs) + 1000, fs=fs)
    np.testing.assert_allclose(pm2, pm_sec, atol=1.01e-6)
    np.testing.assert_array_equal(voi2, voi)
