"""Objective eval metric (mel-spectral distortion)."""
import numpy as np

from magphase_jax.utils.eval import (log_mel_spectrogram,
                                     log_spectral_distortion_feats,
                                     mel_spectral_distortion)


def test_msd_identity_is_zero():
    rng = np.random.RandomState(0)
    sig = rng.randn(48000).astype(np.float64) * 0.1
    assert mel_spectral_distortion(sig, sig, 48000) == 0.0


def test_msd_detects_spectral_change():
    rng = np.random.RandomState(0)
    sig = rng.randn(48000) * 0.1
    # low-passed copy must measure a clearly nonzero distortion
    k = np.ones(8) / 8.0
    lp = np.convolve(sig, k, mode="same")
    d = mel_spectral_distortion(sig, lp, 48000)
    assert d > 1.0


def test_logmel_shape_and_feat_msd():
    sig = np.sin(np.arange(24000) * 0.03)
    m = log_mel_spectrogram(sig, 48000, n_mel=40)
    assert m.shape[1] == 40
    assert m.shape[0] > 50
    assert log_spectral_distortion_feats(m, m) == 0.0
    assert log_spectral_distortion_feats(m, m + 0.1) > 0.0


def test_msd_alignment_removes_time_shift():
    rng = np.random.RandomState(0)
    sig = rng.randn(48000) * 0.1
    shifted = np.concatenate([np.zeros(600), sig])[:48000]
    d_noalign = mel_spectral_distortion(sig, shifted, 48000, align=False)
    d_align = mel_spectral_distortion(sig, shifted, 48000, align=True)
    assert d_align < 0.05 * d_noalign
    assert d_align < 1.0


def test_msd_exclude_gain_ignores_level():
    rng = np.random.RandomState(0)
    sig = rng.randn(48000) * 0.1
    d = mel_spectral_distortion(sig, sig * 0.7, 48000, exclude_gain=True)
    assert d < 1e-4


def test_msd_piecewise_removes_mid_utterance_drift():
    """Per-span constant time shifts (zero mean, so the global aligner
    stays near lag 0): global alignment can satisfy at most one span,
    local alignment recovers each — piecewise MSD must sit far below the
    globally-aligned MSD."""
    from magphase_jax.utils.eval import mel_spectral_distortion_piecewise
    from magphase_jax.utils.tracker_eval import make_stimulus
    fs = 48000
    sig, _, _, _ = make_stimulus(fs, [(3.0, 110.0, 180.0)], seed=2)
    n = len(sig)
    cs = fs // 2
    shifts = [0, 20, -25, 10, -15, 15]
    drift = np.concatenate([np.full(cs, sh) for sh in shifts])
    drift = np.concatenate([drift, np.full(n - len(drift), shifts[-1])])
    warped = sig[np.clip(np.arange(n) + drift, 0, n - 1)]
    d_global = mel_spectral_distortion(sig, warped, fs)
    d_piece = mel_spectral_distortion_piecewise(sig, warped, fs)
    assert d_piece < 0.5 * d_global, (d_piece, d_global)
    assert d_piece < 1.5, (d_piece, d_global)
