"""Multi-rate coverage: 16 kHz / 22.05 kHz / 44.1 kHz end-to-end, with the
reference's fs-keyed constants (define_alpha magphase.py:3279-3290,
define_fft_len 3292-3299, define_crossfade_params 3301-3317).

Two kinds of gate (round-2 VERDICT item 6):
 * drift-free STREAM parity vs the reference oracle at 16 kHz — tight;
 * whole-corpus MSD bounds per rate on the resampled demo wavs — recorded
   + margin.  NOTE the margin is deliberately wider than at 48 kHz: the
   compressed pipeline's lf0 medfilt legitimately perturbs synthesis pitch
   marks, and the resulting drift makes the globally-aligned MSD swing
   several dB between outputs that differ by <4e-4 in amplitude (verified
   against the numpy oracle with shared noise and geometry); at 16 kHz two
   utterances sit in that unstable regime.
"""
import glob

import numpy as np
import jax
import pytest
from scipy import signal as sp

from magphase_jax.config import (MagPhaseConfig, define_alpha,
                                 define_fft_len, define_crossfade_params)

DATA = "/root/reference/demos/data_48k/wavs_nat"

# GATING METRIC: the drift-robust piecewise MSD (r3 VERDICT item 7) —
# the globally-aligned MSD swung several dB per utterance under
# lf0-medfilt drift at 16 kHz (hvd_594 measured 19.27 global vs 12.48
# piecewise), forcing 21 dB gates; the piecewise metric's max
# per-utterance spread across noise keys is 0.62 dB so margins tighten
# to ~+0.5/0.7.  Recorded (CPU, PRNGKey(0), floor_db=40, round 5 —
# two-phase snap window, tracker.py SNAP_*; r4 values in parens):
# 16k mean 8.85 (9.81) max 10.43 (12.48); 22050 mean 7.93 (7.83) max
# 10.22 (9.46); 44100 mean 6.86 (7.14) max 10.32 (9.98)
RATE_GATES = {
    # (up, dn, mean_max, utt_max, worst_chunk_max) — the last is the
    # UNTRIMMED worst chunk (catastrophic-artifact catch; recorded
    # 30.0 / 20.4 / 26.6 — the 16 kHz tail is the known drift regime)
    16000: (1, 3, 9.6, 11.2, 36.0),
    22050: (147, 320, 8.6, 11.0, 24.0),
    44100: (147, 160, 7.6, 11.0, 32.0),
}


def test_16k_config_constants():
    cfg = MagPhaseConfig(fs=16000)
    assert cfg.alpha == 0.58
    assert cfg.fft_len == 2048
    assert define_crossfade_params(16000) == (2500.0, 2000.0)
    assert define_alpha(22050) == 0.65
    assert define_fft_len(8000) == 1024


@pytest.fixture(scope="module")
def wav16(demo_wav):
    sig, fs = demo_wav
    assert fs == 48000
    return sp.resample_poly(sig, 1, 3), 16000


def test_16k_compressed_roundtrip(tmp_path, wav16):
    from magphase_jax.io import write_wav
    from magphase_jax.vocoder import (analysis_compressed,
                                      synthesis_from_compressed)
    sig, fs = wav16
    wav_path = str(tmp_path / "u16.wav")
    write_wav(wav_path, 0.9 * sig / np.abs(sig).max(), fs)

    # synthetic epochs (skip the tracker; its quality is tested elsewhere)
    rng = np.random.RandomState(3)
    shifts = rng.choice([80, 100, 128, 160], size=100)
    pm = np.cumsum(shifts)
    voi = (rng.rand(100) > 0.3).astype(np.float64)

    mml, mrm, mim, lf0, shift, fs_out, fft_len = analysis_compressed(
        wav_path, mag_dim=40, phase_dim=20, pm_sec=pm / fs, voi=voi)
    assert fs_out == 16000
    assert fft_len == 2048
    assert mml.shape == (100, 40)
    assert np.all(np.isfinite(mml))

    v = synthesis_from_compressed(mml, mrm, mim, lf0, fs,
                                  key=jax.random.PRNGKey(0))
    assert np.all(np.isfinite(v))
    assert np.std(v) > 1e-5


def test_16k_streams_match_reference_oracle(wav16):
    """Drift-free 16 kHz parity: analysis + format_for_modelling against
    the numpy oracle with shared epochs — pins alpha=0.58, fft 2048,
    cf 2.5 kHz to the reference's exact math."""
    from oracle import refport
    from magphase_jax.epochs import extract_epochs
    from magphase_jax.vocoder.lossless import analysis_with_del_comp_from_pm
    from magphase_jax.vocoder.compressed import format_for_modelling

    sig, fs = wav16
    sig = np.asarray(sig, np.float64)[:int(1.2 * fs)]
    pm, voi = extract_epochs(sig, fs)

    r_mag, r_real, r_imag, r_f0, _, r_shift = refport.analysis_lossless(
        sig, fs, pm, voi)
    g_mag, g_real, g_imag, g_f0, g_shift = analysis_with_del_comp_from_pm(
        sig, fs, np.asarray(pm) * fs, np.asarray(voi))
    np.testing.assert_array_equal(g_shift, r_shift)
    assert np.max(np.abs(g_mag - r_mag)) / np.max(r_mag) < 2e-6

    r_mml, r_mrm, r_mim, r_lf0 = refport.format_for_modelling(
        r_mag, r_real, r_imag, r_f0, fs, mag_dim=60, phase_dim=45)
    g_mml, g_mrm, g_mim, g_lf0 = format_for_modelling(
        r_mag, r_real, r_imag, r_f0, fs, mag_dim=60, phase_dim=45)
    np.testing.assert_allclose(g_lf0, r_lf0, atol=1e-9)
    assert np.max(np.abs(g_mml - r_mml)) < 2e-3
    assert np.max(np.abs(g_mrm - r_mrm)) < 2e-3


@pytest.mark.parametrize("fs", sorted(RATE_GATES))
def test_multirate_corpus_msd(fs):
    """Full tracker -> compressed -> synthesis loop over ALL 10 demo
    utterances resampled to ``fs``, with recorded MSD bounds."""
    from magphase_jax.io import read_wav
    from magphase_jax.parallel.analysis_batch import analysis_compressed_batch
    from magphase_jax.parallel.batch import synthesis_from_compressed_batch
    from magphase_jax.utils.eval import mel_spectral_distortion_piecewise

    up, dn, mean_max, utt_max, worst_max = RATE_GATES[fs]
    wavs = sorted(glob.glob(f"{DATA}/*.wav"))
    assert len(wavs) == 10
    toks = [w.rsplit("/", 1)[1][:-4] for w in wavs]
    sigs = [sp.resample_poly(read_wav(w)[0], up, dn) for w in wavs]

    feats = analysis_compressed_batch(sigs, fs)
    utts = [(m, r, i, l) for (m, r, i, l, _s) in feats]
    outs = synthesis_from_compressed_batch(utts, fs,
                                           key=jax.random.PRNGKey(0))
    msds = {}
    for t, s, o in zip(toks, sigs, outs):
        mean, worst = mel_spectral_distortion_piecewise(
            s, np.asarray(o), fs, floor_db=40.0, return_worst=True)
        assert worst < worst_max, (fs, t, mean, worst)
        msds[t] = mean
    mean = float(np.mean(list(msds.values())))
    assert mean < mean_max, (fs, msds)
    bad = {t: m for t, m in msds.items() if m >= utt_max}
    assert not bad, f"{fs}: per-utterance MSD over {utt_max} dB: {bad}"


def test_22050_and_44100_round_trip_smoke():
    """The other two supported rates (alpha table, magphase.py:3279-3290)
    through batched analysis + synthesis."""
    import jax
    from magphase_jax.parallel.analysis_batch import analysis_compressed_batch
    from magphase_jax.parallel.batch import synthesis_from_compressed_batch

    for fs in (22050, 44100):
        t = np.arange(int(1.0 * fs)) / fs
        sig = 0.3 * np.sign(np.sin(2 * np.pi * 140 * t))
        feats = analysis_compressed_batch([sig], fs, mag_dim=40,
                                          phase_dim=20)
        mml, mrm, mim, lf0, sh = feats[0]
        assert (lf0 > -1e9).mean() > 0.8
        wavs = synthesis_from_compressed_batch(
            [(mml, mrm, mim, lf0)], fs, key=jax.random.PRNGKey(0))
        w = wavs[0]
        assert np.all(np.isfinite(w)) and np.std(w) > 1e-3
        assert abs(len(w) - len(sig)) < fs // 5
