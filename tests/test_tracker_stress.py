"""Tracker robustness outside clean read speech (REAPER's envelope,
libaudio.py:450-455: ``reaper -x 400 -m 50 -u 0.005``).

Synthetic fixtures probe the corners the demo corpus never exercises:
creak-like low F0 near the 50 Hz floor, F0 near the 400 Hz ceiling,
additive noise at 10/20 dB SNR, and silence-speech-silence boundaries.
Voicing accuracy is asserted per region, f0 accuracy where voiced."""
import numpy as np
import pytest

from magphase_jax.epochs.tracker import track_f0

FS = 48000


def _glottal(f0_hz, dur_s, fs=FS, jitter=0.0, seed=0):
    """Sawtooth-like voiced source (decaying harmonics), optional jitter.

    A harmonic-rich deterministic source is the stress-relevant shape:
    NCCF sees the true period plus strong sub-multiples, which is what
    makes octave errors possible at the range edges."""
    rng = np.random.RandomState(seed)
    n = int(dur_s * fs)
    if np.isscalar(f0_hz):
        f0 = np.full(n, float(f0_hz))
    else:
        f0 = np.asarray(f0_hz, np.float64)
    if jitter:
        # cycle-rate jitter: low-passed noise modulating f0
        m = rng.randn(n // 480 + 2)
        f0 = f0 * (1.0 + jitter * np.interp(
            np.arange(n), np.arange(len(m)) * 480, m))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    sig = np.zeros(n)
    for k in range(1, 13):
        if np.max(f0) * k < 0.45 * fs:
            sig += np.sin(k * phase) / k
    return sig / np.max(np.abs(sig))


def _voicing_and_f0(sig, f0_true, *, lo_s=0.1, hi_s=None):
    f0, voiced, step, _ = track_f0(sig, FS)
    tt = np.arange(len(f0)) * step
    hi = hi_s if hi_s is not None else len(sig) / FS - 0.1
    sel = (tt > lo_s) & (tt < hi)
    return f0[sel], voiced[sel]


def test_creak_low_f0_60hz():
    """Creak-like phonation: 60 Hz with 3% jitter must stay voiced and
    on-pitch (not dropped or octave-doubled)."""
    sig = _glottal(60.0, 1.0, jitter=0.03)
    f0, voiced = _voicing_and_f0(sig, 60.0)
    assert voiced.mean() > 0.9, voiced.mean()
    sel = voiced & (f0 > 0)
    assert abs(np.median(f0[sel]) - 60.0) < 4.0, np.median(f0[sel])


def test_f0_near_ceiling_390hz():
    """Near the -x 400 ceiling: must voice and not octave-halve to 195."""
    sig = _glottal(390.0, 1.0)
    f0, voiced = _voicing_and_f0(sig, 390.0)
    assert voiced.mean() > 0.9, voiced.mean()
    sel = voiced & (f0 > 0)
    assert abs(np.median(f0[sel]) - 390.0) < 10.0, np.median(f0[sel])


@pytest.mark.parametrize("snr_db,min_voicing,f0_tol", [
    (20.0, 0.90, 3.0),
    (10.0, 0.80, 5.0),
])
def test_additive_noise_snr(snr_db, min_voicing, f0_tol):
    """Voiced 150 Hz source in white noise at 20/10 dB SNR."""
    sig = _glottal(150.0, 1.0, seed=3)
    noise = np.random.RandomState(7).randn(len(sig))
    noise *= np.std(sig) / np.std(noise) * 10 ** (-snr_db / 20.0)
    f0, voiced = _voicing_and_f0(sig + noise, 150.0)
    assert voiced.mean() > min_voicing, (snr_db, voiced.mean())
    sel = voiced & (f0 > 0)
    assert abs(np.median(f0[sel]) - 150.0) < f0_tol, np.median(f0[sel])


def test_silence_speech_silence_boundaries():
    """Digital silence / 120 Hz speech / silence: voicing must switch at
    the boundaries (+-40 ms slop) and silence must never be voiced."""
    fs = FS
    sil = np.zeros(int(0.3 * fs))
    speech = _glottal(120.0, 0.6, seed=5)
    # 10 ms raised-cosine onset/offset: avoids click transients that
    # REAPER-style trackers legitimately treat as irregular
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(int(0.01 * fs))
                              / int(0.01 * fs))
    speech[:len(ramp)] *= ramp
    speech[-len(ramp):] *= ramp[::-1]
    sig = np.concatenate([sil, speech, sil])

    f0, voiced, step, _ = track_f0(sig, fs)
    tt = np.arange(len(f0)) * step
    in_sil = (tt < 0.3 - 0.04) | (tt > 0.9 + 0.04)
    in_speech = (tt > 0.3 + 0.04) & (tt < 0.9 - 0.04)
    assert voiced[in_sil].mean() < 0.05, voiced[in_sil].mean()
    assert voiced[in_speech].mean() > 0.9, voiced[in_speech].mean()
    sel = in_speech & voiced & (f0 > 0)
    assert abs(np.median(f0[sel]) - 120.0) < 4.0, np.median(f0[sel])


def test_voiced_unvoiced_alternation():
    """Alternating voiced/unvoiced 200 ms segments (fricative-vowel
    rhythm): per-segment majority decisions must be correct."""
    fs = FS
    rng = np.random.RandomState(11)
    segs, labels = [], []
    for i in range(5):
        if i % 2 == 0:
            segs.append(_glottal(140.0, 0.2, seed=i))
            labels.append(1)
        else:
            segs.append(0.08 * rng.randn(int(0.2 * fs)))
            labels.append(0)
    sig = np.concatenate(segs)
    f0, voiced, step, _ = track_f0(sig, fs)
    tt = np.arange(len(f0)) * step
    for i, lab in enumerate(labels):
        sel = (tt > 0.2 * i + 0.05) & (tt < 0.2 * (i + 1) - 0.05)
        frac = voiced[sel].mean()
        if lab:
            assert frac > 0.8, (i, frac)
        else:
            assert frac < 0.2, (i, frac)
