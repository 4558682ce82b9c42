"""Lossless analysis/synthesis: framing oracle + reconstruction property.

The reference's own "bit-matching" behaviour is that lossless
copy-synthesis reproduces the waveform: pitch-synchronous asymmetric
hanning windows of adjacent frames sum to exactly 1 over each shared pitch
period, so analysis -> synthesis is an identity in the interior
(magphase.py:266-334 + 1759-1776).  We verify that property end-to-end on a
generated 48 kHz speech-like utterance (tests/conftest.py:demo_wav) with
deterministic pitch marks.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from magphase_jax.core import framing
from magphase_jax.core.windows import HANNING, gen_non_symmetric_win_np
from magphase_jax.vocoder import (analysis_with_del_comp_from_pm,
                                  synthesis_from_lossless)


def _np_windowing_frames(v_sig, v_pm, fft_len):
    """Direct port of the reference framing+delay-compensation loop
    (magphase.py:74-119, 309-323) as oracle: returns (nfrms, fft_len)."""
    n = len(v_sig)
    pm_plus = np.hstack((0, v_pm, n - 1))
    nfrms = len(v_pm)
    out = np.zeros((nfrms, fft_len))
    for f in range(nfrms):
        left_lim, pm, right_lim = pm_plus[f], pm_plus[f + 1], pm_plus[f + 2]
        frm = v_sig[left_lim:right_lim + 1]
        L, R = pm - left_lim, right_lim - pm
        win = gen_non_symmetric_win_np(L, R, np.hanning)
        frm = frm * win
        padded = np.zeros(fft_len)
        padded[:min(len(frm), fft_len)] = frm[:fft_len]
        out[f] = np.hstack((padded[L:], padded[:L]))
    return out


def test_frames_match_reference_loop(demo_wav, synthetic_pm):
    sig, fs = demo_wav
    pm, _ = synthetic_pm
    pm = pm[pm < len(sig) - 2000][:50]
    fft_len = 4096

    oracle = _np_windowing_frames(sig, pm, fft_len)

    F = 64
    pm_pad = np.zeros(F, np.int32)
    pm_pad[:len(pm)] = pm
    frames, L, R, valid = framing.pitch_sync_frames(
        jnp.asarray(sig, jnp.float32), jnp.asarray(pm_pad),
        jnp.int32(len(pm)), jnp.int32(len(sig)), fft_len, HANNING)
    got = np.asarray(frames)[:len(pm)]
    np.testing.assert_allclose(got, oracle, atol=2e-6)


def test_lossless_roundtrip_reconstructs_waveform(demo_wav, synthetic_pm):
    sig, fs = demo_wav
    pm, shifts = synthetic_pm
    keep = pm < len(sig) - 2000
    pm = pm[keep]
    voi = np.ones(len(pm))

    m_mag, m_real, m_imag, v_f0, v_shift = analysis_with_del_comp_from_pm(
        sig, fs, pm.astype(np.float64), voi)

    # with fs-divisor shifts the f0->shift round trip is exact
    np.testing.assert_array_equal(np.round(fs / v_f0).astype(int), v_shift)

    v_syn = synthesis_from_lossless(m_mag, m_real, m_imag, v_f0, fs)

    # interior region: [pm[0], pm[-1])
    a, b = int(pm[0]), int(pm[-1])
    err = np.abs(v_syn[a:b] - sig[a:b])
    # float32 device pipeline; 2^-15 is one PCM16 lsb
    assert np.max(err) < 2.0 ** -15, f"max err {np.max(err):.2e}"


def test_analysis_feats_shapes_and_ranges(demo_wav, synthetic_pm):
    sig, fs = demo_wav
    pm, _ = synthetic_pm
    pm = pm[pm < len(sig) - 2000]
    voi = np.ones(len(pm))
    m_mag, m_real, m_imag, v_f0, v_shift = analysis_with_del_comp_from_pm(
        sig, fs, pm.astype(np.float64), voi)
    h = 4096 // 2 + 1
    assert m_mag.shape == (len(pm), h)
    assert np.all(m_mag >= 0)
    # real/imag are unit-phasor components
    norm = m_real ** 2 + m_imag ** 2
    np.testing.assert_allclose(norm[m_mag > 1e-9], 1.0, atol=1e-3)
    assert np.all(v_f0 > 0)


def test_synthesis_with_del_comp_reconstructs(demo_wav, synthetic_pm):
    """Legacy mag+phase OLA synthesis (magphase.py:371-419,
    win_flat_to_len>=1 path).

    The reference mirrors the phase with add_hermitian_half('phase'),
    which ZEROES the DC/Nyquist phase (libaudio.py:375-377) — so its own
    round trip flips the sign of negative-DC frames and is only
    approximately reconstructive.  Assert (a) exact agreement with a
    numpy re-statement of the reference semantics, and (b) the loose
    interior reconstruction the reference achieves."""
    import numpy as np
    from magphase_jax.vocoder import (analysis_with_del_comp_from_pm,
                                      synthesis_with_del_comp)
    sig, fs = demo_wav
    pm, shifts = synthetic_pm
    mag, real, imag, f0, shift = analysis_with_del_comp_from_pm(
        sig, fs, pm, np.ones(len(pm)))
    m_ph = np.angle(real + 1j * imag)
    syn = synthesis_with_del_comp(mag, m_ph, shift)

    # (a) reference semantics, restated in numpy
    ph0 = m_ph.copy()
    ph0[:, 0] = 0.0
    ph0[:, -1] = 0.0
    frames = np.fft.irfft((mag * np.exp(1j * ph0)).astype(np.complex64),
                          n=2 * (mag.shape[1] - 1))
    frames = np.roll(frames, mag.shape[1] - 1, axis=1).astype(np.float32)
    fft_len = 2 * (mag.shape[1] - 1)
    v_pm = np.cumsum(np.round(shift).astype(np.int64))
    ref = np.zeros(int(v_pm[-1]) + fft_len)
    for f in range(len(v_pm) - 1):          # reference adds frames 0..n-2
        st = int(v_pm[f]) - fft_len // 2
        for o in range(fft_len):
            if 0 <= st + o < len(ref):
                ref[st + o] += frames[f, o]
    ref = ref[:len(syn)]
    np.testing.assert_allclose(syn[:len(ref)], ref, atol=1e-4)

    # (b) loose interior reconstruction (DC sign flips bound the error)
    a = int(pm[0]) + 500
    b = min(len(syn), len(sig), int(pm[-2]))
    err = np.abs(syn[a:b] - sig[a:b])
    assert np.percentile(err, 99) < 0.05


def test_synthesis_with_del_comp_dead_branch_raises():
    import numpy as np
    import pytest
    from magphase_jax.vocoder import synthesis_with_del_comp
    with pytest.raises(NotImplementedError):
        synthesis_with_del_comp(np.ones((4, 9)), np.zeros((4, 9)),
                                np.full(4, 4), win_flat_to_len=0.3)


def test_densify_pitch_marks_matches_numpy_oracle():
    """Numpy re-statement of the nwin_per_pitch_period>=1 branch
    (magphase.py:280-288): tile/step/flatten('F'), last mark dropped."""
    from magphase_jax.vocoder.lossless import densify_pitch_marks

    rng = np.random.RandomState(0)
    pm = np.cumsum(rng.randint(80, 300, size=20)).astype(np.float64)
    for nwin in (1.0, 1.5, 2.0):
        n_eps = int(nwin * 2)
        diff = np.diff(pm)
        step = diff / float(n_eps)
        m = np.tile(step, (n_eps, 1))
        m = m * np.arange(n_eps)[:, None]
        m = m + pm[:-1]
        want = m.flatten(order="F")

        got, voi = densify_pitch_marks(pm, nwin, np.ones(len(pm)))
        np.testing.assert_allclose(got, want)
        assert len(got) == (len(pm) - 1) * n_eps
        assert voi.shape == got.shape

    # 0.5 is a pass-through
    got, _ = densify_pitch_marks(pm, 0.5, None)
    np.testing.assert_array_equal(got, pm)


def test_analysis_nwin1_equals_predensified(demo_wav, synthetic_pm):
    """analysis(nwin=1) must equal analysis(0.5) over the densified train."""
    from magphase_jax.vocoder.lossless import densify_pitch_marks

    sig, fs = demo_wav
    pm, _ = synthetic_pm
    pm = pm[pm < len(sig) - 2000][:40].astype(np.float64)
    voi = np.ones(len(pm))

    dense_pm, dense_voi = densify_pitch_marks(pm, 1.0, voi)
    want = analysis_with_del_comp_from_pm(sig, fs, dense_pm, dense_voi,
                                          fft_len=1024)
    got = analysis_with_del_comp_from_pm(sig, fs, pm, voi, fft_len=1024,
                                         nwin_per_pitch_period=1.0)
    assert got[0].shape[0] == (len(pm) - 1) * 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_lossless_copy_synthesis_generated(fs):
    """Batched lossless copy-synthesis (tracker -> epoch walk -> analysis
    -> resynthesis in one program) reconstructs generated speech-like
    utterances to within one PCM16 step (p99)."""
    from magphase_jax.parallel.copy_synthesis import copy_synthesis_batch
    from magphase_jax.utils.stimuli import make_corpus

    sigs = [np.rint(u.sig * 32768.0) / 32768.0
            for u in make_corpus(2, fs, seed=21, min_s=1.0, max_s=1.5)]
    for sig, syn in zip(sigs, copy_synthesis_batch(sigs, fs)):
        assert np.all(np.isfinite(syn))
        n = min(len(sig), len(syn))
        err = np.abs(syn[2000:n - 2000] - sig[2000:n - 2000])
        assert np.percentile(err, 99) < 2.0 ** -15
