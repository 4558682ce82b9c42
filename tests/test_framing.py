"""Batched pitch-synchronous framing and overlap-add (core/framing.py) vs
the numpy port of the reference (tests/oracle/refport.py: windowing +
zero-pad + delay-compensation rotate, magphase.py:291-323; ola,
magphase.py:34-62)."""
import jax.numpy as jnp
import numpy as np
import pytest

from magphase_jax.core import framing, windows as W
from oracle import refport

FAMILIES = {W.HANNING: np.hanning, W.VOI_NOISE: refport.voi_noise_window,
            W.BOXCAR: np.ones}


def _marks(rng, n_sig, lo, hi):
    pm = np.cumsum(rng.randint(lo, hi, n_sig // lo))
    return pm[pm < n_sig - hi].astype(np.int64)


def _ref_frames(sig, pm, fft_len, win):
    """Reference frames: the windowing/zero-pad/rotate loop of
    refport.analysis_with_del_comp_from_pm, before its FFT."""
    frames, lens, _, shifts, _ = refport.windowing(sig, pm, win_func=win)
    out = np.zeros((len(frames), fft_len))
    for f, fr in enumerate(frames):
        out[f, :lens[f]] = fr[:fft_len]
        out[f] = np.roll(out[f], -shifts[f])
    return out


def _batch(sigs, pms, F):
    B = len(sigs)
    S = max(len(s) for s in sigs)
    sig_b = np.zeros((B, S), np.float32)
    pm_b = np.zeros((B, F), np.int32)
    for b, (s, p) in enumerate(zip(sigs, pms)):
        sig_b[b, :len(s)] = s
        pm_b[b, :len(p)] = p
    return (jnp.asarray(sig_b), jnp.asarray(pm_b),
            jnp.asarray([len(p) for p in pms], jnp.int32),
            jnp.asarray([len(s) for s in sigs], jnp.int32))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("fft_len", [1024, 2048, 4096])
def test_pitch_sync_frames_batch_matches_reference(fft_len, family):
    rng = np.random.RandomState(fft_len + family)
    hi = fft_len // 2 - 8            # every frame fits its fft_len row
    sigs = [rng.randn(n) * 0.3 for n in (6 * fft_len, 4 * fft_len + 77)]
    pms = [_marks(rng, len(s), hi // 3, hi) for s in sigs]
    sig, pm, nfrms, n_sig = _batch(sigs, pms, max(map(len, pms)) + 3)
    got, L, R, valid = framing.pitch_sync_frames_batch(
        sig, pm, nfrms, n_sig, fft_len, win_family=family)
    got = np.asarray(got)
    for b, (s, p) in enumerate(zip(sigs, pms)):
        want = _ref_frames(s.astype(np.float32), p, fft_len,
                           FAMILIES[family])
        np.testing.assert_allclose(got[b, :len(p)], want, atol=2e-6)
        assert not np.any(got[b, len(p):])
        np.testing.assert_array_equal(np.asarray(L)[b, :len(p)],
                                      np.diff(np.hstack((0, p))))


def test_pitch_sync_frames_batch_voiced_window_select():
    """Per-frame window family (noise framing, magphase.py:886-892)."""
    rng = np.random.RandomState(3)
    fft_len = 1024
    s = rng.randn(5000) * 0.3
    p = _marks(rng, len(s), 120, 400)
    voi = rng.rand(len(p)) > 0.5
    sig, pm, nfrms, n_sig = _batch([s], [p], len(p))
    got = np.asarray(framing.pitch_sync_frames_batch(
        sig, pm, nfrms, n_sig, fft_len, win_family=W.VOI_NOISE,
        voiced=jnp.asarray(voi[None]), win_family_unvoiced=W.HANNING)[0])
    wins = [refport.voi_noise_window if v else np.hanning for v in voi]
    want = _ref_frames(s.astype(np.float32), p, fft_len, wins)
    np.testing.assert_allclose(got[0], want, atol=2e-6)


@pytest.mark.parametrize("fft_len", [1024, 2048, 4096])
def test_ola_centered_batch_matches_reference(fft_len):
    """Frame centre (index fft_len//2) lands on pm[f]; output trimmed to
    pm[-1] + last shift + 1 samples, as the reference's ola."""
    rng = np.random.RandomState(fft_len)
    pms = [_marks(rng, 8 * fft_len, fft_len // 8, fft_len // 3)
           for _ in range(2)]
    F = max(map(len, pms)) + 5
    frames = np.zeros((2, F, fft_len), np.float32)
    for b, p in enumerate(pms):
        frames[b, :len(p)] = rng.randn(len(p), fft_len)
    pm_b = np.zeros((2, F), np.int32)
    for b, p in enumerate(pms):
        pm_b[b, :len(p)] = p
    out_len_max = 10 * fft_len
    got = np.asarray(framing.ola_centered_batch(
        jnp.asarray(frames), jnp.asarray(pm_b),
        jnp.asarray([len(p) for p in pms], jnp.int32), out_len_max))
    for b, p in enumerate(pms):
        want = refport.ola(frames[b, :len(p)].astype(np.float64), p)
        np.testing.assert_allclose(got[b, :len(want)], want, atol=2e-5)


def test_apply_anti_ringing_matches_generic_centr_win():
    """The specialised anti-ringing pass (per-frame fill scalar instead
    of the generic per-element fill_bound re-evaluation) must be
    BITWISE identical to the generic windows.centr_win_value form it
    replaced (core/framing.py:apply_anti_ringing)."""
    rng = np.random.RandomState(5)
    F, fft_len = 24, 256
    frames = jnp.asarray(rng.randn(F, fft_len).astype(np.float32))
    shifts = jnp.asarray(rng.randint(20, 90, F).astype(np.int32))
    # include degenerate rows: zero shifts (padding) and tiny nfrms
    shifts = shifts.at[-2:].set(0)
    for nfrms in (F, F - 4, 1):
        got = framing.apply_anti_ringing(frames, shifts,
                                         jnp.int32(nfrms))
        wl, wr = framing.ar_winlens(shifts, jnp.int32(nfrms))
        win = W.centr_win_value(jnp.arange(fft_len)[None, :],
                                wl[:, None], wr[:, None], fft_len,
                                W.RAISED_HANNING, att=1.0,
                                fill_bound=True)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(frames * win))
