"""Utility DSP surface: oracles against direct reference-formula ports."""
import numpy as np
import jax.numpy as jnp

from magphase_jax.core import misc_dsp as M
from magphase_jax.core import spectral as S
from magphase_jax.core import fbank


def test_interp_unv_regions_linear():
    v_voi = np.array([0, 0, 1, 0, 0, 1, 1, 0], float)
    m = np.arange(8, dtype=float)[:, None] * 10
    got = np.asarray(M.interp_unv_regions(jnp.asarray(m), jnp.asarray(v_voi)))
    # voiced rows kept
    np.testing.assert_allclose(got[[2, 5, 6], 0], [20, 50, 60])
    # gap rows 3,4 linearly interpolated between rows 2 and 5
    np.testing.assert_allclose(got[3, 0], 30, atol=1e-5)
    np.testing.assert_allclose(got[4, 0], 40, atol=1e-5)
    # edges clamp to nearest voiced
    np.testing.assert_allclose(got[0, 0], 20, atol=1e-5)
    np.testing.assert_allclose(got[7, 0], 60, atol=1e-5)


def test_smooth_by_conv_matches_numpy():
    rng = np.random.RandomState(0)
    v = rng.randn(50)
    win = np.hanning(11)
    half = 5
    ext = np.r_[np.full(half, v[0]), v, np.full(half, v[-1])]
    oracle = np.convolve(win / win.sum(), ext, mode="valid")
    got = np.asarray(M.smooth_by_conv(jnp.asarray(v), win))
    np.testing.assert_allclose(got, oracle, atol=1e-5)


def test_ph_enc_dec_roundtrip():
    ph = np.linspace(-np.pi + 0.01, np.pi - 0.01, 50)
    s, c = M.ph_enc(jnp.asarray(ph))
    back = np.asarray(M.ph_dec(s, c, mode="angle"))
    np.testing.assert_allclose(back, ph, atol=1e-5)


def test_windowing_const_rate_shapes():
    sig = jnp.asarray(np.random.RandomState(1).randn(1000), jnp.float32)
    frames = M.windowing_const_rate(sig, 100, 40)
    assert frames.shape == (int(np.floor(1 + (1000 - 100) / 40.0)), 100)


def test_spectral_crossfade_matches_reference():
    """spectral_crossfade as win_l/1-win_l vs the reference's two-window
    formulation (libaudio.py:160-186)."""
    h = 2049
    fs = 48000
    rng = np.random.RandomState(2)
    A = rng.rand(3, h)
    B = rng.rand(3, h)
    got = np.asarray(S.spectral_crossfade(jnp.asarray(A), jnp.asarray(B),
                                          5000, 2000, fs))
    # oracle
    fft_len = (h - 1) * 2
    bin_l = int(np.round((5000 - 1000) * fft_len / fs))
    bin_r = int(np.round((5000 + 1000) * fft_len / fs))
    bw = bin_r - bin_l
    v_win = np.hanning(2 * bw + 1)
    win_l = np.concatenate([np.ones(bin_l), v_win[bw:],
                            np.zeros(h - bin_r - 1)])
    win_r = np.concatenate([np.zeros(bin_l), v_win[:bw + 1],
                            np.ones(h - bin_r - 1)])
    oracle = A * win_l + B * win_r
    np.testing.assert_allclose(got, oracle, atol=1e-5)


def test_min_phase_is_min_phase():
    """Minimum-phase spectrum has the input magnitude and causal cepstrum."""
    rng = np.random.RandomState(3)
    from magphase_jax.core import melcep
    mc = rng.randn(2, 20) * 0.5 ** np.arange(20)
    m_mag = np.asarray(melcep.mcep_to_sp_cosmat(jnp.asarray(mc), 257,
                                                alpha=0.0, out_type="abs"))
    cm = np.asarray(S.build_min_phase_from_mag_spec(jnp.asarray(m_mag)))
    np.testing.assert_allclose(np.abs(cm), m_mag, rtol=2e-3)


def test_fbank_warp_unwarp_smooth_roundtrip():
    from magphase_jax.core import melcep
    rng = np.random.RandomState(4)
    mc = rng.randn(2, 15) * 0.5 ** np.arange(15)
    m_log = np.asarray(melcep.mcep_to_sp_cosmat(jnp.asarray(mc), 2049,
                                                alpha=0.5, out_type="log"))
    m_mag = np.exp(m_log)
    mel = fbank.sp_mel_warp_fbank(jnp.asarray(m_mag), 60, alpha=0.77)
    rec = np.asarray(fbank.sp_mel_unwarp_fbank(
        jnp.log(mel), 2049, alpha=0.77))
    err = np.abs(rec - m_log)
    assert np.median(err) < 0.05
    assert np.max(err) < 1.0


def test_get_ap_mask_shape():
    m = np.asarray(M.get_ap_mask_from_uv_decision(
        np.array([1.0, 0.0]), 4096, 48000, 4500.0))
    assert m.shape == (2, 2049)
    assert m[0, 0] == 0.0 and m[1, 0] == 1.0
    assert np.all(m[:, -1] == 1.0)


def test_sp_mel_warp_fbank_2d_matches_numpy_oracle():
    """Numpy re-statement of libaudio.py:771-813: fbank warp of the log
    magnitude, then per-band hanning(span+2) smoothing along frames with
    boundary extension (smooth_by_conv, libaudio.py:878-918)."""
    from scipy import interpolate
    from magphase_jax.core import melcep
    from magphase_jax.core.spectral import mel_curve_np

    rng = np.random.RandomState(5)
    mc = rng.randn(30, 15) * 0.5 ** np.arange(15)
    m_mag = np.exp(np.asarray(melcep.mcep_to_sp_cosmat(
        jnp.asarray(mc), 513, alpha=0.5, out_type="log")))
    nbands = 24

    got = np.asarray(fbank.sp_mel_warp_fbank_2d(
        jnp.asarray(m_mag), nbands, alpha=0.77))

    # oracle
    nbins = m_mag.shape[1]
    curve = mel_curve_np(0.77, nbins)
    cntrs_mel = np.linspace(0, curve[-1], nbands)
    f = interpolate.interp1d(curve, np.arange(nbins), kind="quadratic")
    cntrs = np.round(f(cntrs_mel)).astype(int)
    B = np.zeros((nbins, nbands))
    ext = np.r_[cntrs[0], cntrs, cntrs[-1]]
    from magphase_jax.core.windows import gen_non_symmetric_win_np
    for b in range(1, nbands + 1):
        w = gen_non_symmetric_win_np(ext[b] - ext[b - 1],
                                     ext[b + 1] - ext[b],
                                     np.hanning, b_norm=True)
        B[ext[b - 1]:ext[b - 1] + len(w), b - 1] = w
    m_log_mel = np.log(m_mag) @ B

    max_span = 5
    spans = 1 + mel_curve_np(-0.3, nbands, amp=max_span - 1.0)
    spans = (2 * np.ceil(spans / 2.0) - 1).astype(int)
    want = np.zeros_like(m_log_mel)
    n = m_log_mel.shape[0]
    for b in range(nbands):
        w = np.hanning(spans[b] + 2)
        half = (len(w) - 1) // 2
        col = m_log_mel[:, b]
        col_ext = np.r_[np.full(half, col[0]), col, np.full(half, col[-1])]
        want[:, b] = np.convolve(w / w.sum(), col_ext, mode="valid")
    want = np.exp(want)

    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert len(np.unique(spans)) >= 2   # the smoothing really varies
