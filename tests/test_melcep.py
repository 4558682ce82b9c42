"""Mel-cepstrum machinery: freqt correctness, warp/unwarp round trip."""
import numpy as np
import jax.numpy as jnp

from magphase_jax.core import melcep


def test_freqt_matrix_transform_identity_at_alpha0():
    F = melcep.freqt_matrix_np(10, 10, 0.0)
    np.testing.assert_allclose(F, np.eye(11), atol=1e-12)


def test_freqt_preserves_function_under_warp():
    """freqt(c) evaluated on the warped cosine basis must equal c evaluated
    on the linear cosine basis — the defining property of the frequency
    transform (SPTK freqt / Oppenheim recursion)."""
    alpha = 0.42
    m1, m2, nbins = 24, 120, 257
    rng = np.random.RandomState(1)
    c = (rng.randn(3, m1 + 1) * 0.5 ** np.arange(m1 + 1)).astype(np.float64)

    # evaluate original on linear grid
    lin = np.asarray(melcep.mcep_to_sp_cosmat(
        jnp.asarray(c), nbins, alpha=0.0, out_type="log"))
    # transform, then evaluate on the warped grid
    g = np.asarray(melcep.freqt(jnp.asarray(c), m2, alpha))
    warped = np.asarray(melcep.mcep_to_sp_cosmat(
        jnp.asarray(g), nbins, alpha=alpha, out_type="log"))
    np.testing.assert_allclose(warped, lin, atol=1e-4)


def test_freqt_inverse_roundtrip():
    """freqt(alpha) then freqt(-alpha) recovers the original coefficients
    (for sufficiently high intermediate order)."""
    alpha = 0.77
    rng = np.random.RandomState(2)
    c = rng.randn(2, 20) * 0.6 ** np.arange(20)
    g = melcep.freqt(jnp.asarray(c), 200, alpha)
    back = np.asarray(melcep.freqt(g, 19, -alpha))
    np.testing.assert_allclose(back, c, atol=1e-5)


def test_sp_to_mcep_reproduces_smooth_spectrum():
    """For a spectrum that IS a low-order mel-cepstral expansion, the
    zero-iteration mcep estimate must recover it (up to truncation)."""
    alpha, order, h = 0.77, 30, 2049
    rng = np.random.RandomState(3)
    mc_true = rng.randn(2, order) * 0.5 ** np.arange(order)
    m_sp = np.asarray(melcep.mcep_to_sp_cosmat(
        jnp.asarray(mc_true), h, alpha=alpha, out_type="abs"))

    mc_est = np.asarray(melcep.sp_to_mcep(
        jnp.asarray(m_sp, jnp.float64), n_coeffs=order, alpha=alpha,
        in_type=3))
    np.testing.assert_allclose(mc_est, mc_true, atol=2e-3)


def test_mel_warp_unwarp_roundtrip():
    """sp_mel_warp -> sp_mel_unwarp approximates identity for smooth
    spectra (the property the compressed vocoder path relies on,
    libaudio.py:643-684)."""
    alpha, h, nmel = 0.77, 2049, 60
    rng = np.random.RandomState(4)
    mc = rng.randn(2, 40) * 0.6 ** np.arange(40)
    m_sp_log = np.asarray(melcep.mcep_to_sp_cosmat(
        jnp.asarray(mc), h, alpha=0.6, out_type="log"))

    m_mel = melcep.sp_mel_warp(jnp.asarray(m_sp_log, jnp.float64), nmel,
                               alpha=alpha, in_type=2)
    m_rec = np.asarray(melcep.sp_mel_unwarp(m_mel, h, alpha=alpha,
                                            in_type="log"))
    err = np.abs(m_rec - m_sp_log)
    assert np.mean(err) < 0.05, f"mean log err {np.mean(err):.3f}"
    assert np.max(err) < 0.5, f"max log err {np.max(err):.3f}"


def test_mc2b_b2mc_roundtrip():
    rng = np.random.RandomState(5)
    mc = jnp.asarray(rng.randn(3, 60))
    b = melcep.mc2b(mc, 0.77)
    back = np.asarray(melcep.b2mc(b, 0.77))
    np.testing.assert_allclose(back, np.asarray(mc), atol=1e-5)


def test_mc2b_matches_recursion():
    rng = np.random.RandomState(6)
    mc = rng.randn(60)
    alpha = 0.77
    b_ref = np.zeros(60)
    b_ref[-1] = mc[-1]
    for m in range(58, -1, -1):
        b_ref[m] = mc[m] - alpha * b_ref[m + 1]
    got = np.asarray(melcep.mc2b(jnp.asarray(mc[None, :]), alpha))[0]
    np.testing.assert_allclose(got, b_ref, atol=1e-6)


def test_c2acr_r0_power():
    """r0 of a flat spectrum: c=0 -> P=1 everywhere -> r0=1."""
    c = jnp.zeros((2, 10))
    r0 = np.asarray(melcep.c2acr_r0(c, 256))
    np.testing.assert_allclose(r0, 1.0, atol=1e-6)
