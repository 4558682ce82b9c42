"""IIR filter kernels vs scipy oracles."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy import signal as sp

from magphase_jax.core.filters import (butter_highpass_sos,
                                       ellip_highpass_coeffs, lfilter,
                                       medfilt3, sosfilt)


def test_sosfilt_hpf_float32_stable_and_accurate():
    """Regression: the 40 Hz/48 kHz high-pass overflowed float32 when
    sosfilt used associative-scan prefix products (poles at r~0.996);
    the FIR-convolution form must match scipy to well below PCM16 LSB."""
    sos = butter_highpass_sos(4, 40.0, 48000)
    x = (np.random.RandomState(0).randn(1 << 17) * 0.1).astype(np.float32)
    y = np.asarray(sosfilt(sos, jnp.asarray(x)))
    ref = sp.sosfilt(np.asarray(sos, np.float64), x.astype(np.float64))
    assert np.all(np.isfinite(y))
    assert np.max(np.abs(y - ref)) < 1e-5


def test_sosfilt_both_conv_forms_match_scipy():
    """sosfilt picks whole-signal vs overlap-save blocked FFT by point
    count; both branches must match the scipy oracle."""
    sos = butter_highpass_sos(4, 40.0, 48000)
    rng = np.random.RandomState(3)
    # n chosen so n+m lands just under a power of two (whole-signal
    # branch) and well over one (blocked branch)
    for n in (122880, 140000, 5000):
        x = (rng.randn(n) * 0.1).astype(np.float32)
        y = np.asarray(sosfilt(sos, jnp.asarray(x)))
        ref = sp.sosfilt(np.asarray(sos, np.float64), x.astype(np.float64))
        assert np.max(np.abs(y - ref)) < 1e-5, n


def test_lfilter_low_order_matches_scipy():
    b, a = sp.butter(2, 0.2)
    x = np.random.RandomState(1).randn(4096).astype(np.float32)
    y = np.asarray(lfilter(tuple(b), tuple(a), jnp.asarray(x)))
    ref = sp.lfilter(b, a, x.astype(np.float64))
    assert np.max(np.abs(y - ref)) < 1e-4


@pytest.mark.parametrize("design", ["butter2_lp", "butter1_bp", "ellip2_hp",
                                    "pre_emphasis", "one_pole"])
def test_lfilter_matches_scipy_lfilter(design):
    """The associative-scan IIR (core/filters.py:lfilter, state maps
    composed at precision HIGHEST) vs scipy.signal.lfilter in float64."""
    b, a = {"butter2_lp": lambda: sp.butter(2, 0.2),
            "butter1_bp": lambda: sp.butter(1, [0.1, 0.3], btype="band"),
            "ellip2_hp": lambda: ellip_highpass_coeffs(2, 0.5, 40.0, 700.0,
                                                       16000),
            "pre_emphasis": lambda: ([1.0, -0.97], [1.0]),
            "one_pole": lambda: ([0.05], [1.0, -0.95])}[design]()
    x = np.random.RandomState(4).randn(8192).astype(np.float32)
    y = np.asarray(lfilter(tuple(b), tuple(a), jnp.asarray(x)))
    ref = sp.lfilter(b, a, x.astype(np.float64))
    assert np.max(np.abs(y - ref)) < 1e-4 * max(1.0, np.max(np.abs(ref)))


def test_medfilt3_matches_scipy():
    x = np.random.RandomState(2).randn(501)
    got = np.asarray(medfilt3(jnp.asarray(x)))
    np.testing.assert_allclose(got, sp.medfilt(x), atol=1e-12)


def test_sos_freq_response_rfft_matches_freqz():
    """The spectral-HPF gain table (vocoder spectral mode) is the exact
    steady-state response: matches scipy freqz of the (b, a) form at
    every rfft bin; DC is fully rejected; Nyquist response is real (the
    hermitian irfft assumes real DC/Nyquist bins)."""
    from scipy import signal as sp_signal
    from magphase_jax.core.filters import (butter_highpass_coeffs,
                                           butter_highpass_sos,
                                           sos_freq_response_rfft)
    sos = butter_highpass_sos(4, 40.0, 48000)
    hre, him = sos_freq_response_rfft(sos, 2048)
    assert hre.shape == (1025,) and hre.dtype == np.float32
    b, a = butter_highpass_coeffs(4, 40.0, 48000)
    w = 2.0 * np.pi * np.arange(1025) / 2048.0
    _, H = sp_signal.freqz(np.asarray(b), np.asarray(a), worN=w)
    np.testing.assert_allclose(hre + 1j * him, H, atol=1e-5)
    assert abs(hre[0]) < 1e-6 and abs(him[0]) < 1e-6
    assert abs(him[-1]) < 1e-6
