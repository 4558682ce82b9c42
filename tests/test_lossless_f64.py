"""Float64 host lossless path: the bit-matching settlement (r3 VERDICT
item 8).  The dense vectorised float64 implementation in
vocoder/lossless_f64.py must be BIT-IDENTICAL to the faithful reference
port (tests/oracle/refport.py) — element-for-element equivalent math, so
equality is exact, not toleranced."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from oracle import refport  # noqa: E402

from magphase_jax.io import read_wav  # noqa: E402
from magphase_jax.vocoder.lossless_f64 import (  # noqa: E402
    analysis_lossless_f64, copy_synthesis_f64, synthesis_from_lossless_f64)

WAV = "/root/reference/demos/data_48k/wavs_nat/hvd_593.wav"


@pytest.fixture(scope="module")
def fixture_epochs():
    fix = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "epochs_48k.npz"))
    return fix["hvd_593_pm"], fix["hvd_593_voi"]


def test_analysis_bitwise_vs_oracle(fixture_epochs):
    pm_sec, voi = fixture_epochs
    sig, fs = read_wav(WAV)
    mag, real, imag, f0, shift = analysis_lossless_f64(sig, fs, pm_sec, voi)
    o_mag, o_real, o_imag, o_f0, _fs, o_shift = refport.analysis_lossless(
        sig, fs, pm_sec, voi)
    np.testing.assert_array_equal(shift, o_shift)
    np.testing.assert_array_equal(mag, o_mag)
    np.testing.assert_array_equal(real, o_real)
    np.testing.assert_array_equal(imag, o_imag)
    np.testing.assert_array_equal(f0, o_f0)


def test_synthesis_bitwise_vs_oracle(fixture_epochs):
    pm_sec, voi = fixture_epochs
    sig, fs = read_wav(WAV)
    mag, real, imag, f0, _ = analysis_lossless_f64(sig, fs, pm_sec, voi)
    syn = synthesis_from_lossless_f64(mag, real, imag, f0, fs)
    o_syn = refport.synthesis_from_lossless(mag, real, imag, f0, fs)
    np.testing.assert_array_equal(syn, o_syn)


def test_copy_synthesis_roundtrip_error(fixture_epochs):
    """The float64 round trip reconstructs the signal essentially exactly
    (errors are pure float64 FFT rounding, ~1e-13 of peak — versus the
    f32 production gate of p99 < 2^-16)."""
    pm_sec, voi = fixture_epochs
    sig, fs = read_wav(WAV)
    syn = copy_synthesis_f64(sig, fs, pm_sec, voi)
    n = min(len(sig), len(syn))
    err = np.abs(syn[2000:n - 2000] - sig[2000:n - 2000])
    assert float(err.max()) < 1e-11
