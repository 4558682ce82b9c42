"""Fbank phase-compression pipeline, type2 compressed analysis,
compute_imag_from_real, host fan-out, plotting."""
import os

import jax
import numpy as np
import pytest

WAV = "/root/reference/demos/data_48k/wavs_nat/hvd_593.wav"
PRED = "/root/reference/demos/data_48k/params_predicted"


@pytest.fixture(scope="module")
def short_epochs():
    """Synthetic epochs covering ~0.7 s of the demo wav."""
    rng = np.random.RandomState(1)
    shifts = rng.choice([200, 240, 250, 300, 320], size=120)
    pm = np.cumsum(shifts)
    voi = (rng.rand(120) > 0.3).astype(np.float64)
    return pm / 48000.0, voi


def test_format_phase_comp_and_synthesis_roundtrip(short_epochs):
    from magphase_jax.vocoder.phase_comp import (
        analysis_compressed_type1_with_phase_comp,
        synthesis_from_compressed_type1_with_phase_comp)
    pm_sec, voi = short_epochs
    mml, mrm, mim, v_lf0, v_shift, fs, fft_len = \
        analysis_compressed_type1_with_phase_comp(
            WAV, mag_dim=40, phase_dim=10, pm_sec=pm_sec, voi=voi)
    nfrms = len(pm_sec)
    assert mml.shape == (nfrms, 40)
    assert mrm.shape == (nfrms, 10)
    assert mim.shape == (nfrms, 10)
    assert v_lf0.shape == (nfrms,)
    assert np.all(np.isfinite(mml)) and np.all(np.isfinite(mrm))
    # phase streams are NOT clipped/zeroed in the phase_comp format
    # (magphase.py:2592-2593) but must stay physically bounded
    assert np.max(np.abs(mrm)) < 2.0

    v_syn = synthesis_from_compressed_type1_with_phase_comp(
        mml, mrm, mim, v_lf0, fs, key=jax.random.PRNGKey(3))
    assert np.all(np.isfinite(v_syn))
    assert np.std(v_syn) > 1e-5


def test_analysis_compressed_type2(short_epochs):
    from magphase_jax.vocoder.variants import analysis_compressed_type2
    pm_sec, voi = short_epochs
    out = analysis_compressed_type2(WAV, mag_dim=40, phase_dim=20,
                                    pm_sec=pm_sec, voi=voi)
    mml, mrm, mim, v_lf0, v_shift, fs, fft_len, v_lgain = out
    nfrms = len(pm_sec) - 1   # type2 drops the first frame (magphase.py:2816)
    assert mml.shape == (nfrms, 40)
    assert mrm.shape == (nfrms, 20)
    assert v_lgain.shape == (nfrms,)
    assert np.all(np.isfinite(mml))
    # voiced frames' gain is a max-abs, strictly positive
    assert np.all(v_lgain[np.asarray(voi[1:], bool)] > -1e9)


def test_analysis_compressed_type2_norm_mag(short_epochs):
    from magphase_jax.vocoder.variants import analysis_compressed_type2
    pm_sec, voi = short_epochs
    mml, _, _, _, _, _, _, v_lgain = analysis_compressed_type2(
        WAV, mag_dim=40, phase_dim=20, b_norm_mag=True,
        pm_sec=pm_sec, voi=voi)
    # coefficient 0 carries the per-frame mean (magphase.py:3177-3181)
    np.testing.assert_allclose(mml[:, 0], v_lgain, rtol=1e-12)
    assert np.abs(np.mean(mml[:, 1:], axis=1)).max() < 1e-8


def test_compute_imag_from_real_matches_reference_recursion():
    from magphase_jax.vocoder.variants import compute_imag_from_real
    rng = np.random.RandomState(7)
    v_real = np.clip(rng.randn(64) * 0.5, -0.99, 0.99)

    # direct port of magphase.py:3094-3120 as the oracle
    def oracle(start_sign, v_real):
        nbins = v_real.size
        v_imag = np.zeros(nbins)
        v_imag[1] = start_sign * np.sqrt(1.0 - v_real[1] ** 2)
        for nxb in range(2, nbins):
            prev_diff = v_imag[nxb - 1] - v_imag[nxb - 2]
            pos = np.sqrt(1.0 - v_real[nxb] ** 2)
            if abs(pos - v_imag[nxb - 1] - prev_diff) <= \
               abs(-pos - v_imag[nxb - 1] - prev_diff):
                v_imag[nxb] = pos
            else:
                v_imag[nxb] = -pos
        return v_imag

    got = compute_imag_from_real(-1.0, v_real)
    np.testing.assert_allclose(got, oracle(-1.0, v_real), atol=1e-5)


def test_run_multithreaded_broadcast_semantics():
    from magphase_jax.utils import run_multithreaded
    out = run_multithreaded(lambda a, b, c: a * b + c,
                            [1, 2, 3], 10, [100, 200, 300])
    assert out == [110, 220, 330]


def test_plotting_writes_files(tmp_path):
    from magphase_jax.utils.plotting import plotm, plot_pitch_marks
    m = np.random.RandomState(0).randn(30, 16)
    p1 = plotm(m, out_file=str(tmp_path / "m.png"))
    sig = np.sin(np.arange(4000) * 0.05)
    p2 = plot_pitch_marks(sig, np.arange(100, 3900, 250),
                          out_file=str(tmp_path / "pm.png"))
    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000
