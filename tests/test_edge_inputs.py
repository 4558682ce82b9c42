"""Degenerate inputs through the production batched analysis path: the
reference's only fault tolerance is crash lists (SURVEY.md §5); here the
pipelines must return finite, well-formed output for silence, noise, DC
and near-empty signals rather than raise."""
import numpy as np

from magphase_jax.parallel.analysis_batch import analysis_compressed_batch

FS = 48000


def _check(sig):
    out = analysis_compressed_batch([np.asarray(sig, np.float64)], FS)
    mml, mrm, mim, lf0, sh = out[0]
    assert np.all(np.isfinite(mml)) and np.all(np.isfinite(mrm))
    assert len(mml) == len(lf0)
    assert np.all(sh > 0)
    return lf0, sh


def test_silence_is_all_unvoiced():
    lf0, sh = _check(np.zeros(FS))
    assert np.all(lf0 < -1e9 + 1)          # MAGIC everywhere
    assert len(sh) > 150                   # 5 ms unvoiced stepping


def test_white_noise_mostly_unvoiced():
    lf0, _ = _check(np.random.RandomState(0).randn(FS) * 0.1)
    assert (lf0 > -1e9).mean() < 0.2


def test_dc_offset_handled():
    _check(np.full(FS, 0.5))


def test_degenerate_short_signal_no_crash():
    # 6 ms of noise: too short for any pitch period — zero or a couple of
    # frames, but never an exception or non-finite output
    out = analysis_compressed_batch(
        [np.random.RandomState(1).randn(300) * 0.1], FS)
    mml, mrm, mim, lf0, sh = out[0]
    assert len(mml) == len(lf0) == len(sh) or len(sh) >= len(mml)
    assert np.all(np.isfinite(mml))


def test_mixed_batch_with_degenerate_member():
    sigs = [np.zeros(FS),
            np.sin(2 * np.pi * 150 * np.arange(FS) / FS) * 0.5,
            np.random.RandomState(2).randn(400) * 0.05]
    out = analysis_compressed_batch(sigs, FS)
    assert len(out) == 3
    voiced_tone = (out[1][3] > -1e9).mean()
    assert voiced_tone > 0.8               # the tone stays voiced
    assert np.all(np.isfinite(out[1][0]))
