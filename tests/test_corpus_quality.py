"""Corpus-level quality gate over ALL 10 demo utterances.

The reference's de-facto acceptance test is "run the demos and listen"
(README.md:57-66).  This gate makes it mechanical, for the whole demo
corpus rather than one utterance:

* lossless copy synthesis (tracker -> analysis_lossless ->
  synthesis_from_lossless, magphase.py:2869-2906 + 1759-1776) must
  reconstruct every utterance to sub-PCM16 accuracy;
* the full compressed loop (tracker -> analysis_compressed ->
  synthesis_from_compressed, magphase.py:2947-2988 + 825-997) must keep
  the mean aligned mel-spectral distortion below a recorded threshold —
  a voicing/tracker regression on ANY demo utterance turns this red.
"""
import glob

import numpy as np
import jax
import pytest

from magphase_jax.io import read_wav

DATA = "/root/reference/demos/data_48k/wavs_nat"
FS = 48000

# GATING METRIC: the drift-robust piecewise MSD (r3 VERDICT item 7).
# The globally-aligned MSD swings several dB under the lf0-medfilt
# pitch-mark drift AND under the noise key alone (measured per-utterance
# spread across 3 keys: 4.7 dB global vs 0.62 dB piecewise after the
# normalised-alignment + trimmed-mean upgrade — utils/eval.py docstring),
# so its gates needed wide margins.  Recorded piecewise values (CPU,
# PRNGKey(0), floor_db=40, round 4): per-utt 5.58..8.93 dB, mean 6.998 —
# identical for the live tracker and the recorded-epochs fixture
# (tests/data/epochs_48k.npz).  Gates sit at recorded + ~0.4/0.55 dB
# (max key spread 0.62 included) and are DECOMPOSED: the fixture gate
# moves only with mel-compression/synthesis changes; the live gate also
# moves with tracker changes — a tracker regression flips exactly one.
MSD_MEAN_MAX = 7.4
MSD_UTT_MAX = 9.5
# r5 two-phase snap window (tracker.py SNAP_*): live-tracker corpus mean
# improved 6.998 -> 6.46 (per-utt 4.69..8.72); live gates re-recorded at
# + ~0.6 margin and TIGHTENED below the r4 values
MSD_MEAN_MAX_LIVE = 7.1
MSD_UTT_MAX_LIVE = 9.4
# catastrophic-artifact catch: trimming makes the primary score blind to
# defects confined to <20% of the audio, so the UNTRIMMED worst chunk is
# gated too (a single broken chunk reads 40+).  Recorded: 16.88 (r4);
# r5 placement moved hvd_592's worst chunk to 22.2 at PRNGKey(0) — a
# mostly-unvoiced drift region whose chunk ALIGNMENT is key-fragile
# (15.3/21.0/22.2 across three keys; 12.9 for the same audio scored
# singleton), while the utterance's trimmed mean improved to 6.29
MSD_WORST_CHUNK_MAX = 26.0

EPOCH_FIXTURE = "tests/data/epochs_48k.npz"


@pytest.fixture(scope="module")
def corpus():
    wavs = sorted(glob.glob(f"{DATA}/*.wav"))
    assert len(wavs) == 10
    return [w.rsplit("/", 1)[1][:-4] for w in wavs], \
        [read_wav(w)[0] for w in wavs]


def test_lossless_copy_synthesis_whole_corpus(corpus):
    from magphase_jax.parallel.copy_synthesis import copy_synthesis_batch
    toks, sigs = corpus
    outs = copy_synthesis_batch(sigs, FS)
    for tok, sig, syn in zip(toks, sigs, outs):
        n = min(len(sig), len(syn))
        err = np.abs(syn[2000:n - 2000] - sig[2000:n - 2000])
        # recorded corpus values: p99 <= 1.8e-7, max <= 8e-7 — well below
        # one PCM16 step (2^-15); gate at half a step
        assert np.percentile(err, 99) < 2.0 ** -16, \
            f"{tok}: p99 err {np.percentile(err, 99):.2e}"


def _corpus_msd(toks, sigs, epochs=None):
    from magphase_jax.parallel.analysis_batch import \
        analysis_compressed_batch
    from magphase_jax.parallel.batch import synthesis_from_compressed_batch
    from magphase_jax.utils.eval import mel_spectral_distortion_piecewise

    feats = analysis_compressed_batch(sigs, FS, epochs=epochs)
    utts = [(m, r, i, l) for (m, r, i, l, _s) in feats]
    outs = synthesis_from_compressed_batch(utts, FS,
                                           key=jax.random.PRNGKey(0))
    out = {}
    for tok, sig, syn in zip(toks, sigs, outs):
        mean, worst = mel_spectral_distortion_piecewise(
            sig, np.asarray(syn), FS, floor_db=40.0, return_worst=True)
        assert worst < MSD_WORST_CHUNK_MAX, (tok, mean, worst)
        out[tok] = mean
    return out


def test_compressed_loop_msd_fixed_epochs(corpus):
    """Mel-compression + synthesis error in ISOLATION: epochs come from
    the recorded fixture, so tracker changes cannot move this gate."""
    import os
    toks, sigs = corpus
    fix = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "epochs_48k.npz"))
    epochs = [(fix[f"{t}_pm"], fix[f"{t}_voi"]) for t in toks]
    msds = _corpus_msd(toks, sigs, epochs=epochs)
    mean = float(np.mean(list(msds.values())))
    assert mean < MSD_MEAN_MAX, msds
    bad = {t: m for t, m in msds.items() if m >= MSD_UTT_MAX}
    assert not bad, f"per-utterance MSD over {MSD_UTT_MAX} dB: {bad}"


def test_compressed_loop_msd_whole_corpus(corpus):
    """Full LIVE loop (tracker in the loop): a tracker regression of
    >= ~0.3 dB mean or any badly-tracked utterance turns this red while
    the fixed-epochs gate above stays green."""
    toks, sigs = corpus
    msds = _corpus_msd(toks, sigs)
    mean = float(np.mean(list(msds.values())))
    assert mean < MSD_MEAN_MAX_LIVE, msds
    bad = {t: m for t, m in msds.items() if m >= MSD_UTT_MAX_LIVE}
    assert not bad, f"per-utterance MSD over {MSD_UTT_MAX_LIVE} dB: {bad}"
