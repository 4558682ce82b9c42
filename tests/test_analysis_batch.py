"""Batched analysis vs single-utterance path."""
import numpy as np

from magphase_jax.io import read_wav
from magphase_jax.parallel.analysis_batch import (analysis_compressed_batch,
                                                  analysis_lossless_batch,
                                                  track_f0_batch)
from magphase_jax.epochs.tracker import track_f0

DATA = "/root/reference/demos/data_48k/wavs_nat"


def _load(tok):
    return read_wav(f"{DATA}/{tok}.wav")[0]


def test_track_batch_matches_single():
    sigs = [_load("hvd_593"), _load("hvd_594")]
    batch = track_f0_batch(sigs, 48000)
    for sig, (f0_b, voi_b, _) in zip(sigs, batch):
        f0_s, voi_s, _, _ = track_f0(sig, 48000)
        assert len(f0_b) == len(f0_s)
        agree = np.mean(voi_b == voi_s)
        assert agree > 0.97, f"voicing agreement {agree}"
        sel = voi_b & voi_s & (f0_s > 0)
        rel = np.abs(f0_b[sel] - f0_s[sel]) / f0_s[sel]
        assert np.median(rel) < 0.01


def test_lossless_batch_shapes_and_roundtrip():
    sigs = [_load("hvd_593"), _load("hvd_594")]
    feats = analysis_lossless_batch(sigs, 48000)
    assert len(feats) == 2
    for sig, (mag, real, imag, f0, sh) in zip(sigs, feats):
        assert mag.shape[1] == 2049
        assert mag.shape[0] == len(f0) == len(sh)
        # round-trip reconstruction via the single synthesis path
        from magphase_jax.vocoder import synthesis_from_lossless
        syn = synthesis_from_lossless(mag.astype(np.float64),
                                      real.astype(np.float64),
                                      imag.astype(np.float64), f0, 48000)
        n = min(len(syn), len(sig))
        err = np.abs(syn[2000:n - 2000] - sig[2000:n - 2000])
        assert np.percentile(err, 99) < 2 ** -13


def test_lossless_batch_compact_transport_gate():
    """'compact' transport (f32 mag + int16 phase angle over the link,
    half the download bytes) must stay inside the sub-PCM16
    copy-synthesis budget AND match the exact transport closely
    (r3 VERDICT item 4).  Measured: p99 1.1e-5, max 2.1e-5 vs the
    2^-15 = 3.05e-5 PCM16 step."""
    from magphase_jax.vocoder import synthesis_from_lossless

    sig = _load("hvd_593")
    (mag_c, real_c, imag_c, f0_c, sh_c), = analysis_lossless_batch(
        [sig], 48000, transport="compact")
    (mag_f, real_f, imag_f, f0_f, sh_f), = analysis_lossless_batch(
        [sig], 48000)
    np.testing.assert_array_equal(sh_c, sh_f)
    np.testing.assert_array_equal(mag_c, mag_f)       # mag stays f32
    # int16 angle: phasor reconstructs to ~1e-4
    assert np.max(np.abs(real_c - real_f)) < 3e-4
    assert np.max(np.abs(imag_c - imag_f)) < 3e-4
    # unit-phasor property survives the encoding
    norm = real_c.astype(np.float64) ** 2 + imag_c.astype(np.float64) ** 2
    nz = mag_c > 0
    assert np.max(np.abs(norm[nz] - 1.0)) < 1e-6

    syn = synthesis_from_lossless(mag_c.astype(np.float64),
                                  real_c.astype(np.float64),
                                  imag_c.astype(np.float64), f0_c, 48000)
    n = min(len(syn), len(sig))
    err = np.abs(syn[2000:n - 2000] - sig[2000:n - 2000])
    assert float(np.percentile(err, 99)) < 2.0 ** -15
    assert float(err.max()) < 2.0 ** -14


def test_compressed_batch_uint8_feat_transport():
    """np.uint8 feat_dtype: device-side affine int8 download must match
    the f32 features to the per-coefficient quantisation bound
    (range/510), with lf0/shift untouched."""
    from magphase_jax.parallel.analysis_batch import \
        analysis_compressed_batch_async

    sig = _load("hvd_593")
    (m8, r8, i8, l8, s8), = analysis_compressed_batch_async(
        [sig], 48000, feat_dtype=np.uint8)()
    (mf, rf, if_, lf, sf), = analysis_compressed_batch_async(
        [sig], 48000, feat_dtype=np.float32)()
    np.testing.assert_array_equal(s8, sf)
    np.testing.assert_array_equal(l8, lf)
    for a, b in ((m8, mf), (r8, rf), (i8, if_)):
        rng = np.maximum(b.max(axis=0) - b.min(axis=0), 1e-9)
        assert np.max(np.abs(a - b) / rng[None, :]) < 1.0 / 250.0


def test_compressed_batch_output_dims():
    sigs = [_load("hvd_593")]
    out = analysis_compressed_batch(sigs, 48000, mag_dim=60, phase_dim=45)
    mml, mrm, mim, lf0, sh = out[0]
    assert mml.shape[1] == 60 and mrm.shape[1] == 45
    assert np.all(np.abs(mrm) <= 1.0)
    voiced = lf0 > -1e9
    assert 0.1 < voiced.mean() < 0.9


def test_compressed_batch_const_rate_matches_single():
    """Batched const-rate (device regrid) vs the per-utterance oracle
    (analysis_compressed b_const_rate=True) with identical epochs."""
    from magphase_jax.epochs.tracker import extract_epochs
    from magphase_jax.vocoder.compressed import analysis_compressed

    tok = "hvd_593"
    sig = _load(tok)
    fs = 48000
    pm_sec, voi = extract_epochs(sig, fs)

    ref = analysis_compressed(f"{DATA}/{tok}.wav", mag_dim=60, phase_dim=45,
                              b_const_rate=True, pm_sec=pm_sec, voi=voi)
    mml_r, mrm_r, mim_r, lf0_r, sh_r = ref[:5]

    out = analysis_compressed_batch([sig], fs, mag_dim=60, phase_dim=45,
                                    b_const_rate=True,
                                    epochs=[(pm_sec, voi)])
    mml_b, mrm_b, mim_b, lf0_b, sh_b = out[0]

    assert mml_b.shape == mml_r.shape
    assert mrm_b.shape == mrm_r.shape
    assert np.median(np.abs(mml_b - mml_r)) < 1e-4
    assert np.percentile(np.abs(mml_b - mml_r), 99) < 2e-2
    assert np.percentile(np.abs(mrm_b - mrm_r), 99) < 2e-2
    # voicing decisions on the 5 ms grid must agree
    assert np.mean((lf0_b > -1e9) == (lf0_r > -1e9)) > 0.99
    # lf0 values (incl. the final frame, where medfilt sees the padding
    # neighbour) must match the host oracle
    m = (lf0_b > -1e9) & (lf0_r > -1e9)
    assert np.max(np.abs(lf0_b[m] - lf0_r[m])) < 2e-3
    # the shift track stays variable-rate
    assert len(sh_b) == len(sh_r)
    assert np.array_equal(sh_b, np.asarray(sh_r, np.int64))


def test_batched_16k_walk_covers_full_signal():
    """The device mark walk's capacity must be time-based: at 16 kHz the
    old samples-based heuristic truncated every utterance at ~58%."""
    fs = 16000
    t = np.arange(int(2.0 * fs)) / fs
    sig = 0.4 * np.sign(np.sin(2 * np.pi * 220 * t)) * \
        (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    out = analysis_compressed_batch([sig], fs)
    _, _, _, _, sh = out[0]
    coverage = float(np.cumsum(sh)[-1]) / len(sig)
    assert coverage > 0.95, f"walk covered only {coverage:.2f} of signal"


def test_batched_high_pitch_no_truncation():
    """Sustained voicing near the tracker F0 ceiling must not exhaust the
    mark capacity (or, pathologically, must trigger the host fallback)."""
    fs = 48000
    t = np.arange(int(1.5 * fs)) / fs
    sig = 0.4 * np.sign(np.sin(2 * np.pi * 390 * t))
    out = analysis_compressed_batch([sig], fs)
    _, _, _, lf0, sh = out[0]
    coverage = float(np.cumsum(sh)[-1]) / len(sig)
    assert coverage > 0.95, f"walk covered only {coverage:.2f} of signal"
    # pitch recovered near 390 Hz in voiced frames
    f0 = np.exp(lf0[lf0 > -1e9])
    assert abs(np.median(f0) - 390) < 25


def test_hbm_budget_splits_long_utterance_batches():
    """A 32 s utterance must not be padded to a batch of 8 (HBM), and a
    list of them must split into sub-batches under the budget."""
    from magphase_jax.parallel.analysis_batch import (_budget_geometry,
                                                      _split_for_budget)
    from magphase_jax.utils.padding import max_frame_elems

    fs, fft_len = 48000, 4096
    long = np.zeros(32 * fs)
    S, m_max, max_b = _budget_geometry([long], fs, fft_len)
    assert S >= len(long)
    assert max_b * m_max * fft_len <= max_frame_elems()
    assert 1 <= max_b < 8

    groups = _split_for_budget([long] * 10, fs, fft_len)
    assert sum(len(g) for g in groups) == 10
    assert all(len(g) <= max_b for g in groups)
    # short utterances keep the single-group fast path
    assert len(_split_for_budget([np.zeros(fs * 2)] * 8, fs, fft_len)) == 1


def test_compressed_batch_const_rate_tracker_path():
    """The production `extract --const-rate` path: tracker epochs (device
    walk, sample-exact vs host) + device const-rate regrid must match the
    per-utterance oracle that uses host-extracted epochs."""
    from magphase_jax.epochs.tracker import extract_epochs
    from magphase_jax.vocoder.compressed import analysis_compressed

    tok = "hvd_594"
    sig = _load(tok)
    fs = 48000
    # feat_dtype=float32: pin the device pipeline's numerics exactly; the
    # float16 default is only a host-link transfer encoding, asserted at
    # its quantisation bound below
    out = analysis_compressed_batch([sig], fs, mag_dim=60, phase_dim=45,
                                    b_const_rate=True,
                                    feat_dtype=np.float32)  # tracker path
    mml_b, mrm_b, mim_b, lf0_b, sh_b = out[0]

    pm_sec, voi = extract_epochs(sig, fs)
    ref = analysis_compressed(f"{DATA}/{tok}.wav", mag_dim=60, phase_dim=45,
                              b_const_rate=True, pm_sec=pm_sec, voi=voi)
    mml_r, mrm_r, mim_r, lf0_r, sh_r = ref[:5]

    assert mml_b.shape == mml_r.shape
    assert np.array_equal(sh_b, np.asarray(sh_r, np.int64))
    assert np.median(np.abs(mml_b - mml_r)) < 1e-4
    m = (lf0_b > -1e9) & (lf0_r > -1e9)
    assert np.max(np.abs(lf0_b[m] - lf0_r[m])) < 2e-3

    # the default (float16 downloads) must agree to quantisation level:
    # one f16 ulp at |mml|<=16 is 2^-7, phase streams are in [-1, 1]
    out16 = analysis_compressed_batch([sig], fs, mag_dim=60, phase_dim=45,
                                      b_const_rate=True)
    mml_h, mrm_h, mim_h, lf0_h, sh_h = out16[0]
    assert np.max(np.abs(mml_h - mml_b)) < 2.0 ** -7
    assert np.max(np.abs(mrm_h - mrm_b)) < 2.0 ** -10
    assert np.array_equal(lf0_h, lf0_b)
    assert np.array_equal(sh_h, sh_b)


def test_lossless_batch_compact_silence_convention():
    """Digitally-silent frames (mag == 0): the exact transport stores
    (real, imag) = (0, 0); the int16-angle decode must reproduce that
    convention instead of (cos 0, sin 0) = (1, 0), or saved feature
    files diverge by 1.0 on silence (ADVICE r4)."""
    sig = np.concatenate([_load("hvd_593")[:48000], np.zeros(24000)])
    (mag_c, real_c, imag_c, _f0, _sh), = analysis_lossless_batch(
        [sig], 48000, transport="compact")
    z = mag_c == 0.0
    assert z.any()              # the zero tail produced silent bins
    assert np.all(real_c[z] == 0.0)
    assert np.all(imag_c[z] == 0.0)


def test_speculative_schedule_bitwise_matches_synced(monkeypatch):
    """VERDICT r4 item 1: the speculative schedule (phase 2 dispatched at
    the walk capacity m_max, mark counts fetched on the download thread)
    must produce BITWISE the same features as the synced schedule (phase
    2 at the realised frame bucket) — per-frame ops don't depend on the
    padded frame count, and the device-side trim keeps the download at
    the realised bucket either way."""
    from magphase_jax.parallel.analysis_batch import (
        analysis_compressed_batch_async)

    sigs = [_load("hvd_593"), _load("hvd_594")[:70000], _load("hvd_595")]

    monkeypatch.setenv("MAGPHASE_ANALYSIS_SYNC", "1")
    ref = analysis_compressed_batch_async(sigs, 48000,
                                          feat_dtype=np.float32)()
    monkeypatch.delenv("MAGPHASE_ANALYSIS_SYNC")
    got = analysis_compressed_batch_async(sigs, 48000,
                                          feat_dtype=np.float32)()
    assert len(got) == len(ref) == 3
    for (a, b, c, d, e), (a2, b2, c2, d2, e2) in zip(ref, got):
        np.testing.assert_array_equal(a, a2)
        np.testing.assert_array_equal(b, b2)
        np.testing.assert_array_equal(c, c2)
        np.testing.assert_array_equal(d, d2)
        np.testing.assert_array_equal(e, e2)

    # const-rate branch too (different phase-2 output geometry)
    monkeypatch.setenv("MAGPHASE_ANALYSIS_SYNC", "1")
    ref_c = analysis_compressed_batch_async(sigs[:2], 48000,
                                            b_const_rate=True)()
    monkeypatch.delenv("MAGPHASE_ANALYSIS_SYNC")
    got_c = analysis_compressed_batch_async(sigs[:2], 48000,
                                            b_const_rate=True)()
    for r, g in zip(ref_c, got_c):
        for x, y in zip(r, g):
            np.testing.assert_array_equal(x, y)


def test_lossless_batch_compact16_transport_gate():
    """'compact16' transport (uint16-affine mag + int16 phase angle —
    a third of the f32 download bytes) must stay inside the sub-PCM16
    copy-synthesis budget (VERDICT r4 item 4).  Contrast: f16 mag alone
    FAILS this gate (measured p99 8.8e-5 vs the 2^-15 = 3.05e-5 PCM16
    step) because its error is relative everywhere; the affine step is
    absolute at bin-peak/65535, so the energy-carrying frames quantise
    ~30x finer."""
    from magphase_jax.vocoder import synthesis_from_lossless

    sig = _load("hvd_593")
    (mag_c, real_c, imag_c, f0_c, sh_c), = analysis_lossless_batch(
        [sig], 48000, transport="compact16")
    (mag_f, real_f, imag_f, f0_f, sh_f), = analysis_lossless_batch(
        [sig], 48000)
    np.testing.assert_array_equal(sh_c, sh_f)
    np.testing.assert_array_equal(f0_c, f0_f)
    # per-bin absolute quantisation bound: scale/2 = range/(2*65535)
    rng = mag_f.max(axis=0) - mag_f.min(axis=0)
    assert np.all(np.abs(mag_c - mag_f) <= rng[None, :] / 65535.0 + 1e-7)
    assert np.max(np.abs(real_c - real_f)) < 3e-4
    assert np.max(np.abs(imag_c - imag_f)) < 3e-4

    syn = synthesis_from_lossless(mag_c.astype(np.float64),
                                  real_c.astype(np.float64),
                                  imag_c.astype(np.float64), f0_c, 48000)
    n = min(len(syn), len(sig))
    err = np.abs(syn[2000:n - 2000] - sig[2000:n - 2000])
    assert float(np.percentile(err, 99)) < 2.0 ** -15
    assert float(err.max()) < 2.0 ** -14
