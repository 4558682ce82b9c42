"""Host-link transfer encodings and the adaptive synthesis FFT rule."""
import numpy as np
import jax
import pytest

from magphase_jax.vocoder.compressed import (max_pitch_sync_framelen,
                                             synthesis_fft_len)


def test_max_pitch_sync_framelen():
    # L[f]=shift[f], R[f]=shift[f+1]; last frame doubles its own shift
    assert max_pitch_sync_framelen(np.array([240, 240, 240])) == 481
    assert max_pitch_sync_framelen(np.array([100, 900, 100])) == 1001
    assert max_pitch_sync_framelen(np.array([100, 100, 900])) == 1801
    assert max_pitch_sync_framelen(np.array([300])) == 601


def test_synthesis_fft_len_rule(monkeypatch):
    monkeypatch.delenv("MAGPHASE_SYNTH_FULL_FFT", raising=False)
    assert synthesis_fft_len(4096, 481) == 1024
    assert synthesis_fft_len(4096, 1024) == 1024
    assert synthesis_fft_len(4096, 1025) == 2048
    assert synthesis_fft_len(4096, 2048) == 2048
    assert synthesis_fft_len(4096, 2049) == 4096
    assert synthesis_fft_len(2048, 481) == 1024     # 16 kHz nominal
    # floor: never below 1024 even for tiny frames
    assert synthesis_fft_len(4096, 3) == 1024
    # opt-out
    monkeypatch.setenv("MAGPHASE_SYNTH_FULL_FFT", "1")
    assert synthesis_fft_len(4096, 481) == 4096


def test_pcm16_kernel_matches_host_writer(tmp_path):
    """Device peak-norm + quantise == write_audio_file -> write_wav, and
    write_wav_pcm16 round-trips through the reader bit-exactly."""
    from magphase_jax.io.wav import (read_wav, write_audio_file,
                                     write_wav_pcm16)
    from magphase_jax.parallel.batch import _pcm16_kernel

    rng = np.random.RandomState(0)
    n = 4001
    sig = (rng.randn(n) * 0.21).astype(np.float32)
    bufs = np.zeros((2, 4608), np.float32)
    bufs[0, :n] = sig
    bufs[1, :100] = 0.0                      # silent row: no normalisation
    lens = np.asarray([n, 100], np.int32)

    pcm = np.asarray(_pcm16_kernel(bufs, lens))
    assert pcm.dtype == np.int16

    write_wav_pcm16(str(tmp_path / "dev.wav"), pcm[0][:n], 48000)
    write_audio_file(str(tmp_path / "host.wav"),
                     np.asarray(sig, np.float64), 48000)
    a, fs = read_wav(str(tmp_path / "dev.wav"))
    b, _ = read_wav(str(tmp_path / "host.wav"))
    assert fs == 48000 and len(a) == len(b) == n
    # float32 vs float64 normalisation: at most one rint boundary LSB
    assert np.max(np.abs(a - b)) * 32768.0 <= 1.0 + 1e-6
    assert np.max(np.abs(a)) == pytest.approx(0.98, abs=2e-4)
    assert np.all(pcm[1] == 0)


def test_int16_signal_rows_roundtrip():
    """assemble_signal_rows int16 packing is exact for PCM16 signals and
    falls back to float32 otherwise."""
    from magphase_jax.parallel.analysis_batch import (_sigs_f32,
                                                      assemble_signal_rows)
    import jax.numpy as jnp

    k = np.arange(-32768, 32768, 97, np.int64)
    sig = (k / 32768.0).astype(np.float64)
    rows = assemble_signal_rows([sig, sig[:100]], 2, len(sig))
    assert rows.dtype == np.int16
    back = np.asarray(_sigs_f32(jnp.asarray(rows)))
    np.testing.assert_array_equal(back[0], sig.astype(np.float32))

    rows = assemble_signal_rows([sig + 1e-9], 1, len(sig))
    assert rows.dtype == np.float32


def test_quantise_feats_error_bound():
    """Dequantisation error <= scale/2 on every valid row/coefficient."""
    from magphase_jax.parallel.batch import quantise_feats

    rng = np.random.RandomState(7)
    B, F, D = 3, 50, 12
    x = (rng.randn(B, F, D) * np.linspace(0.5, 20, D)).astype(np.float16)
    nfrms = np.asarray([50, 17, 1])
    q, scale, zp = quantise_feats(x, nfrms)
    assert q.dtype == np.uint8 and scale.shape == (B, D)
    deq = q.astype(np.float32) * scale[:, None, :] + zp[:, None, :]
    for b in range(B):
        n = nfrms[b]
        err = np.abs(deq[b, :n] - x[b, :n].astype(np.float32))
        assert np.all(err <= scale[b][None, :] * 0.5 + 1e-6), err.max()
    # constant column -> scale guard, exact round trip
    xc = np.full((1, 4, 2), 3.25, np.float16)
    q, scale, zp = quantise_feats(xc, np.asarray([4]))
    deq = q.astype(np.float32) * scale[:, None, :] + zp[:, None, :]
    np.testing.assert_allclose(deq, 3.25)


def test_int8_transport_synthesis_negligible():
    """int8 feature transport: output within a fraction of the noise-
    realisation variance (measured: ~0.26 dB MSD vs the f16 transport at
    the SAME key, while changing only the key moves ~10 dB MSD)."""
    import os
    import jax
    from magphase_jax.io import read_binfile
    from magphase_jax.parallel.batch import synthesis_from_compressed_batch
    from magphase_jax.utils.eval import mel_spectral_distortion

    pred = "/root/reference/demos/data_48k/params_predicted"
    toks = ["hvd_704", "hvd_706"]
    utts = [(read_binfile(os.path.join(pred, t + ".mag"), 60),
             read_binfile(os.path.join(pred, t + ".real"), 45),
             read_binfile(os.path.join(pred, t + ".imag"), 45),
             read_binfile(os.path.join(pred, t + ".lf0"), 1))
            for t in toks]
    key = jax.random.PRNGKey(3)
    a = synthesis_from_compressed_batch(utts, 48000, key=key)
    b = synthesis_from_compressed_batch(utts, 48000, key=key,
                                        transport="int8")
    for x, y in zip(a, b):
        n = min(len(x), len(y))
        rel = np.sqrt(np.mean((x[:n] - y[:n]) ** 2)) / \
            np.sqrt(np.mean(x[:n] ** 2))
        assert rel < 0.02, rel
        msd = mel_spectral_distortion(x[:n], y[:n], 48000)
        assert msd < 0.5, msd
