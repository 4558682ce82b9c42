"""High-level MagPhaseVocoder facade + ops namespace."""
import numpy as np
import jax


def test_ops_namespace_exports():
    from magphase_jax import ops
    assert callable(ops.sp_mel_warp)
    assert callable(ops.pitch_sync_frames_batch)
    assert callable(ops.sosfilt)


def test_vocoder_facade_synthesis_roundtrip():
    import os
    from magphase_jax.io import read_binfile
    from magphase_jax.models import MagPhaseVocoder
    PRED = "/root/reference/demos/data_48k/params_predicted"
    mag = read_binfile(os.path.join(PRED, "hvd_704.mag"), 60)
    real = read_binfile(os.path.join(PRED, "hvd_704.real"), 45)
    imag = read_binfile(os.path.join(PRED, "hvd_704.imag"), 45)
    lf0 = read_binfile(os.path.join(PRED, "hvd_704.lf0"), 1)

    voc = MagPhaseVocoder(fs=48000, pf_type="magphase")
    v = voc.synthesize(mag, real, imag, lf0, key=jax.random.PRNGKey(0))
    assert np.all(np.isfinite(v))
    assert np.std(v) > 1e-4

    wavs = voc.synthesize_batch([(mag, real, imag, lf0)] * 3,
                                key=jax.random.PRNGKey(0))
    assert len(wavs) == 3
    assert all(np.all(np.isfinite(w)) for w in wavs)
