"""Fused device copy-synthesis pipeline."""
import numpy as np

from magphase_jax.io import read_wav
from magphase_jax.parallel.copy_synthesis import copy_synthesis_batch
from magphase_jax.epochs import tracker
from magphase_jax.epochs.placement_device import place_epochs_kernel

DATA = "/root/reference/demos/data_48k/wavs_nat"


def _host_vs_device_walk(sig, fs, pad_frames_to=None):
    """Run both walks; the device side gets production-shaped inputs
    (f0/voiced PADDED past the real frame count when pad_frames_to is
    set, as track_and_place_one feeds the kernel)."""
    import jax.numpy as jnp
    from magphase_jax.utils.padding import bucket, pad_to

    f0, voiced, step, y_snap = tracker.track_f0(sig, fs)
    pm_h, voi_h = tracker.place_epochs(sig, fs, f0, voiced, y_snap, step)

    T = len(f0)
    Tp = pad_frames_to or T
    S = bucket(len(sig), 1 << 15)
    marks, flags, n_marks = place_epochs_kernel(
        jnp.asarray(pad_to(y_snap.astype(np.float32), S)),
        jnp.asarray(pad_to(f0.astype(np.float32), Tp)),
        jnp.asarray(pad_to(voiced.astype(np.float32), Tp)),
        jnp.int32(len(sig)), jnp.int32(T), fs=fs, m_max=1024,
        frame_step=float(step * fs))
    n = int(n_marks)
    return (np.round(pm_h * fs).astype(int), voi_h,
            np.asarray(marks)[:n], np.asarray(flags)[:n])


def test_device_epoch_placement_matches_host():
    sig, fs = read_wav(f"{DATA}/hvd_593.wav")
    pm_h, voi_h, pm_d, voi_d = _host_vs_device_walk(sig, fs)
    # the two walks implement the same algorithm: sample-exact agreement
    assert len(pm_d) == len(pm_h)
    assert np.array_equal(pm_d, pm_h)
    assert np.array_equal(voi_d, voi_h)


def test_device_epoch_placement_exact_with_padded_track():
    """Voiced-to-the-end audio with the f0 track padded past the real
    frame count (the fused production path's input shape): the frame
    lookup must clip to the last REAL frame, not read unvoiced padding."""
    fs = 48000
    t = np.arange(fs) / fs
    sig = 0.4 * np.sign(np.sin(2 * np.pi * 150 * t))
    pm_h, voi_h, pm_d, voi_d = _host_vs_device_walk(sig, fs,
                                                    pad_frames_to=640)
    assert len(pm_d) == len(pm_h)
    assert np.array_equal(pm_d, pm_h)
    assert np.array_equal(voi_d, voi_h)


def test_copy_synthesis_batch_reconstructs():
    sigs = [read_wav(f"{DATA}/{t}.wav")[0] for t in ("hvd_593", "hvd_594")]
    outs = copy_synthesis_batch(sigs, 48000)
    for sig, syn in zip(sigs, outs):
        n = min(len(sig), len(syn))
        err = np.abs(syn[2000:n - 2000] - sig[2000:n - 2000])
        assert np.percentile(err, 99) < 2 ** -13, \
            f"p99 err {np.percentile(err, 99):.2e}"
