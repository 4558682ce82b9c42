"""The Pallas epoch walk must be sample-exact equal to the XLA
while_loop walk.

Reference semantics under test: the epoch placement walk of
epochs/tracker.py:place_epochs (REAPER's role in magphase.py:2875-2879),
batched device form in epochs/placement_device.py.  The Pallas kernel
(pallas_kernels/walk_pallas.py, Triton route) runs here in interpret
mode; on a GPU it runs compiled (the `gpu` test below, and chip_smoke.py
phase h).  Inputs are
generated utterances with known epochs (utils/stimuli.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magphase_jax.epochs import placement_device as pd
from magphase_jax.pallas_kernels.walk_pallas import place_epochs_pallas
from magphase_jax.utils.stimuli import make_corpus


@functools.lru_cache(maxsize=None)
def _signals(fs, n, seed=0, min_s=1.0, max_s=1.6):
    return tuple(u.sig for u in make_corpus(n, fs, seed=seed, min_s=min_s,
                                            max_s=max_s))


def _walk_inputs(signals, fs):
    from magphase_jax.parallel import analysis_batch as ab

    _, dev, S, Tmax, m_max, _ = ab._device_signal_batch(
        list(signals), fs, None, fft_len=1024)
    sigs_d, n_sigs_d, n_frames_d = dev
    sigs_f = ab._sigs_f32(sigs_d)
    y_snap, f0, voi = jax.vmap(functools.partial(
        pd._track_one, fs=fs, n_frames_max=Tmax))(sigs_f, n_frames_d)
    return y_snap, f0, voi, n_sigs_d, n_frames_d, m_max


def _pallas(y_snap, f0, voi, n_sigs, n_frames, fs, m_max, interpret=True):
    tab = jax.vmap(functools.partial(pd.walk_tables, fs=fs))(f0, voi)
    return place_epochs_pallas(
        y_snap, tab, n_sigs, n_frames, m_max=m_max,
        step=int(pd._walk_frame_step(fs)), unv_step=int(round(0.005 * fs)),
        win=pd._walk_win(fs), interpret=interpret)


def _both(y_snap, f0, voi, n_sigs, n_frames, fs, m_max, interpret=True):
    ref = jax.vmap(functools.partial(
        pd.place_epochs_kernel, fs=fs, m_max=m_max,
        frame_step=pd._walk_frame_step(fs)))(
        y_snap, f0, voi, n_sigs, n_frames)
    return ref, _pallas(y_snap, f0, voi, n_sigs, n_frames, fs, m_max,
                        interpret)


def _assert_equal(ref, got):
    r_marks, r_flags, r_nm = (np.asarray(x) for x in ref)
    g_marks, g_flags, g_nm = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(g_nm, r_nm)
    np.testing.assert_array_equal(g_marks, r_marks)
    np.testing.assert_array_equal(g_flags, r_flags)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_walk_pallas_corpus_exact(fs):
    y, f0, voi, ns, nf, m_max = _walk_inputs(_signals(fs, 3), fs)
    assert int(np.asarray(nf).max()) > 0
    _assert_equal(*_both(y, f0, voi, ns, nf, fs, m_max))


@pytest.mark.gpu
@pytest.mark.parametrize("fs", [16000, 48000])
def test_walk_pallas_compiled_on_gpu(gpu, fs):
    """The kernel compiled by Triton, not interpreted, on the card."""
    y, f0, voi, ns, nf, m_max = _walk_inputs(_signals(fs, 3), fs)
    _assert_equal(*_both(y, f0, voi, ns, nf, fs, m_max, interpret=False))


def test_walk_pallas_capacity_hit():
    """n_marks == m_max at capacity, matching the XLA kernel exactly."""
    y, f0, voi, ns, nf, _ = _walk_inputs(_signals(16000, 2), 16000)
    ref, got = _both(y, f0, voi, ns, nf, 16000, 128)
    assert int(np.asarray(ref[2]).max()) == 128
    _assert_equal(ref, got)


def test_walk_pallas_noise_and_silence():
    """All-unvoiced (noise) and near-empty signals."""
    rng = np.random.RandomState(0)
    sigs = [rng.uniform(-0.3, 0.3, 48000), np.zeros(1024)]
    y, f0, voi, ns, nf, m_max = _walk_inputs(sigs, 48000)
    _assert_equal(*_both(y, f0, voi, ns, nf, 48000, m_max))


def test_walk_pallas_batch_chunking():
    """One program per utterance: walking rows one at a time gives the
    batched result."""
    y, f0, voi, ns, nf, m_max = _walk_inputs(_signals(16000, 3), 16000)
    ref, _ = _both(y, f0, voi, ns, nf, 16000, m_max)
    got = [_pallas(y[b:b + 1], f0[b:b + 1], voi[b:b + 1], ns[b:b + 1],
                   nf[b:b + 1], 16000, m_max) for b in range(y.shape[0])]
    got = tuple(jnp.concatenate([g[i] for g in got]) for i in range(3))
    _assert_equal(ref, got)


def test_walk_xla_matches_host_walk():
    """The XLA walk equals the host walk of epochs/tracker.py on the same
    track (the host walk is the reference semantics of both kernels)."""
    from magphase_jax.epochs import tracker

    fs = 16000
    sig = _signals(fs, 1)[0]
    f0, voiced, fstep, y_snap = tracker.track_f0(sig, fs)
    pm_sec, voi = tracker.place_epochs(sig, fs, f0, voiced, y_snap, fstep)
    y, f0d, vd, ns, nf, m_max = _walk_inputs([sig], fs)
    marks, flags, nm = (np.asarray(a)[0] for a in jax.vmap(
        functools.partial(pd.place_epochs_kernel, fs=fs, m_max=m_max,
                          frame_step=pd._walk_frame_step(fs)))(
        y, f0d, vd, ns, nf))
    np.testing.assert_array_equal(marks[:nm], np.rint(pm_sec * fs))
    np.testing.assert_array_equal(flags[:nm], voi)


def test_track_and_place_batch_uses_same_results():
    """The batched production entry equals vmapped track_and_place_one."""
    from magphase_jax.parallel import analysis_batch as ab

    fs = 48000
    _, dev, S, Tmax, m_max, _ = ab._device_signal_batch(
        list(_signals(fs, 3)), fs, None, fft_len=4096)
    sigs_d, n_sigs_d, n_frames_d = dev
    sigs_f = ab._sigs_f32(sigs_d)
    ref = jax.vmap(functools.partial(
        pd.track_and_place_one, fs=fs, n_frames_max=Tmax, m_max=m_max))(
        sigs_f, n_sigs_d, n_frames_d)
    got = pd.track_and_place_batch(sigs_f, n_sigs_d, n_frames_d, fs=fs,
                                   n_frames_max=Tmax, m_max=m_max)
    _assert_equal(ref, got)


def test_walk_dispatch_and_window():
    """The Pallas window is a power of two covering the snap span, and
    a non-integral frame step keeps the XLA walk."""
    for fs in (16000, 22050, 44100, 48000):
        w = pd._walk_win(fs)
        assert w & (w - 1) == 0 and w >= pd._snap_win(fs)
    y, f0, voi, ns, nf, m_max = _walk_inputs(_signals(16000, 2), 16000)
    got = pd.place_epochs_batch(y, f0, voi, ns, nf, fs=16000, m_max=m_max,
                                frame_step=80.5)
    ref = jax.vmap(functools.partial(
        pd.place_epochs_kernel, fs=16000, m_max=m_max, frame_step=80.5))(
        y, f0, voi, ns, nf)
    _assert_equal(ref, got)
