"""Fully device-resident batched copy-synthesis: wav in -> wav out with no
intermediate host transfers.

Pipeline (all on device, one utterance batch):
  preprocess -> NCCF -> Viterbi     (epochs/tracker.py kernels, vmapped)
  epoch walk                        (epochs/placement_device.py)
  pitch-sync analysis + rfft        (vocoder/lossless.py kernel, vmapped)
  phasor resynthesis + OLA          (vocoder/lossless.py kernel, vmapped)

This is the reference's demo_copy_synthesis_lossless.py workload
(REAPER + numpy loops + per-utterance processes) as a single jit.
Synthesis uses the pitch marks directly (the f0 -> shift -> cumsum detour
of magphase.py:1771-1772 is an exact round trip when features are not
stored in between).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..epochs import tracker
from ..epochs.placement_device import track_and_place_batch
from ..utils.padding import bucket
from ..vocoder.lossless import _analysis_kernel, _synthesis_kernel
from .mesh import capped_batch_step, shard_batch


@functools.partial(jax.jit, static_argnames=("fs", "n_frames_max",
                                             "m_max", "fft_len",
                                             "out_len_max"))
def _copy_synthesis_kernel(sigs, n_sigs, n_frames, *, fs: int,
                           n_frames_max: int, m_max: int, fft_len: int,
                           out_len_max: int):
    """(B, S) signals -> (B, out_len_max) resynthesised signals + stats."""
    from .analysis_batch import _sigs_f32
    sigs = _sigs_f32(sigs)
    marks, flags, n_marks = track_and_place_batch(
        sigs, n_sigs, n_frames, fs=fs, n_frames_max=n_frames_max,
        m_max=m_max)

    # batched analysis + synthesis
    from ..vocoder.lossless import analysis_core_batch, synthesis_core_batch
    mag, real, imag, _f0, shift = analysis_core_batch(
        sigs, marks, n_marks, n_sigs, flags, fft_len=fft_len, fs=fs)
    bufs = synthesis_core_batch(mag, real, imag, marks, n_marks,
                                fft_len=fft_len, out_len_max=out_len_max)
    return bufs, n_marks


def copy_synthesis_batch(signals: list, fs: int, fft_len: int = 4096,
                         mesh=None, block_result: bool = True):
    """Batched lossless copy-synthesis.  Returns list of waveforms (or the
    device buffer + per-utterance mark counts when block_result=False)."""
    from .analysis_batch import _budget_geometry, _tracker_frame_geometry

    # HBM budget: split oversized (long-utterance) batches sequentially
    n_real = len(signals)
    S, m_max, max_b = _budget_geometry(signals, fs, fft_len, mesh)
    if n_real > max_b:
        out, rows, nms = [], [], []
        for i in range(0, n_real, max_b):
            group = signals[i:i + max_b]
            r = copy_synthesis_batch(group, fs, fft_len=fft_len, mesh=mesh,
                                     block_result=block_result)
            if block_result:
                out.extend(r)
            else:
                bufs_g, nm_g = r
                rows.extend(bufs_g[j] for j in range(len(group)))
                nms.extend(nm_g[j] for j in range(len(group)))
        return out if block_result else (rows, nms)

    # bucket the batch axis (dummy silent utterances, dropped on return)
    B = bucket(n_real, capped_batch_step(mesh, max_b))
    if B > n_real:
        signals = list(signals) + [np.zeros(1024)] * (B - n_real)
    from .analysis_batch import assemble_signal_rows
    sigs = assemble_signal_rows(signals, len(signals), S)
    n_sigs = np.asarray([len(s) for s in signals], np.int32)

    n_frames, Tmax = _tracker_frame_geometry(signals, fs)
    out_len_max = S + (1 << 14)

    sigs_d = jnp.asarray(sigs)
    n_sigs_d = jnp.asarray(n_sigs)
    n_frames_d = jnp.asarray(n_frames)
    if mesh is not None:
        sigs_d, n_sigs_d, n_frames_d = shard_batch(
            mesh, sigs_d, n_sigs_d, n_frames_d)

    bufs, n_marks = _copy_synthesis_kernel(
        sigs_d, n_sigs_d, n_frames_d, fs=fs, n_frames_max=Tmax,
        m_max=m_max, fft_len=fft_len, out_len_max=out_len_max)

    if not block_result:
        return bufs, n_marks
    nm = np.asarray(jax.device_get(n_marks))
    if int(nm[:n_real].max(initial=0)) >= m_max:
        from ..utils.metrics import logger
        logger.warning("copy-synthesis epoch-walk capacity hit; output "
                       "truncated for some utterance(s)")
    bufs = jax.device_get(bufs)
    out = []
    for b in range(n_real):
        out.append(np.asarray(bufs[b][:len(signals[b])], np.float64))
    return out
