"""Pitch-synchronous Griffin-Lim (magphase.py:3320-3373), on device.

Layout note: the reference's Griffin-Lim keeps frames *centred* (pitch mark
at fft_len/2, via frm_list_to_matrix) with no delay-compensation rotation on
either side of the loop; that centred layout is our rotated layout fftshifted
(roll by fft_len/2), see core/framing.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import framing
from ..core.spectral import build_min_phase_from_mag_spec
from ..core.windows import HANNING
from ..utils.padding import FRM_STEP, bucket, bucket_signal, pad_to


def _herm_phase(m_phase_half):
    """add_hermitian_half(…, 'phase') (libaudio.py:375-378): zero DC and
    Nyquist, odd mirror of the interior bins."""
    zeroed = m_phase_half.at[:, 0].set(0).at[:, -1].set(0)
    return jnp.concatenate([zeroed, -zeroed[:, -2:0:-1]], axis=1)


@functools.partial(jax.jit, static_argnames=("fft_len", "niters",
                                             "out_len_max", "phase_init"))
def _griffin_lim_kernel(m_mag_half, pm, nfrms, key, m_phase0, *,
                        fft_len: int, niters: int, out_len_max: int,
                        phase_init: str):
    """Returns (signal buffer, half phase).

    m_phase0: (F, h) half phase matrix, used only when phase_init ==
    'given' (the reference's ndarray init, magphase.py:3348-3349);
    zeros otherwise.
    """
    F = m_mag_half.shape[0]
    h = fft_len // 2 + 1
    n_sig_max = out_len_max

    # full-spectrum magnitude (add_hermitian_half, magphase.py:3353)
    m_mag = jnp.concatenate([m_mag_half, m_mag_half[:, -2:0:-1]], axis=1)

    if phase_init == "random":
        m_phase = 2 * jnp.pi * (jax.random.uniform(key, (F, fft_len),
                                                   m_mag_half.dtype) - 0.5)
    elif phase_init == "linear":
        imp = jnp.zeros((F, fft_len)).at[:, fft_len // 2].set(1.0)
        m_phase = jnp.angle(jnp.fft.fft(imp))
    elif phase_init == "min_phase":
        mp = jnp.angle(build_min_phase_from_mag_spec(m_mag_half))
        m_phase = _herm_phase(mp)
    elif phase_init == "given":
        m_phase = _herm_phase(m_phase0.astype(m_mag_half.dtype))
    else:
        raise ValueError(phase_init)

    n_sig = jnp.minimum(
        pm[nfrms - 1] + (pm[nfrms - 1] - pm[nfrms - 2]) + 1, n_sig_max)

    # B=1 batch entry points, shared with the batched pipelines — this
    # loop runs both 30 times
    pm_b, nfrms_b = pm[None], nfrms[None]
    n_sig_b = n_sig[None]

    def body(i, m_phase):
        # synthesis (magphase.py:3357-3360): frames are centred -> OLA
        m_cmplx = m_mag * jnp.exp(1j * m_phase)
        v_sig = framing.ola_centered_batch(
            jnp.fft.ifft(m_cmplx).real[None], pm_b, nfrms_b, n_sig_max)[0]
        # re-analysis (3365-3371): pitch-sync windowing, centred layout
        frames, _, _, _ = framing.pitch_sync_frames_batch(
            v_sig[None], pm_b, nfrms_b, n_sig_b, fft_len,
            win_family=HANNING)
        centred = jnp.roll(frames[0], fft_len // 2, axis=1)
        return jnp.angle(jnp.fft.fft(centred))

    m_phase = jax.lax.fori_loop(0, niters - 1, body, m_phase)
    # final synthesis with the last phase (loop breaks before re-analysis)
    m_cmplx = m_mag * jnp.exp(1j * m_phase)
    v_sig = framing.ola_centered_batch(
        jnp.fft.ifft(m_cmplx).real[None], pm_b, nfrms_b, n_sig_max)[0]
    return v_sig, m_phase[:, :h]


def griffin_lim(m_mag, v_shift, phase_init="random",
                niters: int = 30, key=None):
    """magphase.py:3320-3373.  Returns (v_sig, half phase matrix).

    phase_init: 'random' | 'linear' | 'min_phase' | an (nfrms, h) ndarray
    of initial phase values (magphase.py:3348-3349).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    m_mag = np.asarray(m_mag, np.float64)
    v_shift = np.round(np.asarray(v_shift)).astype(np.int64)
    nfrms, h = m_mag.shape
    fft_len = 2 * (h - 1)
    v_pm = np.cumsum(v_shift)
    out_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]) + 1)

    F = bucket(nfrms, FRM_STEP)
    O = bucket_signal(out_len)

    if isinstance(phase_init, np.ndarray) or hasattr(phase_init, "ndim"):
        m_phase0 = pad_to(np.asarray(phase_init, np.float32), F)
        if m_phase0.shape != (F, h):
            raise ValueError("phase_init matrix must be (nfrms, h)")
        init_mode = "given"
    else:
        m_phase0 = np.zeros((F, h), np.float32)
        init_mode = str(phase_init)

    v_sig, m_phase = _griffin_lim_kernel(
        jnp.asarray(pad_to(m_mag.astype(np.float32), F)),
        jnp.asarray(pad_to(v_pm.astype(np.int32), F)),
        jnp.int32(nfrms), key, jnp.asarray(m_phase0), fft_len=fft_len,
        niters=niters, out_len_max=O, phase_init=init_mode)
    return (np.asarray(jax.device_get(v_sig)[:out_len], np.float64),
            np.asarray(jax.device_get(m_phase)[:nfrms], np.float64))
