"""Remaining DSP utility surface of libaudio.py / magphase.py.

interp_unv_regions      libaudio.py:273-291
smooth_by_conv          libaudio.py:878-918
windowing_const_rate    libaudio.py:505-533  (+ GetNFramesFromSigLen 537-543)
mcep_to_lin_sp_log      libaudio.py:548-558
cos_win                 libaudio.py:145-148
hz_to_bin / bin_to_hz   libaudio.py:151-155
next_pow_of_two         libaudio.py:495-502
ph_enc / ph_dec         magphase.py:423-441
win_squared             magphase.py:2472-2477
get_ap_mask_from_uv_decision  magphase.py:1979-1996
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def interp_unv_regions(m_data: jnp.ndarray, v_voi: jnp.ndarray,
                       interp_type: str = "linear") -> jnp.ndarray:
    """Interpolate feature rows across unvoiced gaps (libaudio.py:273-291).

    'zeros' zeroes unvoiced rows; 'linear' linearly interpolates between
    surrounding voiced rows (edge regions clamp to the first/last voiced
    row, matching the reference's fill_value behaviour).
    """
    vb = v_voi > 0
    if interp_type == "zeros":
        return m_data * vb[:, None].astype(m_data.dtype)

    import jax
    n = m_data.shape[0]
    idx = jnp.arange(n)
    # nearest voiced row at/before i, and at/after i
    prev_v = jax.lax.cummax(jnp.where(vb, idx, -1))
    next_v = n - 1 - jax.lax.cummax(jnp.where(vb[::-1], idx, -1))[::-1]
    first = jnp.argmax(vb)
    last = n - 1 - jnp.argmax(vb[::-1])
    prev_v = jnp.clip(jnp.where(prev_v < 0, first, prev_v), 0, n - 1)
    next_v = jnp.clip(jnp.where(next_v > last, last, next_v), 0, n - 1)
    d_prev = m_data[prev_v]
    d_next = m_data[next_v]
    span = jnp.maximum(next_v - prev_v, 1)
    w = ((idx - prev_v) / span)[:, None].astype(m_data.dtype)
    interp = d_prev + w * (d_next - d_prev)
    same = (next_v == prev_v)[:, None]
    out = jnp.where(same, d_prev, interp)
    return jnp.where(vb[:, None], m_data, out)


def smooth_by_conv(m_data: jnp.ndarray, v_win=None) -> jnp.ndarray:
    """Boundary-extended moving-average smoother along axis 0
    (libaudio.py:878-918)."""
    if v_win is None:
        v_win = np.hanning(11)
    v_win = np.asarray(v_win, np.float64)
    win_len = len(v_win)
    if win_len < 3:
        return m_data
    if win_len % 2 == 0:
        # the reference's extension arithmetic only works for odd windows
        # (libaudio.py:880 "Length of v_win should be odd"; even lengths
        # fail a shape assignment there) — error instead of silently
        # computing a wrong edge value via clamped gathers
        raise ValueError("smooth_by_conv window length must be odd")
    half = (win_len - 1) // 2
    # np.convolve FLIPS the kernel (true convolution); the einsum below is
    # correlation, so flip here to match libaudio.py:901
    k = jnp.asarray((v_win / v_win.sum())[::-1].copy(), m_data.dtype)

    one_d = m_data.ndim == 1
    if one_d:
        m_data = m_data[:, None]
    top = jnp.repeat(m_data[:1], half, axis=0)
    bot = jnp.repeat(m_data[-1:], half, axis=0)
    ext = jnp.concatenate([top, m_data, bot], axis=0)
    # 'valid' convolution per column
    n = m_data.shape[0]
    idx = jnp.arange(n)[:, None] + jnp.arange(win_len)[None, :]
    gath = ext[idx]                       # (n, win_len, d)
    # HIGHEST: the smoothing feeds log-spectral envelopes compared with
    # the float64 reference; TF32's ~3 digits would show there, and the
    # win_len-term contraction is too small for the precision to cost
    out = jnp.einsum("nwd,w->nd", gath, k,
                     precision=jax.lax.Precision.HIGHEST)
    return out[:, 0] if one_d else out


def windowing_const_rate(v_sig: jnp.ndarray, winlen: int, shift: int,
                         winfunc=np.hanning, extend: str = "none"):
    """Constant frame-rate windowing (libaudio.py:505-533)."""
    shift = int(shift)
    v_win = jnp.asarray(winfunc(winlen), v_sig.dtype)
    if extend in ("both", "beg"):
        v_sig = jnp.concatenate(
            [jnp.zeros(winlen // 2, v_sig.dtype), v_sig])
    if extend in ("both", "end"):
        v_sig = jnp.concatenate([v_sig, jnp.zeros(winlen, v_sig.dtype)])
    n_frms = int(np.floor(1 + (v_sig.shape[0] - winlen) / float(shift)))
    idx = (jnp.arange(n_frms) * shift)[:, None] + jnp.arange(winlen)[None, :]
    return v_sig[idx] * v_win[None, :]


def get_n_frames_from_sig_len(sig_len: int, shift_ms: float, fs: int) -> int:
    """libaudio.py:537-543."""
    shift = round(fs * shift_ms / 1000)
    return int(np.ceil(1 + ((sig_len - 1) / shift)))


def mcep_to_lin_sp_log(m_mgc: jnp.ndarray, nFFT: int) -> jnp.ndarray:
    """mcep -> log spectrum without warping (libaudio.py:548-558)."""
    n_frms, n_coeffs = m_mgc.shape
    half = nFFT // 2 + 1
    pad = jnp.zeros((n_frms, nFFT // 2 - n_coeffs + 1), m_mgc.dtype)
    m = jnp.concatenate([m_mgc, pad], axis=1)
    m = jnp.concatenate([m, m[:, -2:0:-1]], axis=1)
    return jnp.fft.fft(m, n=nFFT).real[:, :half]


def cos_win(N: int) -> np.ndarray:
    """sin half-wave window; cos_win**2 == hanning (libaudio.py:145-148)."""
    return np.sin(np.linspace(0, np.pi, N))


def hz_to_bin(v_hz, nFFT: int, fs: int):
    return np.asarray(v_hz) * nFFT / float(fs)


def bin_to_hz(v_bin, nFFT: int, fs: int):
    return np.asarray(v_bin) * fs / float(nFFT)


def next_pow_of_two(x) -> int:
    x = max(x, 2)
    return int(2 ** np.ceil(np.log2(x)))


def ph_enc(m_ph):
    """phase -> (sin, cos) (magphase.py:423-426)."""
    return jnp.sin(m_ph), jnp.cos(m_ph)


def ph_dec(m_phs, m_phc, mode: str = "angle"):
    """(sin, cos) -> phase (magphase.py:431-441)."""
    if mode == "sign":
        m_bs = jnp.arcsin(m_phs)
        m_bc = jnp.arccos(m_phc)
        return jnp.sign(m_bs) * jnp.abs(m_bc)
    if mode == "angle":
        return jnp.angle(m_phc + 1j * m_phs)
    raise ValueError(mode)


def win_squared(L: int) -> np.ndarray:
    """Centre-half boxcar (magphase.py:2472-2477)."""
    v = np.zeros(L)
    q, h = int(np.floor(L / 4.0)), int(np.floor(L / 2.0))
    v[q:q + h] = 1.0
    return v


def get_ap_mask_from_uv_decision(v_voi, nFFT: int, fs: int, mvf: float,
                                 fade_len: int = 40):
    """Legacy aperiodicity mask (magphase.py:1979-1996)."""
    v_voi = jnp.asarray(v_voi)
    mvf_bin = int(np.round(mvf * nFFT / float(fs)))
    v_ap = 1.0 - jnp.clip(v_voi, 0, 1)
    m = jnp.tile(v_ap[:, None], (1, mvf_bin))
    ramp = jnp.asarray(np.linspace(1, 0, fade_len))
    m = 1.0 - m
    m = m.at[:, -fade_len:].mul(ramp[None, :])
    m = 1.0 - m
    half = nFFT // 2 + 1
    return jnp.concatenate(
        [m, jnp.ones((v_voi.shape[0], half - mvf_bin), m.dtype)], axis=1)


def estim_ap_mask_from_ph_data(m_mask_ref, nFFT: int, fs: int, mvf: float):
    """Legacy aperiodicity mask estimated from phase-feature RMS
    (magphase.py:2000-2027): per-frame dB RMS clipped to [-28.1, -10.3],
    normalised, faded over 40 bins below the maximum voiced frequency."""
    clip_lo, clip_hi = -28.1, -10.3
    fade_len = 40
    m_ref = jnp.asarray(m_mask_ref)
    v_db = 20.0 * jnp.log10(jnp.sqrt(jnp.mean(m_ref ** 2, axis=1)))
    v_ap = -jnp.clip(v_db, clip_lo, clip_hi)
    v_ap = (v_ap + clip_hi) / float(clip_hi - clip_lo)

    mvf_bin = int(np.round(mvf * nFFT / float(fs)))
    m = jnp.tile(v_ap[:, None], (1, mvf_bin))
    ramp = jnp.asarray(np.linspace(1, 0, fade_len))
    m = 1.0 - m
    m = m.at[:, -fade_len:].mul(ramp[None, :])
    m = 1.0 - m
    half = nFFT // 2 + 1
    return jnp.concatenate(
        [m, jnp.ones((m_ref.shape[0], half - mvf_bin), m.dtype)], axis=1)


def gen_mask_simple(v_voi, nbins: int, cutoff_bin: int):
    """1=deterministic, 0=stochastic (libaudio.py:39-45)."""
    m = jnp.tile(jnp.asarray(v_voi)[:, None], (1, nbins))
    return m.at[:, cutoff_bin:].set(0.0)


def mix_by_mask(m_data_a, m_data_b, m_mask):
    """mask-weighted mix: 1 -> a, 0 -> b (libaudio.py:49-57)."""
    m_mask = jnp.asarray(m_mask)
    return m_mask * jnp.asarray(m_data_a) + (1 - m_mask) * jnp.asarray(m_data_b)


def frame_shift(v_frm, shift: int, out_len: int) -> np.ndarray:
    """Place a frame at offset ``shift`` in a zero buffer
    (libaudio.py:137-140)."""
    v_frm = np.asarray(v_frm)
    out = np.zeros(out_len, v_frm.dtype)
    out[shift:shift + len(v_frm)] = v_frm
    return out
