"""Legacy/variant pipelines: type1 and type2 synthesis, type1/type2
analysis, fbank phase compression.

These are the reference's earlier revisions of the compressed vocoder kept
for capability parity (SURVEY.md §2.2):
  synthesis_from_compressed_type1   magphase.py:1253-1421
  synthesis_from_compressed_type2   magphase.py:1452-1606
  analysis_compressed_type1         magphase.py:2908-2942
  analysis_lossless_type2           magphase.py:2793-2866
  analysis_compressed_type2         magphase.py:3123-3196
  phase_uncompress_type1            magphase.py:1238-1250
  phase_uncompress_fbank            magphase.py:798-820
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (define_alpha, define_crossfade_params, define_fft_len)
from ..core import fbank, framing, melcep
from ..core.filters import ellip_highpass_coeffs
from ..core.interp import extend_nearest_coeffs
from ..core.spectral import (build_mel_curve, crossfade_down_win_np, db,
                             protected_log, true_envelope,
                             build_min_phase_from_mag_spec)
from ..core.windows import HANNING, VOI_NOISE
from ..utils.padding import (FRM_STEP, bucket, bucket_signal,
                             pad_rows, pad_to)
from . import framerate, lossless
from .compressed import get_num_full_mel_coeffs_from_num_phase_coeffs


def phase_uncompress_type1(m_real_mel, m_imag_mel, alpha: float,
                           fft_len: int, ncoeffs_mag: int):
    """magphase.py:1238-1250: nearest-extend to ncoeffs_mag then unwarp."""
    h = 1 + fft_len // 2
    m_real_ext = extend_nearest_coeffs(jnp.asarray(m_real_mel), ncoeffs_mag)
    m_imag_ext = extend_nearest_coeffs(jnp.asarray(m_imag_mel), ncoeffs_mag)
    m_real = melcep.sp_mel_unwarp(m_real_ext, h, alpha=alpha, in_type="log")
    m_imag = melcep.sp_mel_unwarp(m_imag_ext, h, alpha=alpha, in_type="log")
    return m_real, m_imag


def phase_uncompress_fbank(m_real_mel, m_imag_mel, crsf_cf: float,
                           crsf_bw: float, alpha: float, fft_len: int,
                           fs: int):
    """magphase.py:798-820: fbank unwarp up to the crossfade bin, constant
    extension to Nyquist."""
    h = 1 + fft_len // 2
    bin_cf = int(np.round(crsf_cf * fft_len / float(fs)))
    m_real_shrt = fbank.unwarp_from_fbank_curve(
        jnp.asarray(m_real_mel), alpha, h, bin_cf)
    m_imag_shrt = fbank.unwarp_from_fbank_curve(
        jnp.asarray(m_imag_mel), alpha, h, bin_cf)
    pad_r = jnp.repeat(m_real_shrt[:, -1:], h - bin_cf, axis=1)
    pad_i = jnp.repeat(m_imag_shrt[:, -1:], h - bin_cf, axis=1)
    return (jnp.concatenate([m_real_shrt, pad_r], axis=1),
            jnp.concatenate([m_imag_shrt, pad_i], axis=1))


def _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, fs,
                 fft_len, b_const_rate_walk):
    """Shared host-side setup for the legacy synthesis variants."""
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    m_mag_mel_log = np.asarray(m_mag_mel_log, np.float64)
    m_real_mel = np.atleast_2d(np.asarray(m_real_mel, np.float64))
    m_imag_mel = np.atleast_2d(np.asarray(m_imag_mel, np.float64))
    v_f0 = np.exp(np.asarray(v_lf0, np.float64))
    v_voi = v_f0 > 1.0
    v_shift = framerate.f0_to_shift_np(v_f0, fs)
    return (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0,
            v_voi, v_shift)


def synthesis_from_compressed_type1(m_mag_mel_log, m_real_mel, m_imag_mel,
                                    v_lf0, fs: int, fft_len: int | None = None,
                                    b_voi_ap_win: bool = True,
                                    b_const_rate: bool = False,
                                    per_phase_type: str = "magphase",
                                    key=None) -> np.ndarray:
    """magphase.py:1253-1421: like the live path but phase extends to
    ncoeffs_mag, no anti-ringing window, and an unconditional elliptic
    60 Hz high-pass."""
    if key is None:
        key = jax.random.PRNGKey(0)
    (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0, v_voi,
     v_shift) = _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                             fs, fft_len, b_const_rate)
    h = fft_len // 2 + 1
    ncoeffs_mag = m_mag_mel_log.shape[1]

    m_mag = jnp.exp(melcep.sp_mel_unwarp(
        jnp.asarray(m_mag_mel_log, jnp.float32), h, alpha=alpha,
        in_type="log"))
    m_real, m_imag = phase_uncompress_type1(
        m_real_mel.astype(np.float32), m_imag_mel.astype(np.float32),
        alpha, fft_len, ncoeffs_mag)

    if b_const_rate:
        v_shift, v_locs = framerate.get_shifts_and_frm_locs_from_const_shifts(
            v_shift, 5.0, fs)
        m_mag = framerate.interp_from_const_to_variable_rate(
            m_mag, v_locs, 5.0, fs)
        m_real = framerate.interp_from_const_to_variable_rate(
            m_real, v_locs, 5.0, fs)
        m_imag = framerate.interp_from_const_to_variable_rate(
            m_imag, v_locs, 5.0, fs)
        v_voi = np.asarray(framerate.interp_from_const_to_variable_rate(
            v_voi.astype(np.float64), v_locs, 5.0, fs)) > 0.5

    v_syn = _legacy_noise_synthesis(
        m_mag, m_real, m_imag, v_voi, v_shift, fs, fft_len, alpha,
        b_voi_ap_win, per_phase_type, key, anti_ringing=False)

    from scipy import signal as sp_signal
    b, a = ellip_highpass_coeffs(4, 0.5, 80.0, 60.0, fs)
    return sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)


def synthesis_from_compressed_type2(m_mag_mel_log, m_real_mel, m_imag_mel,
                                    v_lf0, fs: int, fft_len: int | None = None,
                                    hf_slope_coeff: float = 1.0,
                                    b_voi_ap_win: bool = True,
                                    const_rate_ms: float = -1.0,
                                    key=None) -> np.ndarray:
    """magphase.py:1452-1606: det/ap masks built from mag with an RMS
    noise gain and HF slope enhancement; anti-ringing; elliptic 60 Hz HPF."""
    if key is None:
        key = jax.random.PRNGKey(0)
    (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0, v_voi,
     v_shift) = _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                             fs, fft_len, const_rate_ms > 0)
    h = fft_len // 2 + 1
    ncoeffs_mag = m_mag_mel_log.shape[1]
    crsf_cf, crsf_bw = define_crossfade_params(fs)

    m_mag = jnp.exp(melcep.sp_mel_unwarp(
        jnp.asarray(m_mag_mel_log, jnp.float32), h, alpha=alpha,
        in_type="log"))
    m_real, m_imag = phase_uncompress_type1(
        m_real_mel.astype(np.float32), m_imag_mel.astype(np.float32),
        alpha, fft_len, ncoeffs_mag)

    if const_rate_ms > 0:
        v_shift, v_locs = framerate.get_shifts_and_frm_locs_from_const_shifts(
            v_shift, const_rate_ms, fs)
        m_mag = framerate.interp_from_const_to_variable_rate(
            m_mag, v_locs, const_rate_ms, fs)
        m_real = framerate.interp_from_const_to_variable_rate(
            m_real, v_locs, const_rate_ms, fs)
        m_imag = framerate.interp_from_const_to_variable_rate(
            m_imag, v_locs, const_rate_ms, fs)
        v_voi = np.asarray(framerate.interp_from_const_to_variable_rate(
            (v_f0 > 0).astype(np.float64), v_locs, const_rate_ms,
            fs)) > 0.5

    nfrms = len(v_shift)
    v_shift_i = framerate.truncate_shifts(v_shift)
    v_pm = np.cumsum(v_shift_i)
    ns_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]))
    out_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]) + 1)

    F = bucket(nfrms, FRM_STEP)
    NS = bucket_signal(ns_len)
    O = bucket_signal(out_len)

    def padf(x):
        if not jnp.iscomplexobj(x):
            x = jnp.asarray(x, jnp.float32)
        return pad_rows(x, F)

    m_mag_p = padf(m_mag)
    m_real_p = padf(m_real)
    m_imag_p = padf(m_imag)
    voi_p = jnp.asarray(pad_to(v_voi.astype(np.float32), F))
    pm_p = jnp.asarray(pad_to(v_pm.astype(np.int32), F))
    shifts_p = jnp.asarray(pad_to(v_shift_i.astype(np.int32), F))

    buf = _type2_kernel(m_mag_p, m_real_p, m_imag_p, voi_p, pm_p, shifts_p,
                        jnp.int32(nfrms), jnp.int32(ns_len), key,
                        fs=fs, fft_len=fft_len, alpha=alpha,
                        hf_slope_coeff=hf_slope_coeff,
                        b_voi_ap_win=b_voi_ap_win, out_len_max=O,
                        ns_len_max=NS)
    v_syn = np.asarray(jax.device_get(buf)[:out_len], np.float64)

    from scipy import signal as sp_signal
    b, a = ellip_highpass_coeffs(4, 0.5, 80.0, 60.0, fs)
    return sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)


def _legacy_noise_synthesis(m_mag, m_real, m_imag, v_voi, v_shift, fs,
                            fft_len, alpha, b_voi_ap_win, per_phase_type,
                            key, anti_ringing: bool):
    """Shared body of the type1 pipeline (magphase.py:1311-1412)."""
    nfrms = len(np.asarray(v_voi))
    v_shift_i = framerate.truncate_shifts(v_shift)
    v_pm = np.cumsum(v_shift_i)
    ns_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]))
    out_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]) + 1)

    F = bucket(nfrms, FRM_STEP)
    NS = bucket_signal(ns_len)
    O = bucket_signal(out_len)

    def padf(x):
        return pad_rows(jnp.asarray(x, jnp.float32), F)

    buf = _type1_kernel(padf(m_mag), padf(m_real), padf(m_imag),
                        jnp.asarray(pad_to(
                            np.asarray(v_voi, np.float32), F)),
                        jnp.asarray(pad_to(v_pm.astype(np.int32), F)),
                        jnp.asarray(pad_to(v_shift_i.astype(np.int32), F)),
                        jnp.int32(nfrms), jnp.int32(ns_len), key,
                        fs=fs, fft_len=fft_len, alpha=alpha,
                        b_voi_ap_win=b_voi_ap_win,
                        per_phase_type=per_phase_type, out_len_max=O,
                        ns_len_max=NS, anti_ringing=anti_ringing)
    return np.asarray(jax.device_get(buf)[:out_len], np.float64)


@functools.partial(
    jax.jit, static_argnames=("fs", "fft_len", "alpha", "b_voi_ap_win",
                              "per_phase_type", "out_len_max", "ns_len_max",
                              "anti_ringing"))
def _type1_kernel(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms, ns_len,
                  key, *, fs, fft_len, alpha, b_voi_ap_win, per_phase_type,
                  out_len_max, ns_len_max, anti_ringing=False):
    h = fft_len // 2 + 1
    dtype = m_mag.dtype
    F = pm.shape[0]
    valid = jnp.arange(F) < nfrms
    voi = v_voi.astype(bool) & valid
    unv = (~v_voi.astype(bool)) & valid

    crsf_cf, crsf_bw = define_crossfade_params(fs)
    w_down = jnp.asarray(crossfade_down_win_np(crsf_cf, crsf_bw, fs, h),
                         dtype)
    m_mask = jnp.where(voi[:, None], w_down[None, :], 0.0)

    v_ns = jax.random.uniform(key, (ns_len_max,), dtype=dtype, minval=-1.0,
                              maxval=1.0)
    m_frm_ns, _, _, _ = framing.pitch_sync_frames_batch(
        v_ns[None], pm[None], nfrms[None], ns_len[None], fft_len,
        win_family=(VOI_NOISE if b_voi_ap_win else HANNING),
        voiced=voi[None], win_family_unvoiced=HANNING)
    m_ns = jnp.fft.rfft(m_frm_ns[0])

    m_ns_mag = jnp.abs(m_ns)
    log2 = protected_log(m_ns_mag[:, 1:-1]) ** 2

    def g(mask):
        cnt = jnp.maximum(jnp.sum(mask), 1) * (h - 2)
        return jnp.sqrt(jnp.exp(
            jnp.sum(jnp.where(mask[:, None], log2, 0.0)) / cnt))

    m_ns = m_ns / jnp.where(voi, g(voi), jnp.where(unv, g(unv), 1.0))[:, None]

    m_ap = m_ns * m_mag
    v_line_unv = jnp.asarray(db(build_mel_curve(alpha, h, amp=3.5) - 3.5,
                                b_inv=True), dtype)
    m_ap = jnp.where(unv[:, None], m_ap * v_line_unv[None, :], m_ap)

    if per_phase_type == "magphase":
        m_ph = m_real + 1j * m_imag
        m_ph_mag = jnp.abs(m_ph)
        m_ph_mag = jnp.where(m_ph_mag == 0.0, 1.0, m_ph_mag)
        m_per = m_mag * m_ph / m_ph_mag
    elif per_phase_type == "linear":
        m_per = m_mag.astype(m_ap.dtype)
    else:
        m_per = build_min_phase_from_mag_spec(m_mag)
    v_line_voi = jnp.asarray(db(build_mel_curve(0.6, h, amp=2.0),
                                b_inv=True), dtype)
    m_per = jnp.where(voi[:, None], m_per * v_line_voi[None, :], m_per)

    m_per = m_per * (m_mask ** 0.5)
    m_ap = m_ap * ((1.0 - m_mask) ** 0.5)
    m_per = jnp.where(m_mask == 0.0, 0.0, m_per)
    m_ap = jnp.where(m_mask == 1.0, 0.0, m_ap)

    m_syn = m_per + m_ap
    # type1 has NO abs() DC/Nyquist protection, only the hermitian
    # zeroing of their imaginary parts (magphase.py:1405)
    m_syn = m_syn.at[:, 0].set(m_syn[:, 0].real + 0j)
    m_syn = m_syn.at[:, -1].set(m_syn[:, -1].real + 0j)
    m_frm = jnp.fft.irfft(m_syn, n=fft_len)
    m_frm = jnp.roll(m_frm, fft_len // 2, axis=1)
    if anti_ringing:   # phase-comp variant (magphase.py:1168-1173)
        m_frm = framing.apply_anti_ringing(m_frm, shifts, nfrms)
    return framing.ola_centered_batch(m_frm[None], pm[None], nfrms[None],
                                      out_len_max)[0]


@functools.partial(
    jax.jit, static_argnames=("fs", "fft_len", "alpha", "hf_slope_coeff",
                              "b_voi_ap_win", "out_len_max", "ns_len_max"))
def _type2_kernel(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms, ns_len,
                  key, *, fs, fft_len, alpha, hf_slope_coeff, b_voi_ap_win,
                  out_len_max, ns_len_max):
    """magphase.py:1515-1597."""
    h = fft_len // 2 + 1
    dtype = m_mag.dtype
    F = pm.shape[0]
    valid = jnp.arange(F) < nfrms
    voi = v_voi.astype(bool) & valid
    unv = (~v_voi.astype(bool)) & valid

    crsf_cf, crsf_bw = define_crossfade_params(fs)
    w_down = jnp.asarray(crossfade_down_win_np(crsf_cf, crsf_bw, fs, h),
                         dtype)

    v_ns = jax.random.uniform(key, (ns_len_max,), dtype=dtype, minval=-1.0,
                              maxval=1.0)
    m_frm_ns, _, _, _ = framing.pitch_sync_frames_batch(
        v_ns[None], pm[None], nfrms[None], ns_len[None], fft_len,
        win_family=(VOI_NOISE if b_voi_ap_win else HANNING),
        voiced=voi[None], win_family_unvoiced=HANNING)
    m_ns = jnp.fft.rfft(m_frm_ns[0])

    # AP mask from mag / rms-noise (1536-1548)
    m_ns_mag = jnp.abs(m_ns)
    cnt = jnp.maximum(jnp.sum(valid), 1) * h
    rms_noise = jnp.sqrt(
        jnp.sum(jnp.where(valid[:, None], m_ns_mag ** 2, 0.0)) / cnt)
    m_ap_smth = m_mag / rms_noise
    # voiced rows: crossfade zeros -> m_ap_smth  == (1 - w_down) * m_ap
    m_ap_smth = jnp.where(voi[:, None], m_ap_smth * (1.0 - w_down)[None, :],
                          m_ap_smth)
    v_slope = jnp.asarray(np.linspace(1.0, hf_slope_coeff, h), dtype)
    m_ap_smth = jnp.where(unv[:, None], m_ap_smth * v_slope[None, :],
                          m_ap_smth)

    # det mask (1550-1553): unvoiced zero, voiced crossfade mag -> zeros
    m_det_mask = jnp.where(unv[:, None], 0.0, m_mag)
    m_det_mask = jnp.where(voi[:, None], m_det_mask * w_down[None, :],
                           m_det_mask)

    m_ap_c = m_ap_smth * m_ns
    m_det = m_real + 1j * m_imag
    m_det_abs = jnp.abs(m_det)
    m_det_abs = jnp.where(m_det_abs == 0.0, 1.0, m_det_abs)
    m_det_c = m_det_mask * m_det / m_det_abs

    m_syn = m_ap_c + m_det_c
    m_syn = m_syn.at[:, 0].set(m_syn[:, 0].real + 0j)
    m_syn = m_syn.at[:, -1].set(m_syn[:, -1].real + 0j)
    m_frm = jnp.fft.irfft(m_syn, n=fft_len)
    m_frm = jnp.roll(m_frm, fft_len // 2, axis=1)
    m_frm = framing.apply_anti_ringing(m_frm, shifts, nfrms)
    return framing.ola_centered_batch(m_frm[None], pm[None], nfrms[None],
                                      out_len_max)[0]


@functools.partial(
    jax.jit, static_argnames=("fs", "fft_len", "hf_slope_coeff",
                              "b_voi_ap_win", "per_phase_type",
                              "ns_len_max"))
def _type1_old_masks_kernel(m_mag, m_real, m_imag, v_voi, pm, nfrms, ns_len,
                            key, *, fs, fft_len, hf_slope_coeff,
                            b_voi_ap_win, per_phase_type, ns_len_max):
    """Det/AP complex spectra of the OLD AP-mask formulation
    (magphase.py:675-735): one global RMS noise gain (not split
    voiced/unvoiced as the live path does), AP mask = mag/rms with a
    voiced zeros->mask crossfade and an unvoiced HF slope; det mask = mag
    with a voiced mag->zeros crossfade.  Returns (det, ap, det_mask)."""
    h = fft_len // 2 + 1
    dtype = m_mag.dtype
    F = pm.shape[0]
    valid = jnp.arange(F) < nfrms
    voi = v_voi.astype(bool) & valid
    unv = (~v_voi.astype(bool)) & valid

    crsf_cf, crsf_bw = define_crossfade_params(fs)
    w_down = jnp.asarray(crossfade_down_win_np(crsf_cf, crsf_bw, fs, h),
                         dtype)

    v_ns = jax.random.uniform(key, (ns_len_max,), dtype=dtype, minval=-1.0,
                              maxval=1.0)
    m_frm_ns, _, _, _ = framing.pitch_sync_frames_batch(
        v_ns[None], pm[None], nfrms[None], ns_len[None], fft_len,
        win_family=(VOI_NOISE if b_voi_ap_win else HANNING),
        voiced=voi[None], win_family_unvoiced=HANNING)
    m_ns = jnp.fft.rfft(m_frm_ns[0])

    # one global gain: rms_noise = sqrt(mean |noise|^2) over ALL frames
    # (magphase.py:698) — the later revisions normalise voiced/unvoiced
    # separately in the log domain
    m_ns_mag = jnp.abs(m_ns)
    cnt = jnp.maximum(jnp.sum(valid), 1) * h
    rms_noise = jnp.sqrt(
        jnp.sum(jnp.where(valid[:, None], m_ns_mag ** 2, 0.0)) / cnt)

    m_ap_mask = m_mag / rms_noise
    m_ap_mask = jnp.where(voi[:, None], m_ap_mask * (1.0 - w_down)[None, :],
                          m_ap_mask)
    v_slope = jnp.asarray(np.linspace(1.0, hf_slope_coeff, h), dtype)
    m_ap_mask = jnp.where(unv[:, None], m_ap_mask * v_slope[None, :],
                          m_ap_mask)
    m_ap_c = m_ap_mask * m_ns
    m_ap_c = jnp.where(m_ap_mask == 0.0, 0.0 + 0.0j, m_ap_c)   # 710

    # det mask (713-716): unvoiced zero, voiced crossfade mag -> zeros
    m_det_mask = jnp.where(unv[:, None], 0.0, m_mag)
    m_det_mask = jnp.where(voi[:, None], m_det_mask * w_down[None, :],
                           m_det_mask)

    if per_phase_type == "magphase":
        m_ph = m_real + 1j * m_imag
        m_ph_mag = jnp.abs(m_ph)
        m_ph_mag = jnp.where(m_ph_mag == 0.0, 1.0, m_ph_mag)
        m_det_c = m_det_mask * m_ph / m_ph_mag
    elif per_phase_type == "linear":
        m_det_c = m_det_mask.astype(m_ap_c.dtype)
    else:
        # min_phase: the reference builds the min-phase spectrum of the
        # FULL magnitude without applying the det mask (magphase.py:731-732)
        m_det_c = build_min_phase_from_mag_spec(m_mag)
    m_det_c = jnp.where(m_det_mask == 0.0, 0.0 + 0.0j, m_det_c)   # 735
    m_det_c = jnp.where(valid[:, None], m_det_c, 0.0 + 0.0j)
    m_ap_c = jnp.where(valid[:, None], m_ap_c, 0.0 + 0.0j)
    return m_det_c, m_ap_c, m_det_mask


def _del_comp_roundtrip(spec, mask, fft_len: int):
    """add_hermitian('complex') -> ifft -> fftshift -> fft -> remove
    hermitian, with the mask==0 protection re-applied (the reference's
    un-delay / re-delay steps around the 'det' Griffin-Lim,
    magphase.py:740-744 and 752-756)."""
    spec = spec.at[..., 0].set(spec[..., 0].real + 0j)
    spec = spec.at[..., -1].set(spec[..., -1].real + 0j)
    frames = jnp.fft.irfft(spec, n=fft_len)
    frames = jnp.roll(frames, fft_len // 2, axis=-1)
    out = jnp.fft.rfft(frames)
    return jnp.where(mask == 0.0, 0.0 + 0.0j, out)


# complex arrays never cross the host<->device boundary: download
# (mag, angle) floats instead, and re-upload floats that a kernel
# recombines on device
@functools.partial(jax.jit, static_argnames=("fft_len",))
def _det_roundtrip_mag_angle_kernel(spec, mask, *, fft_len: int):
    out = _del_comp_roundtrip(spec, mask, fft_len)
    return jnp.abs(out), jnp.angle(out)


@functools.partial(jax.jit, static_argnames=("fft_len",))
def _del_comp_roundtrip_from_magphase_kernel(mag, phase, mask, *,
                                             fft_len: int):
    spec = (mag * jnp.exp(1j * phase)).astype(jnp.complex64)
    return _del_comp_roundtrip(spec, mask, fft_len)


@jax.jit
def _syn_mag_kernel(m_syn):
    """|S| with the DC/Nyquist imaginary parts zeroed (the re-analysed
    frame magnitude fed to the 'whole' Griffin-Lim)."""
    m_syn = m_syn.at[:, 0].set(m_syn[:, 0].real + 0j)
    m_syn = m_syn.at[:, -1].set(m_syn[:, -1].real + 0j)
    return jnp.abs(m_syn)


@functools.partial(jax.jit, static_argnames=("fft_len", "out_len_max"))
def _spec_ola_kernel(m_syn, pm, nfrms, *, fft_len: int, out_len_max: int):
    """add_hermitian('complex') -> ifft -> fftshift -> OLA(win=None)
    (magphase.py:762-766)."""
    m_syn = m_syn.at[:, 0].set(m_syn[:, 0].real + 0j)
    m_syn = m_syn.at[:, -1].set(m_syn[:, -1].real + 0j)
    m_frm = jnp.fft.irfft(m_syn, n=fft_len)
    m_frm = jnp.roll(m_frm, fft_len // 2, axis=1)
    return framing.ola_centered_batch(m_frm[None], pm[None], nfrms[None],
                                      out_len_max)[0]


def synthesis_from_compressed_type1_old_with_griffin_lim(
        m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, fs: int,
        fft_len: int | None = None, hf_slope_coeff: float = 1.0,
        b_voi_ap_win: bool = True, b_fbank_mel: bool = False,
        const_rate_ms: float = -1.0, per_phase_type: str = "magphase",
        griff_lim_type: str | None = None,
        griff_lim_init: str = "magphase", key=None) -> np.ndarray:
    """magphase.py:617-794: the old AP-mask synthesis with optional
    Griffin-Lim refinement.

    griff_lim_type: None (disabled), 'det' (refine only the deterministic
    component: 10 GL iterations seeded with its own delay-compensated
    phase, magphase.py:736-757), or 'whole' (re-estimate the whole
    signal's phase with 50 min-phase-seeded GL iterations, 769-771 —
    the reference passes the literal 'min', which matches none of its
    griffin_lim inits and crashes; the evident intent 'min_phase' is
    used here).
    griff_lim_init is accepted for signature parity but, as in the
    reference, never read (both GL branches hardcode their init).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    key, gl_key = jax.random.split(key)
    (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0, v_voi,
     v_shift) = _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                             fs, fft_len, const_rate_ms > 0)
    h = fft_len // 2 + 1
    ncoeffs_mag = m_mag_mel_log.shape[1]

    if b_fbank_mel:   # magphase.py:643-644
        m_mag = jnp.exp(fbank.sp_mel_unwarp_fbank(
            jnp.asarray(m_mag_mel_log, jnp.float32), h, alpha=alpha))
    else:
        m_mag = jnp.exp(melcep.sp_mel_unwarp(
            jnp.asarray(m_mag_mel_log, jnp.float32), h, alpha=alpha,
            in_type="log"))
    m_real, m_imag = phase_uncompress_type1(
        m_real_mel.astype(np.float32), m_imag_mel.astype(np.float32),
        alpha, fft_len, ncoeffs_mag)

    if const_rate_ms > 0:   # 663-673
        v_shift, v_locs = framerate.get_shifts_and_frm_locs_from_const_shifts(
            v_shift, const_rate_ms, fs)
        m_mag = framerate.interp_from_const_to_variable_rate(
            m_mag, v_locs, const_rate_ms, fs)
        m_real = framerate.interp_from_const_to_variable_rate(
            m_real, v_locs, const_rate_ms, fs)
        m_imag = framerate.interp_from_const_to_variable_rate(
            m_imag, v_locs, const_rate_ms, fs)
        v_voi = np.asarray(framerate.interp_from_const_to_variable_rate(
            (v_f0 > 0).astype(np.float64), v_locs, const_rate_ms,
            fs)) > 0.5
        v_f0 = np.where(v_voi, fs / np.maximum(v_shift, 1.0), 0.0)
        v_voi = v_f0 > 1.0   # 683

    nfrms = len(v_shift)
    v_shift_i = framerate.truncate_shifts(v_shift)
    v_pm = np.cumsum(v_shift_i)
    ns_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]))
    out_len = ns_len + 1

    F = bucket(nfrms, FRM_STEP)
    NS = bucket_signal(ns_len)
    O = bucket_signal(out_len)

    def padf(x):
        if not jnp.iscomplexobj(x):
            x = jnp.asarray(x, jnp.float32)
        return pad_rows(x, F)

    pm_p = jnp.asarray(pad_to(v_pm.astype(np.int32), F))
    m_det, m_ap, m_det_mask = _type1_old_masks_kernel(
        padf(m_mag), padf(m_real), padf(m_imag),
        jnp.asarray(pad_to(v_voi.astype(np.float32), F)), pm_p,
        jnp.int32(nfrms), jnp.int32(ns_len), key, fs=fs, fft_len=fft_len,
        hf_slope_coeff=hf_slope_coeff, b_voi_ap_win=b_voi_ap_win,
        per_phase_type=per_phase_type, ns_len_max=NS)

    if griff_lim_type == "det":   # 736-757
        from .griffin_lim import griffin_lim
        d_mag, d_ang = _det_roundtrip_mag_angle_kernel(m_det, m_det_mask,
                                                       fft_len=fft_len)
        m_mag_gl = np.asarray(jax.device_get(d_mag))[:nfrms]
        _sig, m_phase_gl = griffin_lim(
            m_mag_gl, v_shift_i,
            phase_init=np.asarray(jax.device_get(d_ang))[:nfrms],
            niters=10, key=gl_key)
        m_det = _del_comp_roundtrip_from_magphase_kernel(
            pad_rows(jnp.asarray(m_mag_gl, jnp.float32), F),
            pad_rows(jnp.asarray(m_phase_gl, jnp.float32), F),
            m_det_mask, fft_len=fft_len)

    m_syn = m_det + m_ap
    buf = _spec_ola_kernel(m_syn, pm_p, jnp.int32(nfrms), fft_len=fft_len,
                           out_len_max=O)
    v_syn = np.asarray(jax.device_get(buf)[:out_len], np.float64)

    if griff_lim_type == "whole":   # 769-771
        from .griffin_lim import griffin_lim
        # the re-analysed frame magnitude: fftshift only flips the sign of
        # odd bins ((-1)^k for even N), so |fft(fftshift(ifft(herm(S))))|
        # = |S| with the DC/Nyquist imaginary parts zeroed
        syn_mag = np.asarray(jax.device_get(_syn_mag_kernel(m_syn)))[:nfrms]
        v_syn, _ = griffin_lim(syn_mag, v_shift_i,
                               phase_init="min_phase", niters=50)

    from scipy import signal as sp_signal
    b, a = ellip_highpass_coeffs(4, 0.5, 80.0, 60.0, fs)
    return sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)


# ---------------------------------------------------------------------------
# analysis variants

def analysis_compressed_type1(wav_file: str, fft_len: int | None = None,
                              out_dir: str | None = None, mag_dim: int = 60,
                              phase_dim: int = 45,
                              const_rate_ms: float = -1.0, **kw):
    """magphase.py:2908-2942 (const_rate_ms parameterised)."""
    from .compressed import analysis_compressed
    return analysis_compressed(wav_file, fft_len=fft_len, mag_dim=mag_dim,
                               phase_dim=phase_dim,
                               b_const_rate=const_rate_ms > 0, **kw)


def analysis_lossless_type2(wav_file: str, fft_len: int | None = None,
                            est_file: str | None = None, pm_sec=None,
                            voi=None):
    """magphase.py:2793-2866: even/odd pitch-mark interleaved magnitude
    analysis with a true-envelope magnitude, separate phase analysis."""
    from ..io import wav as wav_io
    from ..io import est as est_io
    v_sig, fs = wav_io.read_wav(wav_file)
    if pm_sec is None:
        if est_file is not None:
            pm_sec, voi = est_io.read_reaper_est_file(
                est_file, check_len_smpls=len(v_sig), fs=fs)
        else:
            from .. import epochs
            pm_sec, voi = epochs.extract_epochs(v_sig, fs)
    v_pm = np.asarray(pm_sec) * fs
    voi = np.asarray(voi)

    # even/odd interleave (2806-2816)
    nx_even = np.arange(0, v_pm.size, 2)
    nx_odd = np.arange(1, v_pm.size, 2)
    me = lossless.analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm[nx_even], np.ones(len(nx_even)), fft_len=fft_len)
    mo = lossless.analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm[nx_odd], np.ones(len(nx_odd)), fft_len=fft_len)
    h = me[0].shape[1]
    nfrms = len(nx_even) + len(nx_odd)
    m_mag_long = np.zeros((nfrms, h))
    m_mag_long[nx_even] = me[0]
    m_mag_long[nx_odd] = mo[0]
    m_mag_long = m_mag_long[1:]

    m_mag_env = np.asarray(true_envelope(
        jnp.asarray(m_mag_long, jnp.float32), in_type="abs", ncoeffs=600,
        thres_db=0.1))

    # phase analysis on the full mark set, type2: with per-frame gain
    # (magphase.py:2834-2839)
    mag, real, imag, f0, shift_ph, v_gain = \
        lossless.analysis_with_del_comp_from_pm_type2(
            v_sig, fs, v_pm, voi, fft_len=fft_len)
    # v_shift = la.pm_to_shift(v_pm_smpls[1:]) (magphase.py:2818)
    v_shift = np.diff(np.hstack((0.0, v_pm[1:])))
    return (m_mag_env, real[1:], imag[1:], f0[1:], fs, v_shift,
            v_gain[1:])


def analysis_compressed_type2(wav_file: str, fft_len: int | None = None,
                              out_dir: str | None = None, mag_dim: int = 60,
                              phase_dim: int = 45, b_norm_mag: bool = False,
                              const_rate_ms: float = -1.0, **kw):
    """magphase.py:3123-3196: type2 analysis (true-envelope mag + per-frame
    gain), optional const-rate resampling, format_for_modelling, log-gain
    stream; b_norm_mag folds the per-frame mean of the log-mel magnitude
    into coefficient 0 (3177-3181)."""
    from .compressed import format_for_modelling
    from ..core.spectral import protected_log_np

    (m_mag, m_real, m_imag, v_f0, fs, v_shift,
     v_gain) = analysis_lossless_type2(wav_file, fft_len=fft_len, **kw)

    if const_rate_ms > 0.0:   # 3129-3141
        v_pm_smpls = np.cumsum(v_shift)
        m_mag = framerate.interp_from_variable_to_const_frm_rate(
            m_mag, v_pm_smpls, const_rate_ms, fs)
        m_real = framerate.interp_from_variable_to_const_frm_rate(
            m_real, v_pm_smpls, const_rate_ms, fs)
        m_imag = framerate.interp_from_variable_to_const_frm_rate(
            m_imag, v_pm_smpls, const_rate_ms, fs)
        v_gain = np.asarray(framerate.interp_from_variable_to_const_frm_rate(
            v_gain, v_pm_smpls, const_rate_ms, fs)).squeeze()
        from .phase_comp import _interp_f0_const_rate
        v_f0, _ = _interp_f0_const_rate(v_f0, v_pm_smpls, const_rate_ms, fs)

    mml, mrm, mim, v_lf0 = format_for_modelling(
        m_mag, m_real, m_imag, v_f0, fs, mag_dim=mag_dim,
        phase_dim=phase_dim)
    fft_len_out = 2 * (m_mag.shape[1] - 1)
    v_lgain = protected_log_np(np.asarray(v_gain, np.float64))

    if b_norm_mag:   # 3177-3181
        v_mean = np.mean(mml[:, 1:], axis=1)
        mml = mml - v_mean[:, None]
        v_lgain = v_mean
        mml[:, 0] = v_lgain

    if isinstance(out_dir, str):   # 3184-3194
        import os
        from ..io.featfile import write_featfile
        file_id = os.path.basename(wav_file).split(".")[0]
        write_featfile(mml, out_dir, file_id + ".mag")
        write_featfile(mrm, out_dir, file_id + ".real")
        write_featfile(mim, out_dir, file_id + ".imag")
        write_featfile(v_lf0, out_dir, file_id + ".lf0")
        if const_rate_ms <= 0.0:
            write_featfile(v_shift, out_dir, file_id + ".shift")
        return None
    return mml, mrm, mim, v_lf0, v_shift, fs, fft_len_out, v_lgain


def compute_imag_from_real(start_sign: float, v_real) -> np.ndarray:
    """magphase.py:3094-3120 (experimental, unfinished in the reference):
    reconstruct the imag phase stream from real by choosing, per bin, the
    sign of sqrt(1-real^2) whose first difference best continues the
    previous one.  Sequential recurrence -> lax.scan."""
    v_real = jnp.asarray(v_real, jnp.float32)
    nbins = v_real.shape[0]
    v_mag = jnp.sqrt(jnp.maximum(1.0 - v_real ** 2, 0.0))
    i1 = start_sign * v_mag[1]

    def step(carry, mag_b):
        prev, prev2 = carry
        prev_diff = prev - prev2
        d_pos = mag_b - prev
        d_neg = -mag_b - prev
        take_pos = jnp.abs(d_pos - prev_diff) <= jnp.abs(d_neg - prev_diff)
        cur = jnp.where(take_pos, mag_b, -mag_b)
        return (cur, prev), cur

    _, tail = jax.lax.scan(step, (i1, jnp.float32(0.0)), v_mag[2:nbins])
    out = jnp.concatenate([jnp.zeros(1, jnp.float32), i1[None], tail])
    return np.asarray(jax.device_get(out), np.float64)
