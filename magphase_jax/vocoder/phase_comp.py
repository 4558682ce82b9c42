"""Filter-bank phase-compression pipeline (the reference's experimental
"phase_comp" family — kept for capability parity; the reference notes it
"didn't work very well", magphase.py:3028).

  format_for_modelling_phase_comp              magphase.py:2547-2640
  analysis_compressed_type1_with_phase_comp    magphase.py:3024-3092
  synthesis_from_compressed_type1_with_phase_comp  magphase.py:1000-1215

Device design: the per-frame interp1d loops of the reference's fbank warp
become fixed (bins x bands) matrices applied as one matmul on device
(core/fbank.py); the noise synthesis body reuses the jitted type1 kernel
(variants._type1_kernel) with the anti-ringing window enabled.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..core import fbank, melcep
from ..core.filters import butter_highpass_coeffs
from ..io.featfile import write_featfile
from ..utils.padding import FRM_STEP, bucket, pad_to
from . import framerate
from .compressed import format_for_modelling  # noqa: F401 (companion API)
from .variants import _legacy_noise_synthesis, phase_uncompress_fbank


def format_for_modelling_phase_comp(m_mag, m_real, m_imag, v_f0, fs: int,
                                    mag_dim: int = 60, phase_dim: int = 10,
                                    b_mag_fbank_mel: bool = False):
    """magphase.py:2547-2593: mag mel-warp (mcep or fbank) + phase
    compression by a filter bank over the warp curve truncated at the
    crossfade bin.  Unlike format_for_modelling, phase streams are NOT
    voicing-zeroed or clipped (2592-2593)."""
    alpha = define_alpha(fs)

    # f0 -> smoothed lf0 (2558-2560), host-side float64
    from scipy import signal as sp_signal
    v_voi = (np.asarray(v_f0) > 0).astype(np.float64)
    v_f0_smth = v_voi * sp_signal.medfilt(np.asarray(v_f0, np.float64))
    with np.errstate(divide="ignore"):
        v_lf0_smth = np.log(np.maximum(v_f0_smth, 0))
    v_lf0_smth[~np.isfinite(v_lf0_smth)] = -1.0e10

    nfrms, h = np.asarray(m_mag).shape
    fft_len = 2 * (h - 1)
    crsf_cf, _ = define_crossfade_params(fs)
    bin_cf = int(np.round(crsf_cf * fft_len / float(fs)))   # hz_to_bin

    F = bucket(nfrms, FRM_STEP)
    mag_d = jnp.asarray(pad_to(np.asarray(m_mag, np.float32), F))
    real_d = jnp.asarray(pad_to(np.asarray(m_real, np.float32), F))
    imag_d = jnp.asarray(pad_to(np.asarray(m_imag, np.float32), F))

    if b_mag_fbank_mel:
        m_mag_mel = fbank.sp_mel_warp_fbank(mag_d, mag_dim, alpha=alpha)
    else:
        m_mag_mel = melcep.sp_mel_warp(mag_d, mag_dim, alpha=alpha, in_type=3)
    from ..core.spectral import protected_log
    m_mag_mel_log = protected_log(m_mag_mel)

    m_real_mel = fbank.apply_fbank_curve(real_d, alpha, h, bin_cf, phase_dim)
    m_imag_mel = fbank.apply_fbank_curve(imag_d, alpha, h, bin_cf, phase_dim)

    mml, mrm, mim = jax.device_get((m_mag_mel_log, m_real_mel, m_imag_mel))
    return (mml[:nfrms].astype(np.float64), mrm[:nfrms].astype(np.float64),
            mim[:nfrms].astype(np.float64), v_lf0_smth)


def analysis_compressed_type1_with_phase_comp(
        wav_file: str, fft_len: int | None = None,
        out_dir: str | None = None, mag_dim: int = 60, phase_dim: int = 10,
        b_const_rate: bool = False, b_mag_fbank_mel: bool = False, **kw):
    """magphase.py:3024-3092."""
    from .lossless import analysis_lossless
    m_mag, m_real, m_imag, v_f0, fs, v_shift = analysis_lossless(
        wav_file, fft_len=fft_len, **kw)

    if b_const_rate:   # 3040-3052
        v_pm_smpls = np.cumsum(v_shift)
        m_mag = framerate.interp_from_variable_to_const_frm_rate(
            m_mag, v_pm_smpls, 5.0, fs)
        m_real = framerate.interp_from_variable_to_const_frm_rate(
            m_real, v_pm_smpls, 5.0, fs)
        m_imag = framerate.interp_from_variable_to_const_frm_rate(
            m_imag, v_pm_smpls, 5.0, fs)
        v_f0, _ = _interp_f0_const_rate(v_f0, v_pm_smpls, 5.0, fs)

    mml, mrm, mim, v_lf0 = format_for_modelling_phase_comp(
        m_mag, m_real, m_imag, v_f0, fs, mag_dim=mag_dim,
        phase_dim=phase_dim, b_mag_fbank_mel=b_mag_fbank_mel)

    fft_len = 2 * (m_mag.shape[1] - 1)
    if isinstance(out_dir, str):   # 3082-3090
        file_id = os.path.basename(wav_file).split(".")[0]
        write_featfile(mml, out_dir, file_id + ".mag")
        write_featfile(mrm, out_dir, file_id + ".real")
        write_featfile(mim, out_dir, file_id + ".imag")
        write_featfile(v_lf0, out_dir, file_id + ".lf0")
        if not b_const_rate:
            write_featfile(v_shift, out_dir, file_id + ".shift")
        return None
    return mml, mrm, mim, v_lf0, v_shift, fs, fft_len


def _interp_f0_const_rate(v_f0, v_pm_smpls, const_rate_ms, fs):
    """The voiced-only f0 resampling trick shared by the const-rate analysis
    entries (magphase.py:3049-3052 == 2974-2979 == 3138-3141)."""
    v_voi = v_f0 > 1.0
    v_f0_c = framerate.interp_from_variable_to_const_frm_rate(
        np.r_[v_f0[v_voi][0], v_f0[v_voi], v_f0[v_voi][-1]],
        np.r_[0, v_pm_smpls[v_voi], v_pm_smpls[-1]],
        const_rate_ms, fs).squeeze()
    v_voi_c = framerate.interp_from_variable_to_const_frm_rate(
        v_voi.astype(np.float64), v_pm_smpls, const_rate_ms, fs) > 0.5
    v_voi_c = np.asarray(v_voi_c).squeeze()
    return v_f0_c * v_voi_c, v_voi_c


def synthesis_from_compressed_type1_with_phase_comp(
        m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, fs: int,
        fft_len: int | None = None, b_voi_ap_win: bool = True,
        b_fbank_mel: bool = False, const_rate_ms: float = -1.0,
        per_phase_type: str = "magphase", key=None) -> np.ndarray:
    """magphase.py:1000-1215: mag unwarp (mcep or fbank), fbank phase
    uncompression, type1 noise synthesis WITH the anti-ringing window
    (1168-1173), Butterworth 40 Hz high-pass (1205-1210)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    crsf_cf, crsf_bw = define_crossfade_params(fs)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    h = fft_len // 2 + 1

    m_mag_mel_log = np.asarray(m_mag_mel_log, np.float64)
    m_real_mel = np.atleast_2d(np.asarray(m_real_mel, np.float64))
    m_imag_mel = np.atleast_2d(np.asarray(m_imag_mel, np.float64))
    v_f0 = np.exp(np.asarray(v_lf0, np.float64))
    v_voi = v_f0 > 1.0
    v_shift = framerate.f0_to_shift_np(v_f0, fs)

    mml_d = jnp.asarray(m_mag_mel_log, jnp.float32)
    if b_fbank_mel:   # 1029-1032
        m_mag = jnp.exp(fbank.sp_mel_unwarp_fbank(mml_d, h, alpha=alpha))
    else:
        m_mag = jnp.exp(melcep.sp_mel_unwarp(mml_d, h, alpha=alpha,
                                             in_type="log"))
    m_real, m_imag = phase_uncompress_fbank(
        m_real_mel.astype(np.float32), m_imag_mel.astype(np.float32),
        crsf_cf, crsf_bw, alpha, fft_len, fs)

    if const_rate_ms > 0:   # 1043-1051
        v_shift, v_locs = framerate.get_shifts_and_frm_locs_from_const_shifts(
            v_shift, const_rate_ms, fs)
        m_mag = framerate.interp_from_const_to_variable_rate(
            m_mag, v_locs, const_rate_ms, fs)
        m_real = framerate.interp_from_const_to_variable_rate(
            m_real, v_locs, const_rate_ms, fs)
        m_imag = framerate.interp_from_const_to_variable_rate(
            m_imag, v_locs, const_rate_ms, fs)
        v_voi = np.asarray(framerate.interp_from_const_to_variable_rate(
            v_voi.astype(np.float64), v_locs, const_rate_ms, fs)) > 0.5

    v_syn = _legacy_noise_synthesis(
        m_mag, m_real, m_imag, v_voi, v_shift, fs, fft_len, alpha,
        b_voi_ap_win, per_phase_type, key, anti_ringing=True)

    # Butterworth 40 Hz HPF (1205-1210)
    from scipy import signal as sp_signal
    b, a = butter_highpass_coeffs(4, 40.0, fs)
    return sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)
