"""Compressed (low-dimensional) analysis and synthesis — the acoustic-model
feature path.

Reference live API (SURVEY.md 2.2):
  format_for_modelling          magphase.py:2490-2544
  analysis_compressed           magphase.py:2947-2988
  analysis_for_acoustic_modelling magphase.py:2992-3022
  phase_uncompress_type1_mcep   magphase.py:1219-1235
  synthesis_from_compressed     magphase.py:825-997
  synthesis_from_acoustic_modelling magphase.py:3229-3275

All SPTK subprocess hops of the reference (3 x mcep per utterance at
analysis; mel-unwarps at synthesis) are on-device matmuls here
(core/melcep.py).  Synthesis noise is keyed jax.random instead of the
reference's unseeded np.random (magphase.py:883) — deterministic under an
explicit PRNG key; the per-frame gain normalisation (magphase.py:900-906)
makes the output statistically equivalent for any key.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (MagPhaseConfig, define_alpha, define_crossfade_params,
                      define_fft_len)
from ..core import framing, melcep
from ..core.filters import (butter_highpass_coeffs, butter_highpass_sos,
                            sos_freq_response_rfft)
from ..core.interp import extend_nearest_coeffs, interp_linear_axis0
from ..core.spectral import (build_mel_curve, crossfade_down_win_np, db,
                             f0_to_lf0, mel_curve_np, protected_log,
                             build_min_phase_from_mag_spec)
from ..core.windows import HANNING, VOI_NOISE
from ..io import wav as wav_io
from ..io.featfile import read_binfile, write_featfile
from ..utils.padding import (FRM_STEP, bucket, bucket_signal,
                             pad_rows, pad_to)
from . import framerate, lossless
from .postfilter import post_filter, post_filter_merlin


def get_num_full_mel_coeffs_from_num_phase_coeffs(freq_hz: float,
                                                  phase_dim: int,
                                                  alpha: float,
                                                  fs: int) -> int:
    """Invert the mel curve: full-band mel coefficient count such that
    ``phase_dim`` coefficients reach ``freq_hz`` (magphase.py:2479-2487)."""
    crsf_cw = 2 * np.pi * freq_hz / float(fs)
    cf_mel = np.arctan((1 - alpha ** 2) * np.sin(crsf_cw)
                       / ((1 + alpha ** 2) * np.cos(crsf_cw) - 2 * alpha))
    if cf_mel < 0:
        cf_mel += np.pi
    return int(np.round(1 + (np.pi * (phase_dim - 1) / float(cf_mel))))


def synthesis_fft_len(fft_len: int, max_framelen: int) -> int:
    """Adaptive synthesis FFT size: the smallest power-of-2 that contains
    every pitch-sync frame (longest adjacent shift pair + 1), floored at
    1024 and capped at the nominal ``fft_len``.

    The reference synthesises at the ANALYSIS fft length (4096 @ 48 kHz,
    magphase.py:833), but the synthesis frame support is bounded by two
    pitch periods — the mel-unwarped envelope is smooth, so sampling the
    spectrum at fewer bins only wraps the far ringing tails of the pulse
    back into the (anti-ringing-windowed) frame.  Measured impact on the
    demo corpus and a 60 Hz worst case: <=0.09 dB mel distortion,
    corr > 0.99999, for ~2x device time and FFT cost.

    Disable with MAGPHASE_SYNTH_FULL_FFT=1 (A/B tool).
    """
    if os.environ.get("MAGPHASE_SYNTH_FULL_FFT"):
        return fft_len
    n = fft_len
    while n // 2 >= 1024 and max_framelen <= n // 2:
        n //= 2
    return n


def max_pitch_sync_framelen(v_shift_i: np.ndarray) -> int:
    """Longest synthesis frame: max over f of L[f]+R[f]+1 with
    L[f]=shift[f], R[f]=shift[f+1] (R[last]=shift[last])."""
    s = np.asarray(v_shift_i, np.int64).reshape(-1)
    if s.shape[0] < 2:
        return int(2 * s.max(initial=1) + 1)
    pairs = s[:-1] + s[1:]
    return int(max(pairs.max(), 2 * s[-1]) + 1)


# ---------------------------------------------------------------------------
# analysis side

@functools.partial(jax.jit, static_argnames=("mag_dim", "phase_dim",
                                             "mag_dim_ph", "alpha",
                                             "alpha_phase",
                                             "b_mag_fbank_mel"))
def _format_kernel(m_mag, m_real, m_imag, v_voi, *, mag_dim: int,
                   phase_dim: int, mag_dim_ph: int, alpha: float,
                   alpha_phase: float, b_mag_fbank_mel: bool = False):
    """Mel-compression of the three spectral streams
    (format_for_modelling, magphase.py:2503-2542)."""
    if b_mag_fbank_mel:   # magphase.py:2504-2505
        from ..core import fbank
        m_mag_mel = fbank.sp_mel_warp_fbank(m_mag, mag_dim, alpha=alpha)
    else:
        m_mag_mel = melcep.sp_mel_warp(m_mag, mag_dim, alpha=alpha,
                                       in_type=3)
    m_mag_mel_log = protected_log(m_mag_mel)

    m_real_mel = melcep.sp_mel_warp(m_real, mag_dim_ph, alpha=alpha_phase,
                                    in_type=2)[:, :phase_dim]
    m_imag_mel = melcep.sp_mel_warp(m_imag, mag_dim_ph, alpha=alpha_phase,
                                    in_type=2)[:, :phase_dim]
    m_real_mel = jnp.clip(m_real_mel * v_voi[:, None], -1.0, 1.0)
    m_imag_mel = jnp.clip(m_imag_mel * v_voi[:, None], -1.0, 1.0)
    return m_mag_mel_log, m_real_mel, m_imag_mel


def format_for_modelling(m_mag, m_real, m_imag, v_f0, fs: int,
                         mag_dim: int = 60, phase_dim: int = 45,
                         b_mag_fbank_mel: bool = False,
                         alpha_phase: float | None = None):
    """magphase.py:2490-2544.  numpy in/out; mel warps on device."""
    alpha = define_alpha(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    crsf_cf, _ = define_crossfade_params(fs)
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        crsf_cf, phase_dim, alpha_phase, fs)

    # f0 -> smoothed lf0, host-side float64 (magphase.py:2499-2501)
    from scipy import signal as sp_signal
    v_voi = (np.asarray(v_f0) > 0).astype(np.float64)
    v_f0_smth = v_voi * sp_signal.medfilt(np.asarray(v_f0, np.float64))
    with np.errstate(divide="ignore"):
        v_lf0_smth = np.log(np.maximum(v_f0_smth, 0))
    v_lf0_smth[~np.isfinite(v_lf0_smth)] = -1.0e10   # la.f0_to_lf0 MAGIC

    nfrms = m_mag.shape[0]
    F = bucket(nfrms, FRM_STEP)
    mag_d = jnp.asarray(pad_to(np.asarray(m_mag, np.float32), F))
    real_d = jnp.asarray(pad_to(np.asarray(m_real, np.float32), F))
    imag_d = jnp.asarray(pad_to(np.asarray(m_imag, np.float32), F))
    voi_d = jnp.asarray(pad_to(v_voi.astype(np.float32), F))

    mml, mrm, mim = _format_kernel(mag_d, real_d, imag_d, voi_d,
                                   mag_dim=mag_dim, phase_dim=phase_dim,
                                   mag_dim_ph=mag_dim_ph, alpha=alpha,
                                   alpha_phase=alpha_phase,
                                   b_mag_fbank_mel=b_mag_fbank_mel)
    mml, mrm, mim = jax.device_get((mml, mrm, mim))
    return (mml[:nfrms].astype(np.float64), mrm[:nfrms].astype(np.float64),
            mim[:nfrms].astype(np.float64), v_lf0_smth)


def analysis_compressed(wav_file: str, fft_len: int | None = None,
                        mag_dim: int = 60, phase_dim: int = 10,
                        b_const_rate: bool = False,
                        b_mag_fbank_mel: bool = False,
                        alpha_phase: float | None = None,
                        est_file: str | None = None,
                        pm_sec=None, voi=None):
    """magphase.py:2947-2988.

    ``b_mag_fbank_mel``: compress mag with the filter-bank warp.  The
    reference accepts this flag (magphase.py:2948) but silently drops it
    (format_for_modelling is called without it at 2985) — here it is
    actually forwarded, matching the flag's documented intent."""
    m_mag, m_real, m_imag, v_f0, fs, v_shift = lossless.analysis_lossless(
        wav_file, fft_len=fft_len, est_file=est_file, pm_sec=pm_sec, voi=voi)

    if b_const_rate:
        const_rate_ms = 5.0
        v_pm = np.cumsum(v_shift)
        m_mag = np.asarray(framerate.interp_from_variable_to_const_frm_rate(
            m_mag, v_pm, const_rate_ms, fs))
        m_real = np.asarray(framerate.interp_from_variable_to_const_frm_rate(
            m_real, v_pm, const_rate_ms, fs))
        m_imag = np.asarray(framerate.interp_from_variable_to_const_frm_rate(
            m_imag, v_pm, const_rate_ms, fs))
        # voiced-only f0 interpolation trick (magphase.py:2976-2980)
        vb_voi = v_f0 > 1.0
        v_f0_i = np.asarray(framerate.interp_from_variable_to_const_frm_rate(
            np.r_[v_f0[vb_voi][0], v_f0[vb_voi], v_f0[vb_voi][-1]],
            np.r_[0, v_pm[vb_voi], v_pm[-1]], const_rate_ms, fs)).squeeze()
        v_voi_i = np.asarray(framerate.interp_from_variable_to_const_frm_rate(
            vb_voi.astype(np.float64), v_pm, const_rate_ms, fs)) > 0.5
        v_f0 = v_f0_i * v_voi_i

    m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0 = format_for_modelling(
        m_mag, m_real, m_imag, v_f0, fs, mag_dim=mag_dim,
        phase_dim=phase_dim, b_mag_fbank_mel=b_mag_fbank_mel,
        alpha_phase=alpha_phase)
    fft_len = 2 * (m_mag.shape[1] - 1)
    return m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, v_shift, fs, fft_len


def analysis_for_acoustic_modelling(wav_file: str, out_dir: str,
                                    fft_len: int | None = None,
                                    mag_dim: int = 60, phase_dim: int = 10,
                                    b_const_rate: bool = False,
                                    **kw) -> None:
    """magphase.py:2992-3022 (without reproducing the
    ``alpha_phase=b_mag_fbank_mel`` argument-passing bug at 3010)."""
    (m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, v_shift, fs,
     fft_len) = analysis_compressed(wav_file, fft_len=fft_len,
                                    mag_dim=mag_dim, phase_dim=phase_dim,
                                    b_const_rate=b_const_rate, **kw)
    file_id = os.path.basename(wav_file).split(".")[0]
    write_featfile(m_mag_mel_log, out_dir, file_id + ".mag")
    write_featfile(m_real_mel, out_dir, file_id + ".real")
    write_featfile(m_imag_mel, out_dir, file_id + ".imag")
    write_featfile(v_lf0, out_dir, file_id + ".lf0")
    if not b_const_rate:
        write_featfile(v_shift, out_dir, file_id + ".shift")


# ---------------------------------------------------------------------------
# synthesis side

def phase_uncompress_type1_mcep(m_real_mel, m_imag_mel, alpha: float,
                                fft_len: int, fs: int):
    """magphase.py:1219-1235: nearest-extend phase_dim ->
    mag_dim_for_phase_comp coefficients, then mel-unwarp."""
    ncoeffs_comp = m_real_mel.shape[1]
    crsf_cf = define_crossfade_params(fs)[0]
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        crsf_cf, ncoeffs_comp, alpha, fs)
    h = 1 + fft_len // 2
    m_real_ext = extend_nearest_coeffs(jnp.asarray(m_real_mel), mag_dim_ph)
    m_imag_ext = extend_nearest_coeffs(jnp.asarray(m_imag_mel), mag_dim_ph)
    m_real = melcep.sp_mel_unwarp(m_real_ext, h, alpha=alpha, in_type="log")
    m_imag = melcep.sp_mel_unwarp(m_imag_ext, h, alpha=alpha, in_type="log")
    return m_real, m_imag


@functools.partial(
    jax.jit, static_argnames=("fft_len", "mag_dim_ph", "alpha", "alpha_phase",
                              "b_fbank_mel"))
def _unwarp_kernel(m_mag_mel_log, m_real_mel, m_imag_mel, *, fft_len: int,
                   mag_dim_ph: int, alpha: float, alpha_phase: float,
                   b_fbank_mel: bool = False):
    """Mel-unwarp of the three streams to full resolution
    (magphase.py:850-858).  Accepts float16 inputs (the production paths
    upload quantised features to halve host-link bytes) and computes in
    float32.  ``b_fbank_mel`` selects the filter-bank mag unwarp
    (magphase.py:851-852) instead of the mcep cosine-matrix one."""
    h = fft_len // 2 + 1
    m_mag_mel_log = m_mag_mel_log.astype(jnp.float32)
    m_real_mel = m_real_mel.astype(jnp.float32)
    m_imag_mel = m_imag_mel.astype(jnp.float32)
    if b_fbank_mel:
        from ..core import fbank
        m_mag = jnp.exp(fbank.sp_mel_unwarp_fbank(m_mag_mel_log, h,
                                                  alpha=alpha))
    else:
        m_mag = jnp.exp(melcep.sp_mel_unwarp(m_mag_mel_log, h, alpha=alpha,
                                             in_type="log"))
    m_real_ext = extend_nearest_coeffs(m_real_mel, mag_dim_ph)
    m_imag_ext = extend_nearest_coeffs(m_imag_mel, mag_dim_ph)
    m_real = melcep.sp_mel_unwarp(m_real_ext, h, alpha=alpha_phase,
                                  in_type="log")
    m_imag = melcep.sp_mel_unwarp(m_imag_ext, h, alpha=alpha_phase,
                                  in_type="log")
    return m_mag, m_real, m_imag


def _fmix32(x):
    """murmur3 32-bit finaliser: full avalanche on a uint32 lane."""
    x ^= x >> 16
    x *= jnp.uint32(0x85EBCA6B)
    x ^= x >> 13
    x *= jnp.uint32(0xC2B2AE35)
    x ^= x >> 16
    return x


def hash_noise_at(keys, idx: jnp.ndarray):
    """Stateless white noise in [-1, 1) at absolute sample indices.

    keys (B, 2) uint32; idx (B, ...) integer sample positions.  Sample
    (b, i) depends only on (keys[b], i) — never on batch size, padding, or
    where the index tensor came from — so per-utterance noise is invariant
    to batch bucketing (test_batch_matches_single) AND identical whether
    drawn as a contiguous buffer or evaluated directly at gathered frame
    positions.  Two murmur finaliser rounds with the second key word mixed
    between them give full avalanche from both the index and the key.
    """
    k0 = keys[:, 0].astype(jnp.uint32).reshape(
        (-1,) + (1,) * (idx.ndim - 1))
    k1 = keys[:, 1].astype(jnp.uint32).reshape(
        (-1,) + (1,) * (idx.ndim - 1))
    x = _fmix32(idx.astype(jnp.uint32) ^ k0)
    x = _fmix32(x ^ k1)
    # top 24 bits -> [0, 1) at float32-exact spacing -> [-1, 1)
    return ((x >> 8).astype(jnp.float32) * jnp.float32(2.0 / (1 << 24))
            - jnp.float32(1.0))


def hash_noise_uniform(keys, n: int):
    """(B, 2) uint32 keys -> (B, n) float32 white noise in [-1, 1)."""
    return hash_noise_at(keys, jnp.arange(n, dtype=jnp.uint32)[None, :])


def _noise_frames_direct(keys, pm, nfrms, ns_len, fft_len: int,
                         fam_voiced: int, fam_unvoiced: int, voi, dtype):
    """Windowed pitch-sync NOISE frames computed directly in frame space.

    Because the excitation is a stateless hash of the absolute sample
    index, the (B, ns_len) noise buffer of the reference formulation
    (magphase.py:879-897) never needs to exist: each frame element is
    hash(key, left_lim + q) * win(q), with exactly the geometry of
    core/framing.py:pitch_sync_frames (delay-compensated layout,
    q = (p + L) mod fft_len, index clip to [0, ns_len-1]).  Values are
    bit-identical to framing the buffer; it just skips materialising and
    re-gathering ~(B, 80k) samples through HBM.
    """
    from ..core import framing as F
    from ..core import windows as W
    pm = jnp.clip(pm, 0, ns_len[:, None] - 1)
    left_lim, L, R, valid = F.frame_geometry_batch(pm, nfrms, ns_len)
    p = jnp.arange(fft_len)[None, None, :]
    q = (p + L[..., None]) % fft_len
    framelen = L + R + 1
    in_frame = (q < framelen[..., None]) & valid[..., None]
    idx = jnp.clip(left_lim[..., None] + q, 0, ns_len[:, None, None] - 1)
    vals = hash_noise_at(keys, idx).astype(dtype)
    win = W.asym_win_value_select(q, L[..., None], R[..., None],
                                  voi[..., None], fam_voiced, fam_unvoiced)
    return jnp.where(in_frame, vals * win.astype(dtype), 0.0)


def synthesis_core_batch(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms,
                         ns_len, keys, *, fs: int, fft_len: int,
                         alpha: float, b_voi_ap_win: bool,
                         per_phase_type: str, out_len_max: int,
                         ns_len_max: int, out_hpf: str | None = None):
    """The v2.0 synthesis pipeline from full-resolution spectra
    (magphase.py:872-976), batched over utterances: (B, F, H) spectra,
    (B, F) voicing/pm/shifts, (B,) nfrms/ns_len, (B, 2) PRNG keys.

    pm/shifts are precomputed host-side in float64 (truncation semantics of
    magphase.py:879-880).  Returns the un-trimmed OLA buffers (B, out_len);
    the caller slices per utterance and applies the optional HPF.
    """
    B, F = pm.shape
    h = fft_len // 2 + 1
    dtype = m_mag.dtype
    valid = jnp.arange(F)[None, :] < nfrms[:, None]
    voi = v_voi.astype(bool) & valid
    unv = (~v_voi.astype(bool)) & valid

    # --- periodic/aperiodic mask (872-875): voiced rows get the crossfade
    # (applied further down as per-bin gains selected by voicing)
    crsf_cf, crsf_bw = define_crossfade_params(fs)
    w_down = jnp.asarray(crossfade_down_win_np(crsf_cf, crsf_bw, fs, h),
                         dtype)

    # --- noise generation + pitch-sync windowing (877-897).  The noise
    # stream is the reference's unseeded np.random.uniform made keyed; the
    # draw only needs to be white + deterministic per (key, sample), and —
    # because batches are padded to bucket sizes — independent of batch
    # composition, so utterance i sounds identical whether vocoded alone or
    # inside any batch.  XLA's 'rbg' generator violates that (vmapped
    # RngBitGenerator draws change with batch shape); threefry holds it but
    # burns ~60 ops/sample.  This stateless murmur-style counter hash
    # holds it at ~12 ops/sample (whiteness asserted in
    # tests/test_compressed.py::test_hash_noise_whiteness) — and, being a
    # pure function of the absolute sample index, the windowed noise
    # FRAMES are computed directly in frame space (bit-identical values,
    # no (B, ns_len) buffer materialised and re-gathered through HBM;
    # MAGPHASE_NOISE_BUFFER=1 restores the buffer+gather form for A/B)
    if os.environ.get("MAGPHASE_NOISE_BUFFER"):
        v_ns = hash_noise_uniform(keys, ns_len_max).astype(dtype)
        m_frm_ns, _, _, _ = framing.pitch_sync_frames_batch(
            v_ns, pm, nfrms, ns_len, fft_len,
            win_family=(VOI_NOISE if b_voi_ap_win else HANNING),
            voiced=voi, win_family_unvoiced=HANNING)
    else:
        m_frm_ns = _noise_frames_direct(
            keys, pm, nfrms, ns_len, fft_len,
            (VOI_NOISE if b_voi_ap_win else HANNING), HANNING, voi, dtype)
    m_ns_cmplx = jnp.fft.rfft(m_frm_ns)

    # --- noise gain normalisation (899-906): sqrt(exp(mean(log|NS|_mid^2)))
    m_ns_mag = jnp.abs(m_ns_cmplx)
    log2 = protected_log(m_ns_mag[..., 1:-1]) ** 2

    def _masked_gain(mask):
        cnt = jnp.maximum(jnp.sum(mask, axis=1), 1) * (h - 2)
        s = jnp.sum(jnp.where(mask[..., None], log2, 0.0), axis=(1, 2))
        return jnp.sqrt(jnp.exp(s / cnt))

    gain_voi = _masked_gain(voi)[:, None]
    gain_unv = _masked_gain(unv)[:, None]
    m_ns_cmplx = m_ns_cmplx / jnp.where(
        voi, gain_voi, jnp.where(unv, gain_unv, 1.0))[..., None]

    # --- aperiodic spectrum (908-918)
    m_ap = m_ns_cmplx * m_mag
    v_line_unv = jnp.asarray(
        db(build_mel_curve(alpha, h, amp=3.5) - 3.5, b_inv=True), dtype)
    m_ap = jnp.where(unv[..., None], m_ap * v_line_unv[None, None, :], m_ap)

    # --- periodic spectrum (920-941)
    if per_phase_type == "magphase":
        # mag * (re + j im)/|re + j im| via rsqrt of the squared norm:
        # complex abs lowers to an overflow-safe hypot and the complex-
        # by-real divide to two divides — unneeded here (phasor
        # components are O(1)).  The ph2==0 branch keeps scale = m_mag,
        # exactly the reference's guard-to-1 (magphase.py:926-929): the
        # phasor is (0, 0) there so m_per is 0 either way, a NaN
        # component still propagates through the final multiply, and a
        # subnormal ph2 flushed to zero degrades the same way the
        # flushed hypot did
        ph2 = m_real * m_real + m_imag * m_imag
        scale = m_mag * jnp.where(ph2 > 0.0, jax.lax.rsqrt(ph2), 1.0)
        m_per = jax.lax.complex(m_real * scale, m_imag * scale)
    elif per_phase_type == "linear":
        m_per = m_mag.astype(m_ap.dtype)
    elif per_phase_type == "min_phase":
        m_per = build_min_phase_from_mag_spec(
            m_mag.reshape(B * F, h)).reshape(B, F, h)
    else:
        raise ValueError(per_phase_type)
    v_line_voi = jnp.asarray(db(build_mel_curve(0.6, h, amp=2.0),
                                b_inv=True), dtype)
    m_per = jnp.where(voi[..., None], m_per * v_line_voi[None, None, :],
                      m_per)

    # --- apply masks with sqrt + zero protection (944-952).  The mask is
    # w_down per voiced frame and 0 per unvoiced frame, so mask**0.5 and
    # its protections reduce to PER-BIN constant gains selected by
    # voicing — avoiding two full-size (B, F, h) pow passes
    per_gain = jnp.where(w_down > 0.0, jnp.sqrt(w_down), 0.0)
    ap_gain = jnp.where(w_down < 1.0, jnp.sqrt(1.0 - w_down), 0.0)
    m_per = jnp.where(voi[..., None], m_per * per_gain[None, None, :], 0.0)
    m_ap = jnp.where(voi[..., None], m_ap * ap_gain[None, None, :], m_ap)

    # --- sum + DC/Nyquist protection (954-961)
    m_syn = m_per + m_ap
    m_syn = m_syn.at[..., 0].set(jnp.abs(m_syn[..., 0]) + 0j)
    m_syn = m_syn.at[..., -1].set(jnp.abs(m_syn[..., -1]) + 0j)

    if out_hpf == "spectral":
        # 40 Hz output high-pass (magphase.py:990-995) folded into the
        # frame spectra as a per-bin complex gain: HPF is LTI, so it
        # commutes with the OLA sum; the residual error (per-frame
        # circular wrap + non-commutation with the anti-ringing window)
        # measured quality-NEUTRAL on the demo corpus — copy-synthesis
        # MSD vs natural 7.206 dB spectral vs 7.226 blocked (worst chunk
        # 16.6 vs 16.8), cross-mode piecewise MSD 1.3 dB i.e. well under
        # a noise-key change — and it deletes the blocked FFT-conv pass
        # over the whole output signal.
        hre_np, him_np = sos_freq_response_rfft(
            butter_highpass_sos(4, 40.0, fs), fft_len)
        hre = jnp.asarray(hre_np, dtype)
        him = jnp.asarray(him_np, dtype)
        s_re, s_im = jnp.real(m_syn), jnp.imag(m_syn)
        m_syn = jax.lax.complex(s_re * hre - s_im * him,
                                s_re * him + s_im * hre)

    # --- to time domain (963-965).  The reference's fftshift after the
    # inverse FFT is folded into the spectrum as a (-1)^k sign flip
    # (time shift by N/2 <=> modulation by e^{-i*pi*k}) — one fused
    # elementwise multiply instead of a full-size roll pass
    alt = (1.0 - 2.0 * (jnp.arange(h) % 2)).astype(dtype)
    m_frm = jnp.fft.irfft(m_syn * alt, n=fft_len)

    # --- anti-ringing window (968-973)
    m_frm = jax.vmap(framing.apply_anti_ringing)(m_frm, shifts, nfrms)

    # --- PSOLA overlap-add (976)
    return framing.ola_centered_batch(m_frm, pm, nfrms, out_len_max)


def synthesis_core(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms,
                   ns_len, key, **kw):
    """Single-utterance wrapper over synthesis_core_batch."""
    return synthesis_core_batch(
        m_mag[None], m_real[None], m_imag[None], v_voi[None], pm[None],
        shifts[None], jnp.asarray(nfrms)[None], jnp.asarray(ns_len)[None],
        key[None], **kw)[0]


_synthesis_core_kernel = functools.partial(
    jax.jit,
    static_argnames=("fs", "fft_len", "alpha", "b_voi_ap_win",
                     "per_phase_type", "out_len_max", "ns_len_max",
                     "out_hpf"))(
        synthesis_core)


def synthesis_from_compressed(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                              fs: int, fft_len: int | None = None,
                              b_voi_ap_win: bool = True,
                              b_fbank_mel: bool = False,
                              b_const_rate: bool = False,
                              per_phase_type: str = "magphase",
                              alpha_phase: float | None = None,
                              b_out_hpf: bool = True,
                              key=None) -> np.ndarray:
    """Primary v2.0 synthesis entry (magphase.py:825-997).

    ``b_fbank_mel``: mag was compressed with the filter-bank warp
    (analysis_compressed's ``b_mag_fbank_mel``) — unwarp it through
    sp_mel_unwarp_fbank (magphase.py:851-852) instead of the mcep path."""
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    if key is None:
        key = jax.random.PRNGKey(0)

    m_mag_mel_log = np.asarray(m_mag_mel_log, np.float64)
    m_real_mel = np.atleast_2d(np.asarray(m_real_mel, np.float64))
    m_imag_mel = np.atleast_2d(np.asarray(m_imag_mel, np.float64))
    v_lf0 = np.asarray(v_lf0, np.float64)

    # f0 / voicing / shifts, host float64 (magphase.py:845-848)
    v_f0 = np.exp(v_lf0)
    v_voi = v_f0 > 1.0
    v_shift = framerate.f0_to_shift_np(v_f0, fs)

    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], m_real_mel.shape[1], alpha_phase, fs)

    # const->variable SHIFT conversion is pure host math — hoisted above
    # the unwarp so the adaptive synthesis FFT sees the realised
    # pitch-sync shifts (the spectra are interpolated after the unwarp)
    v_frm_locs = None
    if b_const_rate:
        const_rate_ms = 5.0
        v_shift, v_frm_locs = \
            framerate.get_shifts_and_frm_locs_from_const_shifts(
                v_shift, const_rate_ms, fs)

    # adaptive synthesis FFT (see synthesis_fft_len).  Features upload as
    # float16 (the batched path quantises identically, keeping
    # batch==single parity): mel-log mags/phase coeffs lose ~1e-3
    # relative, far below the mel-compression error.
    fft_syn = synthesis_fft_len(
        fft_len, max_pitch_sync_framelen(framerate.truncate_shifts(v_shift)))

    # --- mel-unwarp on device (850-858)
    Fin = bucket(m_mag_mel_log.shape[0], FRM_STEP)
    m_mag_d, m_real_d, m_imag_d = _unwarp_kernel(
        jnp.asarray(pad_to(m_mag_mel_log.astype(np.float16), Fin)),
        jnp.asarray(pad_to(m_real_mel.astype(np.float16), Fin)),
        jnp.asarray(pad_to(m_imag_mel.astype(np.float16), Fin)),
        fft_len=fft_syn, mag_dim_ph=mag_dim_ph, alpha=alpha,
        alpha_phase=alpha_phase, b_fbank_mel=b_fbank_mel)
    n_in = m_mag_mel_log.shape[0]
    m_mag_d = m_mag_d[:n_in]
    m_real_d = m_real_d[:n_in]
    m_imag_d = m_imag_d[:n_in]

    # --- constant -> variable frame rate on the unwarped spectra (861-870)
    if b_const_rate:
        m_mag_d = framerate.interp_from_const_to_variable_rate(
            m_mag_d, v_frm_locs, const_rate_ms, fs)
        m_real_d = framerate.interp_from_const_to_variable_rate(
            m_real_d, v_frm_locs, const_rate_ms, fs)
        m_imag_d = framerate.interp_from_const_to_variable_rate(
            m_imag_d, v_frm_locs, const_rate_ms, fs)
        v_voi = np.asarray(framerate.interp_from_const_to_variable_rate(
            v_voi.astype(np.float64), v_frm_locs, const_rate_ms, fs)) > 0.5

    nfrms = int(v_shift.shape[0])
    v_shift_i = framerate.truncate_shifts(v_shift)   # truncation (879)
    v_pm = np.cumsum(v_shift_i)                   # shift_to_pm (880)
    ns_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]))
    shift_last = int(v_pm[-1] - v_pm[-2])
    out_len = int(v_pm[-1] + shift_last + 1)

    F = bucket(nfrms, FRM_STEP)
    O = bucket_signal(out_len)
    NS = bucket_signal(ns_len)

    def _pad_rows(x):
        return pad_rows(jnp.asarray(x, jnp.float32), F)

    buf = _synthesis_core_kernel(
        _pad_rows(m_mag_d), _pad_rows(m_real_d), _pad_rows(m_imag_d),
        jnp.asarray(pad_to(v_voi.astype(np.float32), F)),
        jnp.asarray(pad_to(v_pm.astype(np.int32), F)),
        jnp.asarray(pad_to(v_shift_i.astype(np.int32), F)),
        jnp.int32(nfrms), jnp.int32(ns_len), key,
        fs=fs, fft_len=fft_syn, alpha=alpha, b_voi_ap_win=b_voi_ap_win,
        per_phase_type=per_phase_type, out_len_max=O, ns_len_max=NS)

    v_syn = np.asarray(jax.device_get(buf)[:out_len], np.float64)

    if b_out_hpf:
        # 4th-order Butterworth high-pass at 40 Hz (magphase.py:990-995).
        # Host-side float64: the poles sit so close to the unit circle that
        # float32 state recursions are numerically explosive.  This single-
        # utterance entry keeps the exact reference-shaped sequential IIR;
        # the batched device path defaults to the spectral per-frame form
        # (MAGPHASE_HPF_MODE, see synthesis_core_batch) with
        # 'blocked' FFT-convolution as the reference-faithful A/B.
        from scipy import signal as sp_signal
        b, a = butter_highpass_coeffs(4, 40.0, fs)
        v_syn = sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)
    return v_syn


def synthesis_from_acoustic_modelling(in_feats_dir: str, filename_token: str,
                                      out_syn_dir: str, mag_dim: int,
                                      phase_dim: int, fs: int,
                                      fft_len: int | None = None,
                                      pf_type: str = "no",
                                      b_const_rate: bool = False,
                                      key=None) -> None:
    """File-level TTS synthesis entry (magphase.py:3229-3275)."""
    m_mag_mel_log = read_binfile(
        os.path.join(in_feats_dir, filename_token + ".mag"), dim=mag_dim)
    m_real_mel = read_binfile(
        os.path.join(in_feats_dir, filename_token + ".real"), dim=phase_dim)
    m_imag_mel = read_binfile(
        os.path.join(in_feats_dir, filename_token + ".imag"), dim=phase_dim)
    v_lf0 = read_binfile(
        os.path.join(in_feats_dir, filename_token + ".lf0"), dim=1)

    if pf_type == "magphase":
        m_mag_mel_log = np.asarray(post_filter(m_mag_mel_log, fs))
    elif pf_type == "merlin":
        m_mag_mel_log = np.asarray(post_filter_merlin(m_mag_mel_log, fs))
    elif pf_type != "no":
        raise ValueError(pf_type)

    v_syn = synthesis_from_compressed(m_mag_mel_log, m_real_mel, m_imag_mel,
                                      v_lf0, fs, fft_len=fft_len,
                                      b_const_rate=b_const_rate, key=key)
    wav_io.write_audio_file(
        os.path.join(out_syn_dir, filename_token + ".wav"), v_syn, fs)
