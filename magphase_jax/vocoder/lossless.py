"""Lossless pitch-synchronous analysis / synthesis (the bit-matching path).

Reference call stacks (SURVEY.md 3.1):
  analysis:  magphase.py:2869 analysis_lossless ->
             analysis_with_del_comp_from_pm (266-334) ->
             compute_lossless_feats (457-476)
  synthesis: magphase.py:1759 synthesis_from_lossless -> ola (34-62)

Device design: the ragged per-frame loops become one gather + one batched rfft
(analysis) and one batched irfft + one scatter-add (synthesis); all heavy ops
jit-compiled with static shapes, host wrappers handle bucketing/padding.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MagPhaseConfig
from ..core import framing
from ..core.windows import HANNING
from ..io import est as est_io
from ..io import wav as wav_io
from ..io.featfile import write_featfile
from ..utils.padding import FRM_STEP, bucket, bucket_signal, pad_to

_f32 = jnp.float32


# ---------------------------------------------------------------------------
# jitted kernels

def analysis_core_batch(sig, pm, nfrms, n_sig, voi, *, fft_len: int,
                        fs: int):
    """Batched pitch-sync windowing + delay compensation + rfft + lossless
    feats.  sig (B,S), pm/voi (B,F), nfrms/n_sig (B,).

    Equivalent to analysis_with_del_comp_from_pm (magphase.py:266-334) +
    compute_lossless_feats (magphase.py:457-476).
    Returns (mag, real, imag, f0, shift) with (B, F, ...) shapes.
    """
    frames, L, R, valid = framing.pitch_sync_frames_batch(
        sig, pm, nfrms, n_sig, fft_len, win_family=HANNING)
    spec = jnp.fft.rfft(frames)

    m_mag = jnp.abs(spec)
    m_div = jnp.where(m_mag == 0.0, 1.0, m_mag)
    m_real = jnp.where(m_mag == 0.0, 0.0, spec.real / m_div)
    m_imag = jnp.where(m_mag == 0.0, 0.0, spec.imag / m_div)

    v_shift = L
    v_f0 = jnp.where(valid & (v_shift > 0),
                     voi * fs / jnp.maximum(v_shift, 1).astype(m_mag.dtype),
                     0.0)
    return m_mag, m_real, m_imag, v_f0, v_shift


def synthesis_core_batch(m_mag, m_real, m_imag, pm, nfrms, *, fft_len: int,
                         out_len_max: int):
    """Batched phasor -> irfft -> fftshift -> centred OLA
    (magphase.py:1759-1776 + ola 34-62).  Inputs (B, F, H) / (B, F)."""
    m_ph = m_real + 1j * m_imag
    m_ph_mag = jnp.abs(m_ph)
    m_ph_mag = jnp.where(m_ph_mag == 0.0, 1.0, m_ph_mag)
    m_fft = m_mag * m_ph / m_ph_mag
    # reference's add_hermitian_half('complex') zeroes imag at DC/Nyquist
    m_fft = m_fft.at[..., 0].set(m_fft[..., 0].real + 0j)
    m_fft = m_fft.at[..., -1].set(m_fft[..., -1].real + 0j)
    # fftshift folded into the spectrum: roll by N/2 <=> (-1)^k modulation
    alt = (1.0 - 2.0 * (jnp.arange(m_fft.shape[-1]) % 2)).astype(m_mag.dtype)
    m_frm = jnp.fft.irfft(m_fft * alt, n=fft_len)
    return framing.ola_centered_batch(m_frm, pm, nfrms, out_len_max)


@functools.partial(jax.jit, static_argnames=("fft_len", "fs"))
def _analysis_kernel(sig, pm, nfrms, n_sig, voi, *, fft_len: int, fs: int):
    """Single-utterance wrapper over analysis_core_batch."""
    outs = analysis_core_batch(sig[None], pm[None], nfrms[None],
                               n_sig[None], voi[None], fft_len=fft_len,
                               fs=fs)
    return tuple(o[0] for o in outs)


@functools.partial(jax.jit, static_argnames=("fft_len", "fs"))
def _analysis_type2_kernel(sig, pm, nfrms, n_sig, voi, *, fft_len: int,
                           fs: int):
    """analysis_with_del_comp_from_pm_type2 (magphase.py:182-260): the
    standard analysis plus a per-frame gain — voiced: max |first half of the
    delay-compensated frame| (244-246); unvoiced: std over the windowed
    ragged frame (247-249, computed from padded-frame sums, zero padding
    contributes nothing)."""
    frames, L, R, valid = framing.pitch_sync_frames_batch(
        sig[None], pm[None], nfrms[None], n_sig[None], fft_len,
        win_family=HANNING)
    frames, L, R, valid = frames[0], L[0], R[0], valid[0]
    h = fft_len // 2 + 1
    spec = jnp.fft.rfft(frames)    # native: see analysis_core_batch

    m_mag = jnp.abs(spec)
    m_div = jnp.where(m_mag == 0.0, 1.0, m_mag)
    m_real = jnp.where(m_mag == 0.0, 0.0, spec.real / m_div)
    m_imag = jnp.where(m_mag == 0.0, 0.0, spec.imag / m_div)

    gain_voi = jnp.max(jnp.abs(frames[:, :h]), axis=1)
    n = jnp.maximum(L + R + 1, 1).astype(frames.dtype)
    s1 = jnp.sum(frames, axis=1)
    s2 = jnp.sum(frames ** 2, axis=1)
    var = jnp.maximum(s2 / n - (s1 / n) ** 2, 0.0)
    v_gain = jnp.where(voi > 0, gain_voi, jnp.sqrt(var))
    v_gain = jnp.where(valid, v_gain, 0.0)
    return m_mag, m_real, m_imag, L, v_gain


def analysis_with_del_comp_from_pm_type2(v_in_sig: np.ndarray, fs: int,
                                         v_pm_smpls: np.ndarray,
                                         v_voi: np.ndarray,
                                         fft_len: int | None = None):
    """magphase.py:182-260 (nwin_per_pitch_period=0.5, the original design).

    Returns (m_mag, m_real, m_imag, v_f0, v_shift, v_gain) as numpy.
    """
    cfg = MagPhaseConfig(fs=fs) if fft_len is None else \
        MagPhaseConfig(fs=fs, fft_len=fft_len)
    fft_len = cfg.fft_len

    pm = np.asarray(np.round(v_pm_smpls), dtype=np.int64)
    nfrms = pm.shape[0]
    n_sig = v_in_sig.shape[0]
    F = bucket(nfrms, FRM_STEP)
    S = bucket_signal(n_sig)

    mag, real, imag, shift, gain = _analysis_type2_kernel(
        jnp.asarray(pad_to(np.asarray(v_in_sig, np.float32), S)),
        jnp.asarray(pad_to(pm.astype(np.int32), F)),
        jnp.int32(nfrms), jnp.int32(n_sig),
        jnp.asarray(pad_to(np.asarray(v_voi, np.float32), F)),
        fft_len=fft_len, fs=fs)
    mag, real, imag, shift, gain = jax.device_get(
        (mag, real, imag, shift, gain))
    shift = shift[:nfrms].astype(np.int64)
    v_f0 = np.asarray(v_voi, np.float64)[:nfrms] * fs / shift.astype(np.float64)
    return (mag[:nfrms].astype(np.float64), real[:nfrms].astype(np.float64),
            imag[:nfrms].astype(np.float64), v_f0, shift,
            gain[:nfrms].astype(np.float64))


@functools.partial(jax.jit, static_argnames=("fft_len", "out_len_max"))
def _synthesis_kernel(m_mag, m_real, m_imag, pm, nfrms, *, fft_len: int,
                      out_len_max: int):
    """Single-utterance wrapper over synthesis_core_batch."""
    return synthesis_core_batch(m_mag[None], m_real[None], m_imag[None],
                                pm[None], nfrms[None], fft_len=fft_len,
                                out_len_max=out_len_max)[0]


# ---------------------------------------------------------------------------
# host-side API (reference-compatible signatures, numpy in/out)

def densify_pitch_marks(v_pm_smpls: np.ndarray,
                        nwin_per_pitch_period: float,
                        v_voi: np.ndarray | None = None):
    """Intermediate-epoch densification (magphase.py:280-288).

    For nwin_per_pitch_period >= 1, each pitch period [pm[i], pm[i+1]) is
    subdivided into n_eps = int(nwin * 2) equal float steps; the new mark
    train is [pm0, pm0+s0, ..., pm0+(n_eps-1)s0, pm1, ...] — the final
    original mark is NOT emitted (the reference flattens the (n_eps, n-1)
    step matrix column-major and never appends pm[-1]).  Positions stay
    float; rounding happens in the windowing (magphase.py:78).

    Returns the densified marks, plus voicing repeated per sub-mark (each
    sub-window anchored in period i inherits voi[i]) when ``v_voi`` given.
    """
    v_pm = np.asarray(v_pm_smpls, np.float64)
    if nwin_per_pitch_period == 0.5:        # original design
        return (v_pm, None if v_voi is None else np.asarray(v_voi))
    if nwin_per_pitch_period < 1.0:
        raise ValueError("nwin_per_pitch_period must be 0.5 or >= 1.0 "
                         "(magphase.py:277-288)")
    n_eps = int(nwin_per_pitch_period * 2)
    v_step = np.diff(v_pm) / float(n_eps)
    m_step = np.tile(v_step, (n_eps, 1))
    m_step = m_step * np.arange(n_eps)[:, None]
    m_step = m_step + v_pm[:-1]
    pm_defi = m_step.flatten(order="F")
    if v_voi is None:
        return pm_defi, None
    voi_defi = np.repeat(np.asarray(v_voi)[:-1], n_eps)
    return pm_defi, voi_defi


def analysis_with_del_comp_from_pm(v_in_sig: np.ndarray, fs: int,
                                   v_pm_smpls: np.ndarray,
                                   v_voi: np.ndarray,
                                   fft_len: int | None = None,
                                   nwin_per_pitch_period: float = 0.5):
    """Run the analysis kernel on one utterance.

    v_pm_smpls: float pitch-mark positions in samples (rounded half-to-even
    here, as lu.round_to_int does at magphase.py:78).
    nwin_per_pitch_period: 0.5 = one window per two periods (the original
    design); >= 1 subdivides each period into int(nwin*2) sub-windows
    (magphase.py:280-288) before the same kernel runs.
    Returns (m_mag, m_real, m_imag, v_f0, v_shift) as numpy, nfrms rows.
    """
    cfg = MagPhaseConfig(fs=fs) if fft_len is None else \
        MagPhaseConfig(fs=fs, fft_len=fft_len)
    fft_len = cfg.fft_len

    if nwin_per_pitch_period != 0.5:
        v_pm_smpls, v_voi = densify_pitch_marks(
            v_pm_smpls, nwin_per_pitch_period, v_voi)
    pm = np.asarray(np.round(v_pm_smpls), dtype=np.int64)
    nfrms = pm.shape[0]
    n_sig = v_in_sig.shape[0]

    F = bucket(nfrms, FRM_STEP)
    S = bucket_signal(n_sig)

    sig_d = jnp.asarray(pad_to(np.asarray(v_in_sig, np.float32), S))
    pm_d = jnp.asarray(pad_to(pm.astype(np.int32), F))
    voi_d = jnp.asarray(pad_to(np.asarray(v_voi, np.float32), F))

    mag, real, imag, _f0, shift = _analysis_kernel(
        sig_d, pm_d, jnp.int32(nfrms), jnp.int32(n_sig), voi_d,
        fft_len=fft_len, fs=fs)
    mag, real, imag, shift = jax.device_get((mag, real, imag, shift))
    shift = shift[:nfrms].astype(np.int64)
    # f0 in float64 on host so the fs/f0 round trip in synthesis recovers the
    # exact integer shifts (shift_to_f0, magphase.py:2198-2207, b_smooth=False)
    v_f0 = np.asarray(v_voi, np.float64)[:nfrms] * fs / shift.astype(np.float64)
    return (mag[:nfrms].astype(np.float64), real[:nfrms].astype(np.float64),
            imag[:nfrms].astype(np.float64), v_f0, shift)


def analysis_lossless(wav_file: str, fft_len: int | None = None,
                      out_dir: str | None = None,
                      est_file: str | None = None,
                      pm_sec: np.ndarray | None = None,
                      voi: np.ndarray | None = None):
    """Primary lossless analysis entry (magphase.py:2869-2906).

    Epochs come from (in priority order) explicit ``pm_sec``/``voi`` arrays,
    a REAPER-format ``est_file``, or the built-in JAX epoch tracker.
    """
    v_sig, fs = wav_io.read_wav(wav_file)

    if pm_sec is None:
        if est_file is not None:
            pm_sec, voi = est_io.read_reaper_est_file(
                est_file, check_len_smpls=len(v_sig), fs=fs)
        else:
            from .. import epochs
            pm_sec, voi = epochs.extract_epochs(v_sig, fs)

    v_pm_smpls = np.asarray(pm_sec) * fs
    m_mag, m_real, m_imag, v_f0, v_shift = analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm_smpls, np.asarray(voi), fft_len=fft_len)

    if isinstance(out_dir, str):
        import os
        file_id = os.path.basename(wav_file).split(".")[0]
        write_featfile(m_mag, out_dir, file_id + ".mag")
        write_featfile(m_real, out_dir, file_id + ".real")
        write_featfile(m_imag, out_dir, file_id + ".imag")
        write_featfile(v_f0, out_dir, file_id + ".f0")
        write_featfile(v_shift, out_dir, file_id + ".shift")
        return None

    return m_mag, m_real, m_imag, v_f0, fs, v_shift


def f0_to_shift(v_f0_in: np.ndarray, fs: int,
                unv_frm_rate_ms: float = 5.0) -> np.ndarray:
    """magphase.py:2210-2215 — single implementation in framerate.py."""
    from .framerate import f0_to_shift_np
    return f0_to_shift_np(v_f0_in, fs, unv_frm_rate_ms)


def shift_to_pm(v_shift: np.ndarray) -> np.ndarray:
    return np.cumsum(v_shift)


def pm_to_shift(v_pm: np.ndarray) -> np.ndarray:
    return np.diff(np.hstack((0, v_pm)))


def synthesis_with_del_comp(m_sp: np.ndarray, m_ph: np.ndarray,
                            v_shift: np.ndarray,
                            win_flat_to_len: float = 1.0) -> np.ndarray:
    """Legacy magnitude+phase OLA synthesis (magphase.py:371-419).

    The reference's default ``win_flat_to_len=0.3`` branch calls
    ``la.gen_wider_window``, which does not exist in its tree — that path
    has always raised NameError and is excluded from the capability
    surface (SURVEY.md §7 "dead/broken reference paths").  Only the
    no-window-correction path (win_flat_to_len >= 1) is reproducible:
    frames 0..n-2 overlap-added centred at their pitch marks, output
    trimmed by fft_len/2 - shift[0] leading samples.
    """
    if win_flat_to_len < 1:
        raise NotImplementedError(
            "win_flat_to_len < 1 invokes la.gen_wider_window, which is "
            "undefined in the reference (magphase.py:403) — dead code.")
    v_shift = np.round(np.asarray(v_shift)).astype(np.int64)
    m_sp = np.asarray(m_sp, np.float64)
    m_ph = np.asarray(m_ph, np.float64)
    nfrms, h = m_sp.shape
    fft_len = 2 * (h - 1)
    v_pm = np.cumsum(v_shift)
    out_len = int(v_pm[-1] + fft_len - (fft_len // 2 - v_shift[0]))

    # the reference mirrors the phase via add_hermitian_half('phase'),
    # which zeroes DC and Nyquist (libaudio.py:375-377) before the ifft
    m_ph = m_ph.copy()
    m_ph[:, 0] = 0.0
    m_ph[:, -1] = 0.0

    F = bucket(nfrms, FRM_STEP)
    O = bucket_signal(out_len)
    spec = (m_sp * np.exp(1j * m_ph)).astype(np.complex64)
    m_frm = np.fft.irfft(spec, n=fft_len).astype(np.float32)
    m_frm = np.roll(m_frm, fft_len // 2, axis=1)      # fftshift (even N)
    # the reference's loop adds frames 0..nfrms-2 only (magphase.py:396-398)
    buf = framing.ola_centered_batch(
        jnp.asarray(pad_to(m_frm, F))[None],
        jnp.asarray(pad_to(v_pm.astype(np.int32), F))[None],
        jnp.asarray([nfrms - 1], jnp.int32), O)[0]
    return np.asarray(jax.device_get(buf)[:out_len], np.float64)


def synthesis_from_lossless(m_mag: np.ndarray, m_real: np.ndarray,
                            m_imag: np.ndarray, v_f0: np.ndarray,
                            fs: int) -> np.ndarray:
    """Lossless resynthesis (magphase.py:1759-1776): deterministic, the
    bit-matching target."""
    nfrms, h = m_mag.shape
    fft_len = 2 * (h - 1)

    v_shift = f0_to_shift(v_f0, fs)
    v_pm = np.cumsum(v_shift).astype(np.int64)   # ola() casts pm to int
    v_shift_i = pm_to_shift(v_pm)
    out_len = int(v_pm[-1] + v_shift_i[-1] + 1)

    F = bucket(nfrms, FRM_STEP)
    O = bucket_signal(out_len)

    mag_d = jnp.asarray(pad_to(m_mag.astype(np.float32), F))
    real_d = jnp.asarray(pad_to(m_real.astype(np.float32), F))
    imag_d = jnp.asarray(pad_to(m_imag.astype(np.float32), F))
    pm_d = jnp.asarray(pad_to(v_pm.astype(np.int32), F))

    buf = _synthesis_kernel(mag_d, real_d, imag_d, pm_d, jnp.int32(nfrms),
                            fft_len=fft_len, out_len_max=O)
    return np.asarray(jax.device_get(buf)[:out_len], dtype=np.float64)
