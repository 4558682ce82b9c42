"""Post-filters for the compressed (mel log-mag) feature stream.

* ``post_filter`` — MagPhase's own formant post-filter
  (magphase.py:2300-2378).  The reference runs a per-frame, per-bin
  variable-length moving average in Python loops; the average is a fixed
  linear map of the frame vector, so here it is one precomputed
  (mag_dim x mag_dim) matrix product for the whole utterance.

* ``post_filter_merlin`` — Merlin's cepstral-domain post-filter, which the
  reference implements as six SPTK shell pipelines
  (magphase.py:3375-3465).  Here the SPTK stages (freqt / c2acr / mc2b /
  b2mc / vopr / sopr / bcp / merge) are closed-form JAX ops
  (core/melcep.py), so the whole filter is a fused on-device computation.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..core import melcep
from ..core.spectral import rceps, MAGIC


def _pf_defaults(fs: int, mag_dim: int, av_len_at_zero, av_len_at_nyq,
                 boost_at_zero, boost_at_nyq):
    """Sample-rate keyed defaults (magphase.py:2306-2340)."""
    # explicit falsy values (e.g. boost 0.0) must be honoured -> is None
    def d(x, default):
        return default if x is None else x

    if fs == 48000:
        av_len_at_zero = d(av_len_at_zero, int(round(11.0 * (mag_dim / 60.0))))
        av_len_at_nyq = d(av_len_at_nyq, int(round(3.0 * (mag_dim / 60.0))))
        boost_at_zero = d(boost_at_zero, 1.8)
        boost_at_nyq = d(boost_at_nyq, 2.0)
    elif fs == 16000:
        av_len_at_zero = d(av_len_at_zero, int(round(9.0 * (mag_dim / 60.0))))
        av_len_at_nyq = d(av_len_at_nyq, int(round(12.0 * (mag_dim / 60.0))))
        boost_at_zero = d(boost_at_zero, 2.0)
        boost_at_nyq = d(boost_at_nyq, 1.6)
    else:
        if None in (av_len_at_zero, av_len_at_nyq, boost_at_zero, boost_at_nyq):
            raise ValueError(
                "post_filter: only tuned for 16 kHz and 48 kHz; provide "
                "av_len_at_zero/av_len_at_nyq/boost_at_zero/boost_at_nyq.")
    return av_len_at_zero, av_len_at_nyq, boost_at_zero, boost_at_nyq


@functools.lru_cache(maxsize=16)
def _avg_matrix_np(mag_dim: int, av_len_at_zero: int,
                   av_len_at_nyq: int) -> np.ndarray:
    """(mag_dim, mag_dim) matrix A with (A @ v) = the reference's
    variable-length moving average v_ave (magphase.py:2343-2360), including
    the edge pinning v_ave[:nx0]=v_ave[nx0], v_ave[nx_last:]=v_ave[nx_last]."""
    v_nx = np.arange(int(np.floor(av_len_at_zero / 2)),
                     mag_dim - int(np.floor(av_len_at_nyq / 2)))
    v_lens = np.linspace(av_len_at_zero, av_len_at_nyq, v_nx.size)
    v_lens = (2 * np.ceil(v_lens / 2) - 1).astype(int)

    A = np.zeros((mag_dim, mag_dim))
    for nxb, ln in zip(v_nx, v_lens):
        half = ln // 2
        A[nxb, nxb - half:nxb + half + 1] = 1.0 / (2 * half + 1)
    A[:v_nx[0]] = A[v_nx[0]]
    A[v_nx[-1]:] = A[v_nx[-1]]
    return A


def post_filter(m_mag_mel_log, fs: int, av_len_at_zero: int | None = None,
                av_len_at_nyq: int | None = None,
                boost_at_zero: float | None = None,
                boost_at_nyq: float | None = None) -> jnp.ndarray:
    """MagPhase post-filter (magphase.py:2300-2378), fully vectorised."""
    m = jnp.asarray(m_mag_mel_log)
    nfrms, mag_dim = m.shape
    az, an, bz, bn = _pf_defaults(fs, mag_dim, av_len_at_zero, av_len_at_nyq,
                                  boost_at_zero, boost_at_nyq)
    A = jnp.asarray(_avg_matrix_np(mag_dim, az, an), m.dtype)
    m_ave = jnp.matmul(m, A.T, precision="highest")
    v_tilt = jnp.asarray(np.linspace(bz, bn, mag_dim), m.dtype)
    m_enh = (m - m_ave) * v_tilt[None, :] + m_ave
    # endpoints pinned to the unfiltered values (magphase.py:2372-2373)
    m_enh = m_enh.at[:, 0].set(m[:, 0]).at[:, -1].set(m[:, -1])
    return m_enh


def post_filter_dev(m_mag_mel_log, fs: int, av_len_at_zero: int | None = None,
                    av_len_at_nyq: int | None = None,
                    boost_at_zero: float | None = None,
                    boost_at_nyq: float | None = None):
    """Dev copy of the MagPhase post-filter (magphase.py:2382-2468).

    Identical defaults and body to ``post_filter``; additionally returns
    the average-subtracted residual matrix (the reference's debug output,
    magphase.py:2468 ``return m_mag_mel_log_enh, m_mag_mel_log_norm``).
    """
    m = jnp.asarray(m_mag_mel_log)
    nfrms, mag_dim = m.shape
    az, an, bz, bn = _pf_defaults(fs, mag_dim, av_len_at_zero, av_len_at_nyq,
                                  boost_at_zero, boost_at_nyq)
    A = jnp.asarray(_avg_matrix_np(mag_dim, az, an), m.dtype)
    m_ave = jnp.matmul(m, A.T, precision="highest")
    m_norm = m - m_ave
    v_tilt = jnp.asarray(np.linspace(bz, bn, mag_dim), m.dtype)
    m_enh = m_norm * v_tilt[None, :] + m_ave
    m_enh = m_enh.at[:, 0].set(m[:, 0]).at[:, -1].set(m[:, -1])
    return m_enh, m_norm


def post_filter_backup_old(m_mag_mel_log) -> jnp.ndarray:
    """Oldest post-filter revision (magphase.py:2254-2297): fixed
    11->3-bin average lengths (scaled by ncoeffs/60) and a hard-coded
    linspace(2, 6) boost tilt, with no sample-rate keying."""
    m = jnp.asarray(m_mag_mel_log)
    nfrms, mag_dim = m.shape
    az = int(np.round(11.0 * mag_dim / 60.0))
    an = int(np.round(3.0 * mag_dim / 60.0))
    A = jnp.asarray(_avg_matrix_np(mag_dim, az, an), m.dtype)
    m_ave = jnp.matmul(m, A.T, precision="highest")
    v_tilt = jnp.asarray(np.linspace(2.0, 6.0, mag_dim), m.dtype)
    m_enh = (m - m_ave) * v_tilt[None, :] + m_ave
    m_enh = m_enh.at[:, 0].set(m[:, 0]).at[:, -1].set(m[:, -1])
    return m_enh


def post_filter_merlin(m_mag_mel_log, fs: int,
                       pf_coef: float = 1.4) -> jnp.ndarray:
    """Merlin cepstral post-filter (magphase.py:3375-3465) as pure JAX.

    Stage-by-stage equivalence with the reference's SPTK pipelines:
      rceps('log','compact')                 -> temp.mcep      (3397-3398)
      lifter w = [1, 1, pf, ..., pf]         -> temp.lift      (3403, 3417)
      c2acr(freqt(mcep, a_net=-alpha))       -> base r0        (3421-3423)
      c2acr(freqt(mcep*w, a_net=-alpha))     -> liftered p_r0  (3425-3428)
      mc2b(mcep*w, alpha)[0]                 -> b0             (3431-3433)
      ln(r0/p_r0)/2 + b0                     -> p_b0           (3436-3438)
      b2mc([p_b0, b[1:]], alpha)             -> mcep_pf        (3441-3444)
      cosmat(alpha=0, 'log')                 -> output         (3449-3450)

    freqt uses net alpha (0 - alpha)/(1 - 0*alpha) = -alpha (SPTK freqt
    ``-a alpha -A 0``), output order fft_len/2 - 1 = 2047.
    """
    m = jnp.asarray(m_mag_mel_log)
    nfrms, ncoeffs = m.shape
    fft_len = 4096
    minph_ord = fft_len // 2 - 1
    from ..config import define_alpha
    alpha = define_alpha(fs)

    m_mcep = rceps(m, in_type="log", out_type="compact")

    w = np.full(ncoeffs, pf_coef)
    w[:2] = 1.0
    m_mcep_w = m_mcep * jnp.asarray(w, m.dtype)[None, :]

    c_lin = melcep.freqt(m_mcep, minph_ord, -alpha)
    c_lin_w = melcep.freqt(m_mcep_w, minph_ord, -alpha)
    r0 = melcep.c2acr_r0(c_lin, fft_len)
    p_r0 = melcep.c2acr_r0(c_lin_w, fft_len)

    m_b = melcep.mc2b(m_mcep_w, alpha)
    b0 = m_b[:, 0]
    p_b0 = jnp.log(r0 / p_r0) / 2.0 + b0

    m_b_pf = m_b.at[:, 0].set(p_b0)
    m_mcep_pf = melcep.b2mc(m_b_pf, alpha)

    out = melcep.mcep_to_sp_cosmat(m_mcep_pf, ncoeffs, alpha=0.0,
                                   out_type="log")
    return jnp.where(jnp.isnan(out), MAGIC, out)   # magphase.py:3453
