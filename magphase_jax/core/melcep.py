"""Mel-cepstral analysis on device — replaces the SPTK binaries.

The reference shells out to SPTK for every mel-warp:
``sp_to_mcep`` (libaudio.py:575-601) runs ``mcep -a A -m M-1 -l N
-e 1.0E-8 -j 0 -f 0.0 -q TYPE``.  ``-j 0`` sets the *maximum* number of
Newton/UELS iterations to zero, so the SPTK call degenerates to its initial
estimate:

    mcep = freqt( one_sided_cepstrum( log(periodogram + 1e-8) ) )

where the one-sided cepstrum h of log|X| is obtained from the cepstrum cp of
the log *periodogram* (P = log(|X|^2+eps) = 2 log|X|) as
h[0] = cp[0]/2, h[n] = cp[n] (1<=n<f2), h[f2] = cp[f2]/2, and ``freqt`` is
Oppenheim's all-pass frequency transform.

Device formulation: ``freqt`` is linear, so we precompute its
(f2+1, M) matrix once per (m1, m2, alpha) — built by the exact recursion
g = Psi * g_prev with Psi(z~) = (z~^-1 + a)/(1 + a z~^-1) — and the whole
sp->mcep pipeline becomes irfft + one matmul.  No subprocesses, no
temp files, fully batched over frames.

``mcep_to_sp_cosmat`` (libaudio.py:605-631) is already a cosine-matrix
product; we cache the matrix.

The ``-j 0`` reading (max Newton iterations = 0 -> initial estimate only)
is independently restated in tests/oracle/refport.py:mcep_j0/freqt_sptk —
literal sequential ports of SPTK-3.9 ``_mcep.c``/``_freqt.c`` — and
tests/test_ref_parity.py asserts both derivations agree to 5e-6 for all
three ``-q`` input types the reference uses.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .spectral import mel_curve_np


def mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """float32-accurate matmul.  A default-precision float32 matmul may
    run in TF32 on a GPU (about 3 decimal digits), unacceptable for
    spectral transforms; 'highest' asks for full float32."""
    return jnp.matmul(a, b, precision="highest")


# ---------------------------------------------------------------------------
# freqt as a matrix

@functools.lru_cache(maxsize=32)
def freqt_matrix_np(m1: int, m2: int, alpha: float) -> np.ndarray:
    """(m1+1, m2+1) matrix F with freqt(c)[k] = sum_m c[m] * F[m, k].

    Row m holds the order-<=m2 expansion of Psi^m where
    Psi(z~) = (z~^-1 + alpha)/(1 + alpha z~^-1) is z^-1 expressed in the
    warped variable (equivalent to SPTK freqt, _freqt.c).  Multiplication by
    Psi in truncated coefficient space is exact (it is lower triangular).
    """
    F = np.zeros((m1 + 1, m2 + 1))
    F[0, 0] = 1.0
    row = F[0].copy()
    for m in range(1, m1 + 1):
        new = np.empty(m2 + 1)
        # g[k] = f[k-1] + alpha*f[k] - alpha*g[k-1];  g[0] = alpha*f[0]
        new[0] = alpha * row[0]
        for k in range(1, m2 + 1):
            new[k] = row[k - 1] + alpha * (row[k] - new[k - 1])
        F[m] = new
        row = new
    return F


def freqt(m_ceps: jnp.ndarray, m2: int, alpha: float) -> jnp.ndarray:
    """Batched frequency transform: (F, m1+1) -> (F, m2+1)."""
    m1 = m_ceps.shape[1] - 1
    F = jnp.asarray(freqt_matrix_np(m1, m2, alpha),
                    dtype=m_ceps.dtype)
    return mm(m_ceps, F)


# ---------------------------------------------------------------------------
# warped cosine evaluation matrix

@functools.lru_cache(maxsize=32)
def cosmat_np(n_cepcoeffs: int, n_spbins: int, alpha: float) -> np.ndarray:
    """(n_cepcoeffs, n_spbins) matrix  C[k, i] = cos(k * beta_i)  with beta
    the warped frequency of output bin i (libaudio.py:605-619)."""
    v_warp = mel_curve_np(alpha, n_spbins) if alpha != 0.0 else \
        np.linspace(0, np.pi, n_spbins)
    k = np.arange(n_cepcoeffs)[:, None]
    return np.cos(k * v_warp[None, :])


def mcep_to_sp_cosmat(m_mcep: jnp.ndarray, n_spbins: int, alpha: float = 0.77,
                      out_type: str = "abs") -> jnp.ndarray:
    """mcep -> spectrum via cosine matrix (libaudio.py:605-631)."""
    C = jnp.asarray(cosmat_np(m_mcep.shape[1], n_spbins, alpha),
                    dtype=m_mcep.dtype)
    m_sp = mm(m_mcep, C)
    if out_type == "abs":
        return jnp.exp(m_sp)
    if out_type == "db":
        return m_sp * (20.0 / np.log(10.0))
    if out_type == "log":
        return m_sp
    raise ValueError(out_type)


# ---------------------------------------------------------------------------
# SPTK mcep (zero-iteration mode, the reference's exact configuration)

@functools.lru_cache(maxsize=32)
def mcep_matrix_np(f2: int, fft_len: int, n_coeffs: int,
                   alpha: float) -> np.ndarray:
    """(f2+1, n_coeffs) matrix M with mcep = log_periodogram @ M.

    Everything after the log in the -j 0 mcep pipeline is LINEAR in the
    log periodogram P:  cepstrum  cp[t] = sum_k w[k] P[k] cos(2pi k t /
    fft_len)  (w the hermitian fold weights), the one-sided halving at
    t in {0, f2}, and the freqt matmul.  Composing them in float64 host
    numpy removes the per-frame (rows, fft_len)-point inverse FFT the
    direct formulation needs: one fused (rows, f2+1) x (f2+1, n_coeffs)
    matmul replaces it."""
    k = np.arange(f2 + 1, dtype=np.float64)
    t = np.arange(f2 + 1, dtype=np.float64)
    w = np.full(f2 + 1, 2.0 / fft_len)
    w[0] = 1.0 / fft_len
    if 2 * f2 == fft_len:
        w[f2] = 1.0 / fft_len
    A = w[:, None] * np.cos(2.0 * np.pi * np.outer(k, t) / fft_len)
    A[:, 0] *= 0.5                      # one-sided cepstrum halving
    A[:, f2] *= 0.5
    F = freqt_matrix_np(f2, n_coeffs - 1, alpha)
    return (A @ F).astype(np.float32)


def sp_to_mcep(m_sp: jnp.ndarray, n_coeffs: int = 60, alpha: float = 0.77,
               in_type: int = 3, fft_len: int = 0,
               eps: float = 1.0e-8) -> jnp.ndarray:
    """Spectrum -> mel-cepstrum, semantics of ``mcep -a alpha -m n_coeffs-1
    -l fft_len -e 1e-8 -j 0 -f 0.0 -q in_type`` (libaudio.py:575-601).

    in_type: 3 => |f(w)|, 1 => 20log10|f(w)| (dB), 2 => ln|f(w)|.
    m_sp: (F, fft_len/2+1) non-redundant spectrum.

    The cepstrum + one-sided fold + freqt chain is linear in the log
    periodogram, so it runs as ONE cached (f2+1, n_coeffs) matmul
    (mcep_matrix_np) — no inverse FFT.
    """
    f2 = m_sp.shape[1] - 1
    if fft_len == 0:
        fft_len = 2 * f2

    if in_type == 3:
        amp2 = m_sp * m_sp
    elif in_type == 1:
        amp = jnp.power(10.0, m_sp / 20.0)
        amp2 = amp * amp
    elif in_type == 2:
        amp = jnp.exp(m_sp)
        amp2 = amp * amp
    else:
        raise ValueError(f"in_type {in_type} not supported")

    P = jnp.log(amp2 + eps)                          # log periodogram
    M = jnp.asarray(mcep_matrix_np(f2, fft_len, n_coeffs, alpha),
                    dtype=P.dtype)
    return mm(P, M)


# ---------------------------------------------------------------------------
# mel warp / unwarp (the reference's compression round-trip)

def sp_mel_warp(m_sp: jnp.ndarray, nbins_out: int, alpha: float = 0.77,
                in_type: int = 3) -> jnp.ndarray:
    """Compression: sp -> mcep(alpha) -> sample on uniform warped grid
    (libaudio.py:643-661)."""
    m_mcep = sp_to_mcep(m_sp, n_coeffs=nbins_out, alpha=alpha,
                        in_type=in_type)
    out_type = {3: "abs", 1: "db", 2: "log"}[in_type]
    return mcep_to_sp_cosmat(m_mcep, nbins_out, alpha=0.0, out_type=out_type)


def sp_mel_unwarp(m_sp_mel: jnp.ndarray, nbins_out: int, alpha: float = 0.77,
                  in_type: str = "log") -> jnp.ndarray:
    """Decompression: mel spectrum -> compact cepstrum -> warped cosine
    evaluation at nbins_out linear bins (libaudio.py:667-684).

    The doubling range [1:ncoeffs-2] reproduces the reference exactly
    (its hermitian extension of ncoeffs bins has length 2*ncoeffs-2, so the
    last doubled index *should* be ncoeffs-2; the reference stops one
    early — kept for parity since the synthesis path was tuned with it).
    """
    ncoeffs = m_sp_mel.shape[1]
    if in_type == "abs":
        m_sp_mel = jnp.log(m_sp_mel)
    full = jnp.concatenate([m_sp_mel, m_sp_mel[:, -2:0:-1]], axis=1)
    m_mcep = jnp.fft.ifft(full).real
    scale = jnp.ones(m_mcep.shape[1], m_mcep.dtype).at[1:ncoeffs - 2].set(2.0)
    m_mcep = (m_mcep * scale)[:, :ncoeffs]
    return mcep_to_sp_cosmat(m_mcep, nbins_out, alpha=alpha, out_type=in_type)


# ---------------------------------------------------------------------------
# SPTK small tools needed by the Merlin post-filter (magphase.py:3375-3465)

def mc2b(m_mc: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """mel-cepstrum -> MLSA filter coefficients b (SPTK mc2b):
    b[M] = c[M]; b[m] = c[m] - alpha*b[m+1].  Linear -> matrix."""
    M = m_mc.shape[1] - 1
    # b[m] = sum_{j>=m} (-alpha)^(j-m) c[j]
    j = np.arange(M + 1)
    T = np.where(j[None, :] >= j[:, None],
                 (-alpha) ** (j[None, :] - j[:, None]), 0.0)
    return mm(m_mc, jnp.asarray(T.T, dtype=m_mc.dtype))


def b2mc(m_b: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """MLSA b -> mel-cepstrum (SPTK b2mc): c[m] = b[m] + alpha*b[m+1]."""
    up = jnp.concatenate([m_b[:, 1:], jnp.zeros_like(m_b[:, :1])], axis=1)
    return m_b + alpha * up


def c2acr_r0(m_ceps: jnp.ndarray, fft_len: int) -> jnp.ndarray:
    """Zeroth autocorrelation from a (one-sided) cepstrum (SPTK
    ``c2acr -M 0 -l fft_len``): r0 = mean over bins of exp(2*Re C(w))."""
    n = m_ceps.shape[1]
    pad = jnp.zeros((m_ceps.shape[0], fft_len - n), m_ceps.dtype)
    spec = jnp.fft.rfft(jnp.concatenate([m_ceps, pad], axis=1)).real
    P_half = jnp.exp(2.0 * spec)
    # mean over the full (mirrored) grid of fft_len points
    w = jnp.ones(fft_len // 2 + 1, m_ceps.dtype).at[1:-1].set(2.0)
    return jnp.sum(P_half * w, axis=1) / fft_len
