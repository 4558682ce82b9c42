"""Sequential filters re-expressed as parallel device kernels.

* median filter (kernel 3) — closed-form elementwise min/max network,
  replacing scipy.signal.medfilt used for F0 smoothing (magphase.py:2202,
  2500; medfilt zero-pads at the edges).
* IIR filtering (Butterworth/elliptic high-pass of magphase.py:990-995,
  1415-1419) — filter design happens host-side with scipy at trace time
  (coefficients are static), and the sequential Direct-Form-II recursion is
  evaluated as a *parallel prefix* over affine state maps with
  jax.lax.associative_scan: state_{t+1} = A state_t + b_t, composed in
  O(log n) depth instead of an O(n) sample loop.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as sp_signal


def medfilt3(v: jnp.ndarray) -> jnp.ndarray:
    """scipy.signal.medfilt(v) with default kernel_size=3 (zero padding)."""
    a = jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]])
    c = jnp.concatenate([v[1:], jnp.zeros(1, v.dtype)])
    return jnp.maximum(jnp.minimum(a, v),
                       jnp.minimum(jnp.maximum(a, v), c))


@functools.lru_cache(maxsize=16)
def butter_highpass_coeffs(order: int, fc_hz: float, fs: int):
    """Butterworth high-pass (b, a) — magphase.py:990-995."""
    b, a = sp_signal.butter(order, fc_hz / (fs / 2.0), btype="highpass")
    return tuple(b.tolist()), tuple(a.tolist())


@functools.lru_cache(maxsize=16)
def ellip_highpass_coeffs(order: int, rp: float, rs: float, fc_hz: float,
                          fs: int):
    """Elliptic high-pass (b, a) — magphase.py:1415-1419 (0.5 dB / 80 dB)."""
    b, a = sp_signal.ellip(order, rp, rs, fc_hz / (fs / 2.0), btype="highpass")
    return tuple(b.tolist()), tuple(a.tolist())


def lfilter(b, a, x: jnp.ndarray) -> jnp.ndarray:
    """scipy.signal.lfilter(b, a, x) for 1-D x, zero initial state, as an
    associative scan over transposed Direct-Form-II affine updates.

    DF2T recurrence (n = max(len(a), len(b)) - 1):
      y[t]   = b0*x[t] + z0[t]
      zi[t+1]= b_{i+1}*x[t] + z_{i+1}[t] - a_{i+1}*y[t]
    which is affine in the state z: z[t+1] = A z[t] + u[t] x[t].

    WARNING: for high-order filters with poles near the unit circle (e.g. a
    4th-order 40 Hz high-pass at 48 kHz) the companion-matrix products in the
    scan have enormous transient growth and overflow float32 — use
    ``sosfilt`` (cascaded biquads) for those.
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    n = max(len(a), len(b)) - 1
    bp = np.zeros(n + 1)
    ap = np.zeros(n + 1)
    bp[:len(b)] = b
    ap[:len(a)] = a

    # state update matrix: z' = A z + u * x
    A = np.zeros((n, n))
    A[:, 0] = -ap[1:]
    A[:-1, 1:] += np.eye(n - 1)
    u = bp[1:] - ap[1:] * bp[0]

    dtype = x.dtype
    Aj = jnp.asarray(A, dtype)
    uj = jnp.asarray(u, dtype)

    T = x.shape[0]
    As = jnp.broadcast_to(Aj, (T, n, n))
    bs = uj[None, :] * x[:, None]

    # HIGHEST: a default-precision float32 contraction may run in TF32
    # (~3 decimal digits) on a GPU, and the state-map products compound
    # along the scan's log2(T) levels
    hi = jax.lax.Precision.HIGHEST

    def compose(e1, e2):
        A1, b1 = e1
        A2, b2 = e2
        return (jnp.einsum("...ij,...jk->...ik", A2, A1, precision=hi),
                jnp.einsum("...ij,...j->...i", A2, b1, precision=hi) + b2)

    Acum, bcum = jax.lax.associative_scan(compose, (As, bs), axis=0)
    # z[t] (state *before* consuming x[t]) = prefix up to t-1 applied to 0
    z = jnp.concatenate([jnp.zeros((1, n), dtype), bcum[:-1]], axis=0)
    y = bp[0] * x + z[:, 0]
    return y


@functools.lru_cache(maxsize=16)
def butter_highpass_sos(order: int, fc_hz: float, fs: int):
    """Butterworth high-pass as second-order sections (numerically stable
    factorisation of magphase.py:990-995 for float32 device execution)."""
    sos = sp_signal.butter(order, fc_hz / (fs / 2.0), btype="highpass",
                           output="sos")
    return tuple(map(tuple, sos.tolist()))


@functools.lru_cache(maxsize=16)
def sos_freq_response_rfft(sos, fft_len: int):
    """Exact steady-state frequency response of the SOS cascade at the
    ``fft_len`` rfft bin frequencies, as two float32 vectors (re, im).

    This is the spectral form of the filter for PER-FRAME application
    inside the synthesis kernel (MAGPHASE_HPF_MODE=spectral): multiplying
    each pitch-sync frame's spectrum by H before the inverse FFT filters
    the frame circularly with the (time-aliased) IIR response, and the
    OLA of filtered frames approximates filtering the OLA'd signal
    (exactly equal up to the per-frame wrap-around and the non-commuting
    anti-ringing window).  Returned as real (re, im) float32 pairs."""
    w = 2.0 * np.pi * np.arange(fft_len // 2 + 1) / float(fft_len)
    _, H = sp_signal.sosfreqz(np.asarray(sos, np.float64), worN=w)
    return H.real.astype(np.float32), H.imag.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _sos_impulse_response(sos, ntaps: int):
    """Exact (float64, scipy) impulse response of the SOS cascade,
    truncated to ``ntaps``."""
    imp = np.zeros(ntaps)
    imp[0] = 1.0
    return sp_signal.sosfilt(np.asarray(sos, np.float64), imp)


@functools.lru_cache(maxsize=16)
def _sos_ir_trimmed(sos, ntaps: int):
    """Impulse response trimmed where it has decayed below 1e-10 of its
    peak (rounded up to a 1024 multiple) — the vocoder high-pass poles decay
    to that level in ~6-7k samples, and a shorter h means fewer
    overlap-save blocks."""
    h = _sos_impulse_response(sos, ntaps)
    peak = np.abs(h).max()
    sig = np.nonzero(np.abs(h) > 1e-8 * peak)[0]
    m = int(sig[-1]) + 1 if sig.size else 1
    m = min(ntaps, -(-m // 1024) * 1024)
    return h[:m]


def sosfilt(sos, x: jnp.ndarray, ntaps: int = 16384,
            mode: str = "auto") -> jnp.ndarray:
    """Cascaded-biquad IIR filter (scipy.signal.sosfilt semantics, zero
    initial state) as FFT convolution with the exact truncated impulse
    response.

    Associative-scan prefix products of biquad companion matrices are
    catastrophically unstable in float32 when poles sit near the unit
    circle (the 40 Hz/48 kHz high-pass of magphase.py:990-995 overflows
    within ~2k samples), so the IIR is evaluated in its equivalent FIR
    form instead: h is computed exactly in float64 host-side (trimmed
    where it has decayed below 1e-8 of peak — the truncation tail sums to
    ~4e-6, an order below one PCM16 step), and the causal convolution runs
    on device as either ONE whole-signal rfft·irfft or overlap-save
    blocked FFTs, whichever needs fewer FFT points: the 2^k round-up of
    the whole-signal form wastes up to 2x for unlucky lengths, where
    blocked 32k-sample sections (~1.28x points at this h length, plus
    better batched-FFT efficiency) win; at lucky lengths the whole-signal
    form is tighter and skips the overlapped-block materialisation.

    ``mode='blocked'`` pins overlap-save with a SIGNAL-LENGTH-INDEPENDENT
    block size: output sample i then depends only on x[:i+1] and the
    fixed block grid, never on how far the row was padded — the batched
    corpus synthesis uses this so each utterance's audio is bitwise
    invariant to batch composition (multi-host merges byte-identical to
    single-host runs, tests/test_multihost_corpus.py)."""
    n = x.shape[0]
    h = _sos_ir_trimmed(tuple(map(tuple, sos)), ntaps)
    m = len(h)
    cdtype = (np.complex64 if x.dtype == jnp.float32 else np.complex128)
    if mode == "blocked":
        # MAGPHASE_HPF_BLOCK sweeps the (globally fixed) section size —
        # any fixed power of two > m keeps the length-independence
        # contract
        import os
        env = int(os.environ.get("MAGPHASE_HPF_BLOCK", "0"))
        nblk = env if env > 2 * m else \
            1 << int(np.ceil(np.log2(max(4 * m, 32768))))
    else:
        nblk = 1 << int(np.ceil(np.log2(max(4 * m, min(n + m, 32768)))))
    L = nblk - (m - 1)
    nblocks = -(-n // L)
    whole_pts = 1 << int(np.ceil(np.log2(n + m)))
    if mode != "blocked" and whole_pts <= 1.1 * nblocks * nblk:
        X = jnp.fft.rfft(x, n=whole_pts)
        H = np.fft.rfft(h, n=whole_pts).astype(cdtype)
        return jnp.fft.irfft(X * H, n=whole_pts)[:n].astype(x.dtype)
    ph = m - 1
    xp = jnp.concatenate([jnp.zeros(ph, x.dtype), x,
                          jnp.zeros(nblocks * L + nblk, x.dtype)])
    idx = (jnp.arange(nblocks) * L)[:, None] + jnp.arange(nblk)[None, :]
    X = jnp.fft.rfft(xp[idx], n=nblk)
    H = np.fft.rfft(h, n=nblk).astype(cdtype)
    y = jnp.fft.irfft(X * H, n=nblk)[:, ph:].reshape(-1)
    return y[:n].astype(x.dtype)
