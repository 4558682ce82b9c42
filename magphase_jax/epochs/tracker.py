"""JAX pitch tracker + epoch placer — on-device replacement for REAPER.

The reference shells out to Google REAPER for every analysed utterance
(``reaper -s -x 400 -m 50 -a -u 0.005``, libaudio.py:450-455): epoch (GCI)
detection with voicing decisions, unvoiced marks every 5 ms.  This module
rebuilds that capability as device kernels:

  1. preprocessing     — FIR high-pass (80 Hz) + decimation to 16 kHz,
                         both as FFT convolutions (device);
  2. NCCF              — normalised cross-correlation per 5 ms frame over
                         lags for 50..400 Hz, computed for all frames at
                         once via batched rfft/irfft (device; the RAPT/
                         REAPER correlation, vectorised);
  3. candidate search  — local-maxima mask + top-K (device);
  4. Viterbi           — K+1-state DP (K lag candidates + unvoiced) with
                         octave-jump and voicing-transition costs, a
                         lax.scan over frames (device);
  5. epoch placement   — integrate the period track through voiced
                         regions, snapping each mark to the nearest
                         waveform trough of the low-passed signal;
                         unvoiced marks every 5 ms (host; O(n_marks)
                         scalar walk, microseconds per utterance).

Output contract matches ``la.read_reaper_est_file`` (libaudio.py:421-447):
strictly increasing pitch-mark times in seconds + 0/1 voicing flags, final
mark before the last sample.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.padding import bucket, bucket_signal

# tracker constants (REAPER flag parity: -x 400 -m 50 -u 0.005)
F0_MIN = 50.0
F0_MAX = 400.0
FRAME_STEP_S = 0.005
FS_ANALYSIS = 16000


def analysis_rate(fs: int):
    """(fs_analysis, decimation) for a given input rate.

    Decimate by the integer factor landing closest to FS_ANALYSIS — the
    NCCF frame/lag geometry is then derived from the ACTUAL analysis rate
    (22050 stays at 22050, 44100 -> 14700), not assumed to be 16 kHz;
    assuming 16 kHz skewed f0 by fs_a/16000 at those rates."""
    dec = max(1, int(round(fs / FS_ANALYSIS)))
    return fs / dec, dec
CORR_WIN_S = 0.0075
N_CAND = 15

# DP costs (tuned on the demo corpus)
UV_LOCAL = 0.35        # local cost of the unvoiced state
VUV_COST = 0.20        # voicing transition cost
TRANS_W = 0.60         # cost per |log2| octave of f0 movement
LAG_BIAS = 0.05        # slight preference for shorter lags (anti-octave)

# Epoch-snap window geometry (measured in
# tools/tracker_robustness.py over 7 stimulus contours x 3 stimulus
# seeds x {clean, snr10, rvb0.2, snr20+rvb0.15, snr10+rvb0.2}):
# the earlier reverb GPE (8.5%) came from the +-30% trough search jumping to
# reflection troughs ~+-25% off the predicted position.  A NARROW +-15%
# in-run window excludes them structurally (GPE tolerance is 20%), and
# the first SNAP_ONSET_MARKS marks of each voiced run keep a WIDE +-35%
# re-anchoring window so every run locks onto the same global waveform
# landmark (narrow-only walks froze the onset phase per run: GCI hit
# 0.49 on multi-run stimuli).  Result: worst-case GPE 17%->0.0% and
# worst-case GCI hit 0.62->0.84 across all 45 cells vs the old +-30%.
SNAP_HALF_RUN = 0.15
SNAP_HALF_ONSET = 0.35
SNAP_ONSET_MARKS = 4


@functools.lru_cache(maxsize=8)
def _fir_highpass(fc_hz: float, fs: int, taps: int = 255) -> np.ndarray:
    """Hann-windowed linear-phase high-pass (spectral inversion)."""
    n = np.arange(taps) - (taps - 1) / 2
    fc = fc_hz / fs
    lp = 2 * fc * np.sinc(2 * fc * n)
    lp *= np.hanning(taps)
    lp /= lp.sum()
    hp = -lp
    hp[(taps - 1) // 2] += 1.0
    return hp


@functools.lru_cache(maxsize=8)
def _fir_lowpass(fc_hz: float, fs: int, taps: int = 255) -> np.ndarray:
    n = np.arange(taps) - (taps - 1) / 2
    fc = fc_hz / fs
    lp = 2 * fc * np.sinc(2 * fc * n)
    lp *= np.hanning(taps)
    lp /= lp.sum()
    return lp


def _fft_conv_same(x: jnp.ndarray, h: np.ndarray) -> jnp.ndarray:
    """Zero-phase 'same' convolution via rfft (h symmetric, odd length)."""
    n = x.shape[0]
    taps = len(h)
    nfft = 1 << int(np.ceil(np.log2(n + taps)))
    H = jnp.fft.rfft(jnp.asarray(h, x.dtype), n=nfft)
    y = jnp.fft.irfft(jnp.fft.rfft(x, n=nfft) * H, n=nfft)
    off = (taps - 1) // 2
    return y[off:off + n]


_OS_BLOCK = 16384      # overlap-save FFT block


@functools.partial(jax.jit, static_argnames=("fs",))
def _preprocess(sig: jnp.ndarray, *, fs: int):
    """High-pass 80 Hz, decimate to FS_ANALYSIS; also a low-passed (800 Hz)
    copy at the original rate for epoch snapping.

    Overlap-save blocked FFT convolution: batched 16k-point block FFTs
    instead of one whole-signal 2^k FFT, and sharing each block's forward
    FFT between the two FIR responses (composed host-side at trace time)
    saves another forward transform.  Block j's circular-conv outputs [ph_max, nblk)
    equal the linear convolution y[j*L .. j*L+L), so concatenating the
    valid parts and slicing at each filter's group delay reproduces the
    whole-signal 'same' convolution exactly (matches the previous
    implementation to ~3e-7)."""
    x = sig - jnp.mean(sig)
    n = x.shape[0]
    fs_a, dec = analysis_rate(fs)
    h_hp = _fir_highpass(80.0, fs)
    h_snap = _fir_lowpass(800.0, fs)
    taps = len(h_hp)
    if dec > 1:
        h_a = np.convolve(h_hp, _fir_lowpass(0.45 * fs_a, fs))
    else:
        h_a = h_hp
    off_a = (len(h_a) - 1) // 2
    off_s = (taps - 1) // 2
    ph = len(h_a) - 1                       # max history among filters
    nblk = min(_OS_BLOCK, 1 << int(np.ceil(np.log2(n + 2 * ph))))
    L = nblk - ph
    nblocks = -(-(n + off_a) // L)
    xp = jnp.concatenate([jnp.zeros(ph, x.dtype), x,
                          jnp.zeros(nblocks * L + nblk, x.dtype)])
    idx = (jnp.arange(nblocks) * L)[:, None] + jnp.arange(nblk)[None, :]
    X = jnp.fft.rfft(xp[idx], n=nblk)
    Ha = np.fft.rfft(h_a, n=nblk).astype(np.complex64)
    Hs = np.fft.rfft(h_snap, n=nblk).astype(np.complex64)
    # valid parts concatenate to y_full_x[0 : nblocks*L] for each filter
    ya = jnp.fft.irfft(X * Ha, n=nblk)[:, ph:].reshape(-1)
    ys = jnp.fft.irfft(X * Hs, n=nblk)[:, ph:].reshape(-1)
    xa = jax.lax.dynamic_slice(ya, (off_a,), (n,))[::dec]
    y_snap = jax.lax.dynamic_slice(ys, (off_s,), (n,))
    return xa, y_snap


def nccf_whiten_mode() -> str:
    """Segment pre-whitening before correlation (A/B knob).

    'none' (default): raw NCCF.  Measured (tools/tracker_robustness.py):
    centre clipping ('clipNN', Sondhi/Rabiner) does NOT help the reverb
    envelope here — the r4 reverb GPE turned out to live in epoch
    PLACEMENT, not the correlation (the f0 track is clean under RT60
    0.2 s; see place_epochs' prediction-penalised snap) — and clip30+
    breaks high-f0 stimuli outright (350 Hz reverb GPE 1.0: with ~3 ms
    periods the clip threshold rides the strongest reflection, not the
    pulse).  Kept as an experiment knob; 'cube' likewise."""
    return os.environ.get("MAGPHASE_TRACKER_WHITEN", "none")


@functools.partial(jax.jit,
                   static_argnames=("n_frames_max", "fs_a", "whiten"))
def _nccf(xa: jnp.ndarray, n_frames: jnp.ndarray, *, n_frames_max: int,
          fs_a: float = FS_ANALYSIS, whiten: str = "none"):
    """NCCF for all frames at once.

    xa: analysis-rate signal (padded).  Returns (nccf[T,L+1], valid[T]).
    ``whiten``: see nccf_whiten_mode.
    """
    step = int(round(FRAME_STEP_S * fs_a))          # 80
    w = int(round(CORR_WIN_S * fs_a))               # 120
    min_lag = int(fs_a / F0_MAX)                    # 40
    max_lag = int(round(fs_a / F0_MIN))             # 320
    seg_len = w + max_lag                           # 440
    nfft = 1 << int(np.ceil(np.log2(seg_len + 1)))  # 512

    valid = jnp.arange(n_frames_max) < n_frames

    # Frame start t*step is stride-aligned, so the (T, seg_len) segment
    # matrix is ceil(seg_len/step) shifted views of one (T+nj, step)
    # reshape — no element gather — and bit-identical to the flattened
    # jnp.take on valid frames: for
    # n_frames derived from track_f0's formula, t*step + seg_len <=
    # n_sig_a <= len(xa) for t < n_frames, so the zero tail pad is only
    # ever read by invalid frames.  Degenerate case: when the signal is
    # shorter than seg_len*dec (~27.5 ms) the max(1, ...) in track_f0
    # forces n_frames = 1 and frame 0's reads would overrun n_sig_a;
    # there it is bucket_signal's minimum 32768-sample pad (not the
    # frame formula) that keeps frame 0's reads inside xa.
    nj = -(-seg_len // step)
    need = (n_frames_max + nj) * step
    pad = max(0, need - xa.shape[0])
    xa_r = jnp.concatenate(
        [xa, jnp.zeros(pad, xa.dtype)])[:need].reshape(-1, step)
    seg = jnp.concatenate(
        [xa_r[j:j + n_frames_max] for j in range(nj)], axis=1)[:, :seg_len]

    if whiten.startswith("clip"):
        # soft centre clipping per segment: removes the low-level
        # (reverb-tail / formant-ringing) samples from the correlation
        # while the glottal-pulse peaks pass through
        c = float(whiten[4:]) / 100.0
        m = jnp.max(jnp.abs(seg), axis=1, keepdims=True)
        seg = jnp.sign(seg) * jnp.maximum(jnp.abs(seg) - c * m, 0.0)
    elif whiten == "cube":
        seg = seg * seg * seg
    elif whiten != "none":
        raise ValueError(f"unknown whiten mode {whiten!r}")

    a = jnp.where(jnp.arange(seg_len)[None, :] < w, seg, 0.0)
    A = jnp.fft.rfft(a, n=nfft)
    B = jnp.fft.rfft(seg, n=nfft)
    num = jnp.fft.irfft(jnp.conj(A) * B, n=nfft)[:, :max_lag + 1]

    s2 = jnp.cumsum(seg * seg, axis=1)
    s2 = jnp.concatenate([jnp.zeros_like(s2[:, :1]), s2], axis=1)
    e0 = (s2[:, w] - s2[:, 0])[:, None]
    tau = jnp.arange(max_lag + 1)[None, :]
    # row-constant indices: plain static slices (not take_along_axis,
    # which can lower to an element gather)
    e_tau = s2[:, w:w + max_lag + 1] - s2[:, :max_lag + 1]
    nccf = num / jnp.sqrt(e0 * e_tau + 1e-12)
    # restrict to the valid lag band
    lag_ok = (tau >= min_lag) & (tau <= max_lag)
    nccf = jnp.where(lag_ok, nccf, -1.0)
    return nccf, valid


@functools.partial(jax.jit, static_argnames=())
def _candidates(nccf: jnp.ndarray):
    """Local maxima -> top-K (values, refined fractional lags)."""
    left = jnp.concatenate([nccf[:, :1], nccf[:, :-1]], axis=1)
    right = jnp.concatenate([nccf[:, 1:], nccf[:, -1:]], axis=1)
    is_peak = (nccf >= left) & (nccf > right)
    scores = jnp.where(is_peak, nccf, -2.0)
    vals, lags = jax.lax.top_k(scores, N_CAND)
    # parabolic interpolation for fractional lag.  The neighbour values
    # are selected by a one-hot mask-reduce instead of take_along_axis,
    # which fuses into one broadcast-compare-reduce.  Exactly one mask
    # element is nonzero per (t, k), so the sums are bitwise equal to
    # the gathered values.
    l = jnp.clip(lags, 1, nccf.shape[1] - 2)
    onehot = (jnp.arange(nccf.shape[1])[None, None, :] ==
              l[:, :, None])                          # (T, K, L)
    pick = lambda a: jnp.sum(jnp.where(onehot, a[:, None, :], 0.0), axis=2)
    ym = pick(left)                                   # left/right are the
    y0 = pick(nccf)                                   # pre-shifted copies:
    yp = pick(right)                                  # nccf[l-+1] at lag l
    denom = ym - 2 * y0 + yp
    frac = jnp.where(jnp.abs(denom) > 1e-9,
                     0.5 * (ym - yp) / denom, 0.0)
    frac = jnp.clip(frac, -0.5, 0.5)
    lag_ref = lags.astype(jnp.float32) + frac
    return vals, lag_ref


@functools.partial(jax.jit, static_argnames=("fs_a",))
def _viterbi(vals: jnp.ndarray, lags: jnp.ndarray, valid: jnp.ndarray,
             *, fs_a: float = FS_ANALYSIS):
    """K+1-state DP over frames.  State K = unvoiced.

    Returns (best_state[T], delta_final).
    """
    T, K = vals.shape
    log_lag = jnp.log2(jnp.maximum(lags, 1.0))
    max_lag = fs_a / F0_MIN

    local_v = 1.0 - vals + LAG_BIAS * (lags / max_lag)
    local_v = jnp.where(vals > -1.5, local_v, 1e6)   # invalid candidates
    local = jnp.concatenate([local_v, jnp.full((T, 1), UV_LOCAL)], axis=1)
    # padding frames: force unvoiced at no cost
    local = jnp.where(valid[:, None],
                      local,
                      jnp.concatenate([jnp.full((T, K), 1e6),
                                       jnp.zeros((T, 1))], axis=1))

    def step(carry, inp):
        delta_prev, ll_prev = carry
        loc, ll, v = inp
        # transition matrix prev(i) -> cur(j)
        jump = jnp.abs(ll_prev[:K, None] - ll[None, :K])     # (i,j)
        tv = TRANS_W * jump                                   # v->v
        trans = jnp.full((K + 1, K + 1), VUV_COST)
        trans = trans.at[:K, :K].set(tv)
        trans = trans.at[K, K].set(0.0)
        # transitions INTO padding are free: otherwise a voiced path at
        # the last real frame pays VUV_COST into the forced-unvoiced
        # padding, so voicing decisions would depend on how much padding
        # the batch bucket happens to add
        trans = jnp.where(v, trans, 0.0)
        tot = delta_prev[:, None] + trans                     # (i,j)
        best_i = jnp.argmin(tot, axis=0)
        delta = jnp.min(tot, axis=0) + loc
        delta = delta - jnp.min(delta)                        # renormalise
        return (delta, ll), (best_i, delta)

    ll_all = jnp.concatenate([log_lag, jnp.zeros((T, 1))], axis=1)
    init = (local[0], ll_all[0])
    # unroll: each step is a tiny (K+1)^2 DP update, so the scan is
    # latency-bound — unrolling amortises the per-step fixed cost.  (A
    # log-depth min-plus associative_scan over (K+1, K+1) cost matrices
    # is the alternative; its (T, S, S, S) tree levels move far more
    # bytes than the sequential scan.)
    (_, _), (back, deltas) = jax.lax.scan(
        step, init, (local[1:], ll_all[1:], valid[1:]), unroll=8)

    last_state = jnp.argmin(deltas[-1])

    def bstep(state, b):
        # processing back[i]: carry = state of frame i+1; emit it, move to
        # its best predecessor (frame i's state)
        prev = b[state]
        return prev, state

    first_state, states_rev = jax.lax.scan(bstep, last_state, back,
                                           reverse=True, unroll=8)
    states = jnp.concatenate([first_state[None], states_rev])
    return states


def track_f0(v_sig: np.ndarray, fs: int):
    """Full F0 track: returns (f0[T], voiced[T], frame_step_s).

    f0 is 0 in unvoiced frames; frame t covers time t*FRAME_STEP_S.
    """
    sig = jnp.asarray(np.asarray(v_sig, np.float32))
    n_pad = bucket_signal(sig.shape[0])
    sig_p = jnp.concatenate(
        [sig, jnp.zeros(n_pad - sig.shape[0], sig.dtype)])
    xa, y_snap = _preprocess(sig_p, fs=fs)

    fs_a, dec = analysis_rate(fs)
    step = int(round(FRAME_STEP_S * fs_a))
    w = int(round(CORR_WIN_S * fs_a))
    max_lag = int(round(fs_a / F0_MIN))
    n_sig_a = len(v_sig) // dec
    n_frames = max(1, (n_sig_a - (w + max_lag)) // step + 1)
    Tmax = bucket(n_frames, 128)

    nccf, valid = _nccf(xa, jnp.int32(n_frames), n_frames_max=Tmax,
                        fs_a=fs_a, whiten=nccf_whiten_mode())
    vals, lags = _candidates(nccf)
    states = _viterbi(vals, lags, valid, fs_a=fs_a)

    states = np.asarray(jax.device_get(states))[:n_frames]
    lags_h = np.asarray(jax.device_get(lags))[:n_frames]

    voiced = states < N_CAND
    lag_sel = np.where(voiced, lags_h[np.arange(n_frames),
                                      np.clip(states, 0, N_CAND - 1)], 0.0)
    f0 = np.where(voiced & (lag_sel > 0), fs_a / np.maximum(lag_sel, 1.0),
                  0.0)
    # ACTUAL frame spacing in seconds: frames advance by
    # round(FRAME_STEP_S*fs_a) analysis samples = that * dec input samples
    # (exactly 5 ms at 16/48 kHz, 5.034 ms at 44100) — the epoch walk must
    # index frames with this, not the nominal 5 ms
    frame_step_s = step * dec / fs
    return f0, voiced, frame_step_s, \
        np.asarray(jax.device_get(y_snap))[:len(v_sig)]


def place_epochs(v_sig: np.ndarray, fs: int, f0: np.ndarray,
                 voiced: np.ndarray, y_snap: np.ndarray,
                 frame_step_s: float = FRAME_STEP_S):
    """Period-integrating epoch placement with trough snapping (host).

    Voiced regions: marks advance by the local period, each snapped to
    the minimum of the 800 Hz low-passed waveform within a window around
    the predicted position — +-SNAP_HALF_ONSET of a period for the first
    SNAP_ONSET_MARKS marks of a run (re-anchoring onto the consistent
    waveform landmark), +-SNAP_HALF_RUN after (narrow: reverb-reflection
    troughs ~+-25% off cannot capture the walk; see the constants'
    rationale above).  Unvoiced: every 5 ms (REAPER ``-u 0.005``
    behaviour, libaudio.py:453).
    """
    n = len(v_sig)
    T = len(f0)
    step = frame_step_s * fs
    unv_step = int(round(0.005 * fs))

    def frame_of(t):
        return min(T - 1, max(0, int(t / step)))

    marks = []
    flags = []
    t = 0.0
    run_len = 0
    # start: if first frame voiced, snap the first mark inside one period
    while t < n - 1:
        fr = frame_of(t)
        if voiced[fr] and f0[fr] > 0:
            period = fs / f0[fr]
            half = (SNAP_HALF_ONSET if run_len < SNAP_ONSET_MARKS
                    else SNAP_HALF_RUN)
            lo = int(max(0, t + (1.0 - half) * period))
            hi = int(min(n - 1, t + (1.0 + half) * period))
            if hi <= lo + 1:
                break
            nxt = lo + int(np.argmin(y_snap[lo:hi]))
            if marks and nxt <= marks[-1]:
                nxt = marks[-1] + max(1, int((1.0 - half) * period))
            marks.append(nxt)
            flags.append(1)
            t = float(nxt)
            run_len += 1
        else:
            nxt = int(t) + unv_step
            if nxt >= n - 1:
                break
            if marks and nxt <= marks[-1]:
                nxt = marks[-1] + 1
            marks.append(nxt)
            flags.append(0)
            t = float(nxt)
            run_len = 0

    marks = np.asarray(marks, np.float64)
    flags = np.asarray(flags, np.float64)
    keep = marks < (n - 1)
    return marks[keep] / fs, flags[keep]


def extract_epochs(v_sig: np.ndarray, fs: int):
    """Main entry: (pitch-mark times [s], voicing flags) — REAPER-style."""
    f0, voiced, fstep, y_snap = track_f0(v_sig, fs)
    return place_epochs(v_sig, fs, f0, voiced, y_snap, fstep)
