"""On-device epoch placement: the period-integrating mark walk as a
batched early-exit lax.while_loop.

The walk is inherently sequential over marks (each mark's position feeds
the next), but it is trivially vmappable over utterances: one loop
advances every utterance's walker in lockstep until all are done.  This
keeps the fused pipelines device-resident (no signal download for the
host walk in epochs/tracker.py:place_epochs — the two implementations
are sample-exact equals; see tests/test_copy_synthesis_batch.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.padding import bucket
from .tracker import (FRAME_STEP_S, FS_ANALYSIS, SNAP_HALF_ONSET,
                      SNAP_HALF_RUN, SNAP_ONSET_MARKS)

_WALK_UNROLL = 8          # walk-body copies per while_loop iteration


def _snap_win(fs: int) -> int:
    """Trough-search slice width for the voiced snap.

    The widest searched span is the onset window [t+(1-h)p, t+(1+h)p)
    with h = SNAP_HALF_ONSET: at most 2h*p_max + 2 samples with
    p_max = fs/F0_MIN (the kernel clips the period there) — 674 at
    48 kHz, 226 at 16 kHz.  Sizing by fs instead of a fixed maximum
    halves the per-mark argmin work at 48 kHz."""
    return bucket(int(np.ceil(2 * SNAP_HALF_ONSET * fs / 50.0)) + 2, 128)


def placement_m_max(n_pad_sig: int, fs: int, frm_step: int = 128) -> int:
    """Worst-case mark-array capacity for the device epoch walk.

    The densest legitimate mark train is sustained voicing at the
    tracker's F0 ceiling (400 Hz, tracker.py F0_MAX): 400 marks/s.
    Unvoiced regions step at 5 ms = 200 marks/s, always sparser.  The
    capacity must be derived from *time*, not samples — a samples-based
    heuristic (e.g. n//200) truncates every 16 kHz utterance.  Callers
    still detect n_marks == m_max after the kernel (pathological inputs
    can beat 400/s via the monotonicity guard) and fall back to the host
    walk for those utterances.
    """
    return bucket(int(np.ceil(400.0 * n_pad_sig / fs)) + 2, frm_step)


def walk_tables(f0, voiced, *, fs: int):
    """Per-frame walk table (5, T) int32 for one utterance:
    [is_voiced, p_lo_onset, p_hi_onset, p_lo_run, p_hi_run].

    The p_* are the trough-window offsets floor(mult * period) of the
    two-phase snap (tracker.py SNAP_* rationale): wide re-anchoring for
    the first marks of a voiced run, narrow after.  Every float operation
    of the walk happens here, once per frame, so both walks
    (place_epochs_kernel and the Pallas kernel) read identical integers.
    """
    unv_step = int(round(0.005 * fs))
    is_voi = (voiced > 0) & (f0 > 0)
    period = jnp.where(is_voi, fs / jnp.maximum(f0, 1.0), float(unv_step))
    # the tracker guarantees f0 >= F0_MIN (lag <= fs_a/F0_MIN); clip
    # so an out-of-contract f0 cannot outrun the snap slice
    period = jnp.minimum(period, fs / 50.0)

    def off(mult):
        return jnp.floor(jnp.float32(mult) * period).astype(jnp.int32)

    return jnp.stack([is_voi.astype(jnp.int32),
                      off(1.0 - SNAP_HALF_ONSET), off(1.0 + SNAP_HALF_ONSET),
                      off(1.0 - SNAP_HALF_RUN), off(1.0 + SNAP_HALF_RUN)])


@functools.partial(jax.jit, static_argnames=("fs", "m_max", "frame_step"))
def place_epochs_kernel(y_snap, f0, voiced, n_sig, n_frames=None, *,
                        fs: int, m_max: int, frame_step: float = 0.0):
    """One utterance: (marks[m_max], flags[m_max], n_marks).

    y_snap: low-passed signal (padded); f0/voiced: per-frame track,
    possibly PADDED past ``n_frames`` real frames — the frame lookup
    clips to the last REAL frame (host walk semantics), not the padding.
    ``frame_step``: actual frame spacing in input samples
    (round(FRAME_STEP_S*fs_a)*dec; the nominal 5 ms when omitted).
    """
    T = f0.shape[0]
    if n_frames is None:
        n_frames = jnp.int32(T)
    step = frame_step if frame_step > 0 else FRAME_STEP_S * fs
    unv_step = int(round(0.005 * fs))
    S = y_snap.shape[0]
    snap_w = _snap_win(fs)
    tab = walk_tables(f0, voiced, fs=fs)

    def body(carry):
        t, n_marks, run_len, done, marks, flags = carry
        # t is an INT32 sample position: marks are integers, and float32
        # positions lose sample precision past 2^24 (~350 s at 48 kHz)
        fr = jnp.clip((t.astype(jnp.float32) / step).astype(jnp.int32), 0,
                      jnp.maximum(n_frames - 1, 0))
        is_voi = tab[0, fr] > 0
        wide = run_len < SNAP_ONSET_MARKS
        p_lo = jnp.where(wide, tab[1, fr], tab[3, fr])
        p_hi = jnp.where(wide, tab[2, fr], tab[4, fr])
        # host arithmetic: int(t + x) == t + floor(x) for integer t, x>=0 —
        # keeping t integral makes the window bounds exact at any length
        lo = t + p_lo
        # window end clips to the REAL signal end (host walk semantics:
        # tracker.place_epochs hi = min(n-1, ...)), not the padded length —
        # otherwise tail marks snap into the zero padding and the walk
        # drops the final voiced mark the host version places
        hi = jnp.minimum(n_sig - 1, t + p_hi)

        # voiced: snap to trough of y_snap in [lo, hi) (half-open, as the
        # host's y_snap[lo:hi] slice), as one contiguous dynamic_slice.
        # The slice start clamps to S-snap_w for validity; the mask
        # must therefore bound BOTH ends, or pre-window samples become
        # eligible when the clamp engages near the bucket boundary.
        lo_slice = jnp.clip(lo, 0, S - snap_w)
        offs = jnp.arange(snap_w)
        pos = lo_slice + offs
        vals = jax.lax.dynamic_slice(y_snap, (lo_slice,), (snap_w,))
        in_win = (pos >= jnp.maximum(lo, 0)) & (pos < hi)
        vals = jnp.where(in_win, vals, jnp.inf)
        nxt_voi = lo_slice + jnp.argmin(vals).astype(jnp.int32)

        nxt_unv = t + unv_step
        nxt = jnp.where(is_voi, nxt_voi, nxt_unv)
        # monotonicity guard (tracker.place_epochs)
        prev = jnp.where(n_marks > 0, marks[jnp.maximum(n_marks - 1, 0)],
                         -1)
        min_adv = jnp.where(is_voi, jnp.maximum(1, p_lo), 1)
        nxt = jnp.where(nxt <= prev, prev + min_adv, nxt)

        # n_marks < m_max keeps the write in bounds; at capacity the
        # walker stops with n_marks == m_max (callers detect this and
        # fall back to the host walk)
        ok = (~done) & (nxt < n_sig - 1) & (hi > lo + 1) & \
            (n_marks < m_max)
        marks = jnp.where(ok, marks.at[n_marks].set(nxt), marks)
        flags = jnp.where(ok, flags.at[n_marks].set(
            is_voi.astype(jnp.float32)), flags)
        n_marks = jnp.where(ok, n_marks + 1, n_marks)
        run_len = jnp.where(ok & is_voi, run_len + 1,
                            jnp.where(ok, 0, run_len))
        done = done | ~ok
        t = jnp.where(ok, nxt, t)
        return (t, n_marks, run_len, done, marks, flags)

    # while_loop, not fori_loop over m_max: capacity is sized for the
    # worst case (400 marks/s) but real speech places far fewer marks —
    # early exit makes walk cost scale with actual marks.  Under vmap the
    # batched loop runs until every utterance's walker is done.  The body
    # is unrolled _WALK_UNROLL x per iteration: the chain is inherently
    # sequential, and fewer loop iterations mean fewer per-trip fixed
    # costs (loop predicate + vmapped select).  `done` makes extra body
    # copies no-ops, so the unroll never overruns.
    def cond(carry):
        return ~carry[3]

    def wbody(carry):
        for _ in range(_WALK_UNROLL):
            carry = body(carry)
        return carry

    init = (jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.bool_(False),
            jnp.zeros(m_max, jnp.int32), jnp.zeros(m_max, jnp.float32))
    (_, n_marks, _, _, marks, flags) = jax.lax.while_loop(cond, wbody,
                                                          init)
    return marks, flags, n_marks


def _track_one(sig, n_frames, *, fs: int, n_frames_max: int):
    """Device tracking for one utterance: preprocess -> NCCF -> Viterbi.
    Returns the walk inputs (y_snap, f0, voiced) — vmap over the batch."""
    from . import tracker

    fs_a, _dec = tracker.analysis_rate(fs)
    xa, y_snap = tracker._preprocess(sig, fs=fs)
    nccf, valid = tracker._nccf(xa, n_frames, n_frames_max=n_frames_max,
                                fs_a=fs_a,
                                whiten=tracker.nccf_whiten_mode())
    vals, lags = tracker._candidates(nccf)
    states = tracker._viterbi(vals, lags, valid, fs_a=fs_a)

    voiced = (states < tracker.N_CAND) & valid
    # one-hot mask-reduce over the N_CAND candidates (as
    # tracker._candidates)
    sel = (jnp.arange(tracker.N_CAND)[None, :] ==
           jnp.clip(states, 0, tracker.N_CAND - 1)[:, None])
    lag_sel = jnp.sum(jnp.where(sel, lags, 0.0), axis=1)
    f0 = jnp.where(voiced & (lag_sel > 0),
                   fs_a / jnp.maximum(lag_sel, 1.0), 0.0)
    return y_snap, f0, voiced.astype(jnp.float32)


def _walk_frame_step(fs: int) -> float:
    from . import tracker

    fs_a, dec = tracker.analysis_rate(fs)
    return float(round(tracker.FRAME_STEP_S * fs_a) * dec)


def _walk_win(fs: int) -> int:
    """Power-of-two trough window of the Pallas walk (>= _snap_win)."""
    return 1 << (_snap_win(fs) - 1).bit_length()


def place_epochs_batch(y_snap, f0, voiced, n_sigs, n_frames, *, fs: int,
                       m_max: int, frame_step: float):
    """Batched epoch walk: the Pallas kernel (Triton route) on a GPU —
    one program per utterance, each stopping at its own last mark
    (pallas_kernels/walk_pallas.py) — and the vmapped lax.while_loop
    kernel on other platforms.  Sample-exact equals."""
    walk = functools.partial(place_epochs_kernel, fs=fs, m_max=m_max,
                             frame_step=frame_step)

    def xla_walk(y_snap, f0, voiced, n_sigs, n_frames):
        return jax.vmap(walk)(y_snap, f0, voiced, n_sigs, n_frames)

    def pallas_walk(y_snap, f0, voiced, n_sigs, n_frames):
        from ..pallas_kernels.walk_pallas import place_epochs_pallas

        tab = jax.vmap(functools.partial(walk_tables, fs=fs))(f0, voiced)
        return place_epochs_pallas(
            y_snap, tab, n_sigs, n_frames, m_max=m_max,
            step=int(frame_step), unv_step=int(round(0.005 * fs)),
            win=_walk_win(fs))

    args = (y_snap, f0, voiced, n_sigs, n_frames)
    S = y_snap.shape[1]
    if not float(frame_step).is_integer() or not _walk_win(fs) <= S < 1 << 24:
        return xla_walk(*args)
    return jax.lax.platform_dependent(*args, cuda=pallas_walk,
                                      default=xla_walk)


def track_and_place_batch(sigs, n_sigs, n_frames, *, fs: int,
                          n_frames_max: int, m_max: int):
    """Batched tracking + epoch placement, fully on device.  Call under
    an enclosing jit.  Returns (marks (B, m_max), flags, n_marks)."""
    y_snap, f0, voiced = jax.vmap(functools.partial(
        _track_one, fs=fs, n_frames_max=n_frames_max))(sigs, n_frames)
    return place_epochs_batch(y_snap, f0, voiced, n_sigs, n_frames,
                              fs=fs, m_max=m_max,
                              frame_step=_walk_frame_step(fs))


def track_and_place_one(sig, n_sig, n_frames, *, fs: int,
                        n_frames_max: int, m_max: int):
    """One utterance, fully on device: preprocess -> NCCF -> Viterbi ->
    epoch walk.  Returns (marks[m_max] samples, flags[m_max], n_marks).

    The device half of epochs/tracker.py:extract_epochs.  Production
    batches go through track_and_place_batch (Pallas walk on a GPU);
    this per-utterance form keeps the vmappable XLA walk for tests and
    host-walk fallbacks.
    """
    y_snap, f0, voiced = _track_one(sig, n_frames, fs=fs,
                                    n_frames_max=n_frames_max)
    return place_epochs_kernel(y_snap, f0, voiced, n_sig, n_frames,
                               fs=fs, m_max=m_max,
                               frame_step=_walk_frame_step(fs))
