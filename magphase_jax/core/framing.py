"""Pitch-synchronous framing and overlap-add as dense gather/scatter kernels.

The reference builds ragged frame lists in per-frame Python loops
(``windowing`` magphase.py:74-119, ``frm_list_to_matrix`` libaudio.py:122-134)
and overlap-adds them sequentially (``ola`` magphase.py:34-62).  Here both
become single dense ops over a padded (n_frames, fft_len) tensor:

* analysis framing = one gather from the signal with per-frame rotation
  (the "delay compensation" circular shift of magphase.py:317-323 is folded
  into the gather index), window values computed in closed form;
* OLA = scatter-adds of frames centred at their pitch marks, in a fixed
  order of collision-free frame groups (see ``ola_centered``).

Frame layout contract (identical for analysis and synthesis):
  frame f covers signal samples [pm[f-1], pm[f+1]] (pm[-1]:=0,
  pm[nfrms]:=n_sig-1), L[f]=pm[f]-pm[f-1], R[f]=pm[f+1]-pm[f]; after delay
  compensation the pitch mark sits at index 0 of the fft_len-wide frame and
  the tail wraps to the end; after irfft+fftshift in synthesis the pitch mark
  sits at index fft_len//2 and OLA places that index at pm[f]
  (derivation: ola start strt_f = pm[f]-pm[0], trimmed by
  fft_len/2 - pm[0], magphase.py:55-60).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import windows as W


def frame_geometry(pm: jnp.ndarray, nfrms: jnp.ndarray, n_sig: jnp.ndarray):
    """Per-frame (left_lim, L, R) from padded pitch marks.

    pm: (F,) int32 pitch-mark sample indices (entries >= nfrms are padding).
    Mirrors the pm extension of magphase.py:81 (prepend 0, append n_sig-1).
    """
    F = pm.shape[0]
    f = jnp.arange(F)
    pm_prev = jnp.where(f == 0, 0, jnp.roll(pm, 1))
    pm_next = jnp.where(f >= nfrms - 1, n_sig - 1, jnp.roll(pm, -1))
    left_lim = pm_prev
    L = pm - pm_prev
    R = pm_next - pm
    valid = f < nfrms
    L = jnp.where(valid, L, 0)
    R = jnp.where(valid, R, 0)
    return left_lim, L, R, valid


def pitch_sync_frames(sig: jnp.ndarray, pm: jnp.ndarray, nfrms: jnp.ndarray,
                      n_sig: jnp.ndarray, fft_len: int,
                      win_family: int = W.HANNING,
                      voiced: jnp.ndarray | None = None,
                      win_family_unvoiced: int | None = None) -> tuple:
    """Windowed, delay-compensated, zero-padded frames: (F, fft_len).

    Equivalent to windowing() + zero-pad + circular rotate of
    magphase.py:291-323 (and, for synthesis noise framing, to
    windowing() + frm_list_to_matrix() + fftshift of magphase.py:892-897,
    which produces the same layout).

    If ``voiced``/``win_family_unvoiced`` are given, the window family is
    selected per frame (noise windowing, magphase.py:886-892).

    Returns (frames, L, R, valid_mask).
    """
    left_lim, L, R, valid = frame_geometry(pm, nfrms, n_sig)
    framelen = L + R + 1

    p = jnp.arange(fft_len)[None, :]                      # (1, fft_len)
    # delay-compensated position: q = (p + L) mod fft_len
    q = (p + L[:, None]) % fft_len
    in_frame = (q < framelen[:, None]) & valid[:, None]

    idx = jnp.clip(left_lim[:, None] + q, 0, n_sig - 1)
    vals = jnp.take(sig, idx.reshape(-1), axis=0).reshape(idx.shape)

    if voiced is not None and win_family_unvoiced is not None:
        win = W.asym_win_value_select(q, L[:, None], R[:, None],
                                      voiced[:, None], win_family,
                                      win_family_unvoiced)
    else:
        win = W.asym_win_value(q, L[:, None], R[:, None], win_family)

    frames = jnp.where(in_frame, vals * win, 0.0)
    return frames, L, R, valid


def ola_centered(frames: jnp.ndarray, pm: jnp.ndarray, nfrms: jnp.ndarray,
                 out_len_max: int) -> jnp.ndarray:
    """Overlap-add with frame centre (index fft_len//2) placed at pm[f].

    Equivalent to ola() of magphase.py:34-62 with win_func=None: the
    reference accumulates frame f at pre-trim start pm[f]-pm[0] and trims
    fft_len/2 - pm[0] leading samples, i.e. frame f lands at
    pm[f] - fft_len/2 in output coordinates.  Output must be sliced by the
    caller to pm[n-1] + (pm[n-1]-pm[n-2]) + 1 samples (magphase.py:58-60).

    Returns a buffer of static length ``out_len_max`` (padded with zeros).

    Deterministic: one scatter-add of all frames lets a GPU sum each
    sample's overlapping frames with atomics in a run-dependent order
    (and serialises them on the colliding addresses).  Instead the frames
    go in G = fft_len // 32 scatter-adds of frames f = g (mod G), in
    order g = 0, 1, ...: frames of one group are at least
    G * (min pitch-mark spacing) apart, so they never overlap while
    marks are >= 32 samples apart (f0 up to 1.5 kHz at 48 kHz, 500 Hz at
    16 kHz).  Closer marks still sum correctly, only in an order that
    may vary.
    """
    F, fft_len = frames.shape
    G = max(1, min(F, fft_len // 32))
    valid = (jnp.arange(F) < nfrms)[:, None]
    starts = pm - fft_len // 2
    # offset by fft_len so early frames with negative start stay in-bounds;
    # the reference discards those samples via its leading trim.
    idx = starts[:, None] + jnp.arange(fft_len)[None, :] + fft_len
    idx = jnp.where(valid, idx, -1)      # dropped by mode='drop'
    vals = jnp.where(valid, frames, 0.0)
    Fp = -(-F // G) * G
    idx = jnp.pad(idx, ((0, Fp - F), (0, 0)), constant_values=-1)
    vals = jnp.pad(vals, ((0, Fp - F), (0, 0)))
    idx = idx.reshape(Fp // G, G, fft_len)
    vals = vals.reshape(Fp // G, G, fft_len)
    buf = jnp.zeros(out_len_max + 2 * fft_len, dtype=frames.dtype)
    for g in range(G):
        buf = buf.at[idx[:, g].reshape(-1)].add(vals[:, g].reshape(-1),
                                                mode="drop")
    return jax.lax.dynamic_slice(buf, (fft_len,), (out_len_max,))


# ---------------------------------------------------------------------------
# batched entry points

def frame_geometry_batch(pm: jnp.ndarray, nfrms: jnp.ndarray,
                         n_sig: jnp.ndarray):
    """(B, F) variant of frame_geometry."""
    B, F = pm.shape
    f = jnp.arange(F)[None, :]
    pm_prev = jnp.where(f == 0, 0, jnp.roll(pm, 1, axis=1))
    pm_next = jnp.where(f >= nfrms[:, None] - 1, n_sig[:, None] - 1,
                        jnp.roll(pm, -1, axis=1))
    L = pm - pm_prev
    R = pm_next - pm
    valid = f < nfrms[:, None]
    L = jnp.where(valid, L, 0)
    R = jnp.where(valid, R, 0)
    return pm_prev, L, R, valid


def pitch_sync_frames_batch(sig: jnp.ndarray, pm: jnp.ndarray,
                            nfrms: jnp.ndarray, n_sig: jnp.ndarray,
                            fft_len: int, win_family: int = W.HANNING,
                            voiced: jnp.ndarray | None = None,
                            win_family_unvoiced: int | None = None):
    """Batched pitch_sync_frames: sig (B, S), pm/voiced (B, F),
    nfrms/n_sig (B,).  Returns (frames (B,F,fft_len), L, R, valid)."""
    pm = jnp.clip(pm, 0, sig.shape[1] - 1)
    _, L, R, valid = frame_geometry_batch(pm, nfrms, n_sig)

    def one(sig1, pm1, nf1, ns1, voi1):
        if voiced is not None and win_family_unvoiced is not None:
            return pitch_sync_frames(sig1, pm1, nf1, ns1, fft_len,
                                     win_family, voi1,
                                     win_family_unvoiced)[0]
        return pitch_sync_frames(sig1, pm1, nf1, ns1, fft_len,
                                 win_family)[0]

    voi_b = voiced if voiced is not None else jnp.zeros_like(pm, bool)
    frames = jax.vmap(one)(sig, pm, nfrms, n_sig, voi_b)
    return frames, L, R, valid


def ola_centered_batch(frames: jnp.ndarray, pm: jnp.ndarray,
                       nfrms: jnp.ndarray, out_len_max: int) -> jnp.ndarray:
    """Batched ola_centered: frames (B,F,N), pm (B,F) -> (B, out_len_max)."""
    return jax.vmap(lambda fr, p, nf: ola_centered(fr, p, nf, out_len_max))(
        frames, pm, nfrms)


def ar_winlens(shifts: jnp.ndarray, nfrms: jnp.ndarray):
    """(winlen_l, winlen_r) (F,) of the anti-ringing window per frame.

    shifts: (F,) int32 frame shifts; the reference extends them as
    [s0, s..., s_last, s_last] and uses winlen_l = s[f]+s[f+1],
    winlen_r = s[f+2]+s[f+3] on the extended array (magphase.py:969-971).
    """
    F = shifts.shape[0]
    f = jnp.arange(F)
    last = jnp.maximum(nfrms - 1, 0)

    def s_ext(i):  # shifts_ext[i] for i in [0, nfrms+3)
        j = jnp.clip(i - 1, 0, last)     # ext: [s0, s0..s_{n-1}, s_{n-1}, s_{n-1}]
        return jnp.take(shifts, j, axis=0)

    return s_ext(f) + s_ext(f + 1), s_ext(f + 2) + s_ext(f + 3)


def apply_anti_ringing(frames: jnp.ndarray, shifts: jnp.ndarray,
                       nfrms: jnp.ndarray) -> jnp.ndarray:
    """Per-frame centred raised-hanning anti-ringing window over a
    two-pitch-period support (magphase.py:968-973).

    Specialised (bitwise-identical) form of
    ``W.centr_win_value(..., RAISED_HANNING, att=1.0, fill_bound=True)``:
    at att=1.0 the profile is plain hanning, so the ``fill_bound`` value
    h(t(q=0)) collapses to 0 for L>0 and 1 for L==0 — a per-frame (F, 1)
    select — where the generic form re-evaluated the fill's whole
    divide+cos chain at every (frame, sample) element.  The window value
    itself stays on the shared ``W.asym_win_value`` helper so the
    profile formulas live in one place (the equality is pinned in
    tests/test_framing.py)."""
    F, fft_len = frames.shape
    winlen_l, winlen_r = ar_winlens(shifts, nfrms)
    Lw = winlen_l[:, None]
    Rw = winlen_r[:, None]
    p = jnp.arange(fft_len)[None, :]
    q = p - (fft_len // 2 - Lw)
    w = W.asym_win_value(jnp.clip(q, 0, Lw + Rw), Lw, Rw,
                         W.RAISED_HANNING, att=1.0)
    inside = (q >= 0) & (q <= Lw + Rw)
    fill = jnp.where(Lw > 0, 0.0, 1.0)
    return frames * jnp.where(inside, w, fill)
