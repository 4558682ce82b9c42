"""Window functions as closed-form elementwise profiles.

The reference builds pitch-synchronous *asymmetric* windows by concatenating
the left half of ``win(2L+1)`` and the flipped right half of ``win(2R+1)``
(``la.gen_non_symmetric_win``, /root/reference/src/libaudio.py:70-84).  For
all window families used in live paths this has a closed form: with the
half-profile h(t), t in [0,1] from edge to peak,

    w[q] = h(q/L)            for q <= L     (left side)
    w[q] = h((L+R-q)/R)      for q >  L     (right side)

because  np.hanning(2L+1)[k] = 0.5-0.5*cos(pi*k/L)  and
         np.bartlett(2L+1)[k] = k/L.

That closed form is what lets the ragged per-frame Python loops of the
reference (magphase.py:74-119) become one dense vectorised gather on device:
window values are computed on the fly from (q, L, R) integer tensors, no
per-frame window materialisation.

Window family ids (static ints for jit):
    0 = hanning          (np.hanning)
    1 = voi_noise        (np.bartlett ** 2.5, magphase.py:67-68)
    2 = boxcar           (no window)
    3 = raised_hanning   (att-parameterised, magphase.py:25-31; att=1 == hanning)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

HANNING = 0
VOI_NOISE = 1
BOXCAR = 2
RAISED_HANNING = 3


def _half_profile(t: jnp.ndarray, family: int, att: float = 1.0) -> jnp.ndarray:
    """h(t): half-window profile, t in [0, 1] measured edge -> peak."""
    if family == HANNING:
        return 0.5 - 0.5 * jnp.cos(jnp.pi * t)
    if family == VOI_NOISE:
        # t^2.5 as t*t*sqrt(t): jnp.power lowers to exp(2.5*log t) —
        # slower AND less accurate than the explicit form
        tc = jnp.clip(t, 0.0, 1.0)
        return tc * tc * jnp.sqrt(tc)
    if family == BOXCAR:
        return jnp.ones_like(t)
    if family == RAISED_HANNING:
        return (1.0 - att) + att * (0.5 - 0.5 * jnp.cos(jnp.pi * t))
    raise ValueError(f"unknown window family {family}")


def asym_win_value(q: jnp.ndarray, L: jnp.ndarray, R: jnp.ndarray,
                   family: int, att: float = 1.0) -> jnp.ndarray:
    """Value of the asymmetric window at integer offset ``q`` in a frame with
    left length L and right length R (total length L+R+1, peak at q=L).

    Exactly gen_non_symmetric_win (libaudio.py:70-84): for L==0 the left part
    is win(1) == [1.0]; same for R==0.
    """
    q = q.astype(jnp.float32)
    Lf = L.astype(jnp.float32)
    Rf = R.astype(jnp.float32)
    t_left = jnp.where(Lf > 0, q / jnp.maximum(Lf, 1.0), 1.0)
    t_right = jnp.where(Rf > 0, (Lf + Rf - q) / jnp.maximum(Rf, 1.0), 1.0)
    t = jnp.where(q <= Lf, t_left, t_right)
    return _half_profile(t, family, att)


def asym_win_value_select(q, L, R, voiced, fam_voiced: int, fam_unvoiced: int,
                          att: float = 1.0):
    """Per-frame window-family selection (noise windowing,
    magphase.py:886-892: bartlett^2.5 on voiced frames, hanning otherwise)."""
    wv = asym_win_value(q, L, R, fam_voiced, att)
    wu = asym_win_value(q, L, R, fam_unvoiced, att)
    return jnp.where(voiced, wv, wu)


def centr_win_value(p: jnp.ndarray, winlen_l: jnp.ndarray,
                    winlen_r: jnp.ndarray, totlen: int, family: int,
                    att: float = 1.0, fill_bound: bool = False) -> jnp.ndarray:
    """gen_centr_win (libaudio.py:90-103): the asymmetric window placed with
    its peak at floor(totlen/2); outside its support, 0 (or the window's
    first value when ``fill_bound``).

    ``p`` indexes the full frame [0, totlen).
    """
    nx_cntr = totlen // 2
    q = p - (nx_cntr - winlen_l)          # offset into the short window
    inside = (q >= 0) & (q <= winlen_l + winlen_r)
    w = asym_win_value(jnp.clip(q, 0, winlen_l + winlen_r), winlen_l,
                       winlen_r, family, att)
    if fill_bound:
        fill = asym_win_value(jnp.zeros_like(q), winlen_l, winlen_r,
                              family, att)
    else:
        fill = jnp.zeros_like(w)
    return jnp.where(inside, w, fill)


# ---------------------------------------------------------------------------
# NumPy-side references (host-side utilities + test oracles)

def hanning_np(M: int) -> np.ndarray:
    return np.hanning(M)


def gen_non_symmetric_win_np(left_len: int, right_len: int, win_func=np.hanning,
                             b_norm: bool = False) -> np.ndarray:
    """Direct host-side port of libaudio.py:70-84 (oracle for tests)."""
    v_left = win_func(1 + 2 * left_len)[:left_len + 1]
    v_right = np.flipud(win_func(1 + 2 * right_len)[:right_len + 1])
    v_win = np.hstack((v_left, v_right[1:]))
    if b_norm:
        v_win = v_win / np.sum(v_win)
    return v_win


def voi_noise_window_np(length: int) -> np.ndarray:
    return np.bartlett(length) ** 2.5
