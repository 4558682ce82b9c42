"""Closed-form window values vs direct numpy ports of the reference
formulas (libaudio.py:70-103, magphase.py:25-31, 67-68)."""
import numpy as np
import jax.numpy as jnp

from magphase_jax.core import windows as W


def _np_centr_win(winlen_l, winlen_r, totlen, win_func, fill_bound):
    """Direct port of gen_centr_win (libaudio.py:90-103) as oracle."""
    v_short = W.gen_non_symmetric_win_np(winlen_l, winlen_r, win_func)
    nx_cntr = int(np.floor(totlen / 2.0))
    nzeros_l = nx_cntr - winlen_l
    v_win = np.zeros(totlen)
    if fill_bound:
        v_win += v_short[0]
    v_win[nzeros_l:nzeros_l + len(v_short)] = v_short
    return v_win


def test_asym_hanning_matches_reference():
    for L, R in [(7, 12), (1, 1), (0, 5), (5, 0), (100, 37), (240, 240)]:
        oracle = W.gen_non_symmetric_win_np(L, R, np.hanning)
        q = jnp.arange(L + R + 1)
        got = W.asym_win_value(q, jnp.int32(L), jnp.int32(R), W.HANNING)
        np.testing.assert_allclose(np.asarray(got), oracle, atol=1e-6)


def test_asym_voi_noise_matches_reference():
    for L, R in [(7, 12), (33, 20), (1, 2)]:
        oracle = W.gen_non_symmetric_win_np(L, R, W.voi_noise_window_np)
        q = jnp.arange(L + R + 1)
        got = W.asym_win_value(q, jnp.int32(L), jnp.int32(R), W.VOI_NOISE)
        np.testing.assert_allclose(np.asarray(got), oracle, atol=5e-6)


def test_asym_boxcar():
    q = jnp.arange(10)
    got = W.asym_win_value(q, jnp.int32(4), jnp.int32(5), W.BOXCAR)
    np.testing.assert_allclose(np.asarray(got), np.ones(10))


def test_centr_win_matches_reference():
    def raised_hanning(n):
        return np.hanning(n)  # att=1.0 (magphase.py:25-31)

    for L, R, T, fill in [(100, 120, 4096, True), (30, 31, 4096, False),
                          (10, 10, 64, True)]:
        oracle = _np_centr_win(L, R, T, raised_hanning, fill)
        p = jnp.arange(T)
        got = W.centr_win_value(p, jnp.int32(L), jnp.int32(R), T,
                                W.RAISED_HANNING, att=1.0, fill_bound=fill)
        np.testing.assert_allclose(np.asarray(got), oracle, atol=1e-6)


def test_adjacent_hanning_windows_sum_to_one():
    """The lossless-reconstruction property: right half of frame f plus left
    half of frame f+1 sum to 1 over their shared pitch period."""
    R = 137
    q_right = jnp.arange(1, R)  # interior of the shared period
    w_f = W.asym_win_value(jnp.int32(50) + q_right, jnp.int32(50),
                           jnp.int32(R), W.HANNING)
    w_f1 = W.asym_win_value(q_right, jnp.int32(R), jnp.int32(99), W.HANNING)
    np.testing.assert_allclose(np.asarray(w_f + w_f1), np.ones(R - 1),
                               atol=1e-6)
