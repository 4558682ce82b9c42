"""Pallas kernel (Triton route) for the epoch-placement walk.

The walk (epochs/placement_device.py:place_epochs_kernel, re-stating the
host loop of epochs/tracker.py:place_epochs — reference semantics:
REAPER's epoch placement consumed via libaudio.py:421-447) is a serial
per-mark recurrence: each mark's position feeds the next window search.
As a vmapped ``lax.while_loop`` the whole batch steps in lockstep until
its LONGEST utterance finishes, and every loop trip is a device-side
predicate plus several kernel launches.

Here one program walks ONE utterance with the recurrence as an
in-kernel loop, so each utterance stops at its own last mark and no
step leaves the GPU thread block.  A voiced step loads one
power-of-two window of the snap signal covering the trough-search span
[lo, hi) and takes its first minimum; an unvoiced step is a scalar add.

Exactness contract: identical (marks, flags, n_marks) to
``place_epochs_kernel``.  All float arithmetic (period from f0, the
0.65/1.35 and 0.85/1.15 window bounds) is done ONCE per frame by
``placement_device.walk_tables`` — the same XLA code the XLA walk reads
— so the kernel itself is integer-only.  The frame lookup uses the
integer quotient t // frame_step, equal to the XLA walk's
int(float32(t) / frame_step) for integral frame steps and t < 2^24
samples (~349 s at 48 kHz); placement_device.place_epochs_batch keeps
the XLA walk for longer signal buckets.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..epochs.tracker import SNAP_ONSET_MARKS


def _walk_kernel(tab_ref, nsig_ref, nfrm_ref, y_ref, marks_ref, flags_ref,
                 nm_ref, *, m_max: int, step: int, unv_step: int, win: int):
    b = pl.program_id(0)
    S = y_ref.shape[1]
    n_sig = nsig_ref[b]
    fr_max = jnp.maximum(nfrm_ref[b] - 1, 0)
    offs = jax.lax.broadcasted_iota(jnp.int32, (win,), 0)

    def cond(c):
        return ~c[3]

    def body(c):
        t, n_marks, run_len, done, prev = c
        fr = jnp.minimum(jax.lax.div(t, jnp.int32(step)), fr_max)
        is_voi = tab_ref[b, 0, fr] > 0
        wide = run_len < SNAP_ONSET_MARKS
        p_lo = jnp.where(wide, tab_ref[b, 1, fr], tab_ref[b, 3, fr])
        p_hi = jnp.where(wide, tab_ref[b, 2, fr], tab_ref[b, 4, fr])
        lo = t + p_lo
        hi = jnp.minimum(n_sig - 1, t + p_hi)

        def trough():
            # the window [base, base+win) covers [lo, hi): hi - lo is at
            # most the snap span, which win bounds; the clamp keeps the
            # load inside the row near its end (hi <= n_sig-1 < S)
            base = jnp.clip(lo, 0, S - win)
            pos = base + offs
            vals = jnp.where((pos >= lo) & (pos < hi),
                             y_ref[b, pl.ds(base, win)], jnp.inf)
            return base + jnp.argmin(vals).astype(jnp.int32)

        nxt = jax.lax.cond(is_voi, trough, lambda: t + unv_step)
        # monotonicity guard (tracker.place_epochs)
        min_adv = jnp.where(is_voi, jnp.maximum(1, p_lo), 1)
        nxt = jnp.where(nxt <= prev, prev + min_adv, nxt)
        ok = (~done) & (nxt < n_sig - 1) & (hi > lo + 1) & \
            (n_marks < m_max)

        @pl.when(ok)
        def _():
            marks_ref[b, n_marks] = nxt
            flags_ref[b, n_marks] = is_voi.astype(jnp.float32)

        run_len = jnp.where(ok & is_voi, run_len + 1,
                            jnp.where(ok, 0, run_len))
        return (jnp.where(ok, nxt, t), jnp.where(ok, n_marks + 1, n_marks),
                run_len, done | ~ok, jnp.where(ok, nxt, prev))

    init = (jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.bool_(False),
            jnp.int32(-1))
    nm_ref[b] = jax.lax.while_loop(cond, body, init)[1]


@functools.partial(jax.jit, static_argnames=("m_max", "step", "unv_step",
                                             "win", "interpret"))
def place_epochs_pallas(y_snap, tab, n_sigs, n_frames, *, m_max: int,
                        step: int, unv_step: int, win: int,
                        interpret: bool = False):
    """Batched epoch walk, one Triton program per utterance.

    y_snap: (B, S) f32 snap signal with S >= win; tab: (B, 5, T) int32
    per-frame walk table (placement_device.walk_tables); n_sigs/n_frames:
    (B,) int32.  ``win`` is a power of two >= the widest trough span.
    Returns (marks (B, m_max) i32, flags (B, m_max) f32, n_marks (B,)).
    """
    B, S = y_snap.shape
    assert win & (win - 1) == 0 and S >= win, (win, S)
    kern = functools.partial(_walk_kernel, m_max=m_max, step=step,
                             unv_step=unv_step, win=win)
    marks, flags, nm = pl.pallas_call(
        kern,
        grid=(B,),
        out_shape=(jax.ShapeDtypeStruct((B, m_max), jnp.int32),
                   jax.ShapeDtypeStruct((B, m_max), jnp.float32),
                   jax.ShapeDtypeStruct((B,), jnp.int32)),
        backend="triton",
        # 4 warps: 1, 2 and 8 measured no faster on an H100
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="epoch_walk",
    )(tab, n_sigs.astype(jnp.int32), n_frames.astype(jnp.int32), y_snap)
    # the kernel writes only the placed marks; the rest reads as zeros,
    # as in the XLA walk
    live = jnp.arange(m_max)[None, :] < nm[:, None]
    return jnp.where(live, marks, 0), jnp.where(live, flags, 0.0), nm
