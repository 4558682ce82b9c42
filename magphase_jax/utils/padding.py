"""Static-shape bucketing helpers.

Under jit every distinct array shape triggers a recompile, so host wrappers
pad signals / frame counts up to a small set of bucket sizes.
"""
from __future__ import annotations

import functools

import numpy as np


def bucket(n: int, step: int) -> int:
    """Smallest multiple of ``step`` >= n (>= step)."""
    return max(step, int(np.ceil(n / step)) * step)


SIG_STEP = 1 << 15       # 32768 samples (~0.68 s @ 48 kHz)
FRM_STEP = 128           # frames


def _geom_grid(ratio: float = 1.25, max_units: int = 4096):
    """1, 2, 3, 4, 5, 7, 9, 12, ... — ~ratio-spaced integer unit counts."""
    grid = [1]
    while grid[-1] < max_units:
        grid.append(max(grid[-1] + 1, int(np.ceil(grid[-1] * ratio))))
    return np.asarray(grid)


_SIG_GRID = _geom_grid() * SIG_STEP


# Device-memory budget for fused programs, in frame row-elements
# (frame_rows * fft_len per device program).  The staged FFT keeps ~10
# full-size f32 temporaries live and the analysis pipeline another ~6
# stream-sized buffers, so peak device memory is about
# rows * fft_len * BYTES_PER_ROW_ELEM bytes.  MAX_FRAME_ELEMS is the
# budget where the device reports no memory stats (the CPU backend);
# elsewhere max_frame_elems() derives it from the device's allocator limit.
BYTES_PER_ROW_ELEM = 64
MAX_FRAME_ELEMS = 192 << 20
_BUDGET_SHARE = 0.75        # of the allocator limit; the rest is headroom


def frame_elems_from_stats(stats) -> int:
    """Row-element budget for a device with ``memory_stats()`` ``stats``
    (None or without ``bytes_limit``: the fixed MAX_FRAME_ELEMS)."""
    if not stats or not stats.get("bytes_limit"):
        return MAX_FRAME_ELEMS
    return int(stats["bytes_limit"] * _BUDGET_SHARE) // BYTES_PER_ROW_ELEM


@functools.lru_cache(maxsize=None)
def max_frame_elems() -> int:
    """Row-element budget of one device program on this process's first
    local device (multi-process runs cannot query the others)."""
    import jax
    return frame_elems_from_stats(jax.local_devices()[0].memory_stats())


def bucket_signal(n: int) -> int:
    """Geometric signal-length bucket (multiples of SIG_STEP, ~1.25x
    spaced).

    Linear SIG_STEP bucketing creates one compiled program variant per
    32768 samples of corpus length spread (~90 variants for a 60 s
    utterance at 48 kHz, each its own compile); the geometric grid
    bounds variants logarithmically at <=25% padding waste — and padding
    in the signal axis costs little since frame-axis transfers are
    trimmed to realised counts.
    """
    i = int(np.searchsorted(_SIG_GRID, n))
    if i >= len(_SIG_GRID):
        # beyond the grid (> ~47 min at 48 kHz): plain linear bucketing —
        # NEVER return a bucket smaller than n
        return bucket(n, SIG_STEP)
    return int(_SIG_GRID[i])


_FRM_GRID = _geom_grid() * FRM_STEP


def bucket_frames(n: int) -> int:
    """Geometric frame-count bucket (multiples of FRM_STEP, ~1.25x
    spaced).  Realised mark counts vary per chunk by CONTENT, so linear
    bucketing would compile one program variant per 128-frame step;
    the geometric grid bounds variants logarithmically."""
    i = int(np.searchsorted(_FRM_GRID, n))
    if i >= len(_FRM_GRID):
        return bucket(n, FRM_STEP)
    return int(_FRM_GRID[i])


def pad_to(arr: np.ndarray, n: int, axis: int = 0, value=0) -> np.ndarray:
    pad = n - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=value)


def pad_rows(a, n: int, value=0):
    """Pad a DEVICE array's leading axis to ``n`` rows (jnp concatenate);
    the device-side analogue of pad_to for already-uploaded tensors."""
    import jax.numpy as jnp
    a = jnp.asarray(a)
    pad = n - a.shape[0]
    if pad <= 0:
        return a
    return jnp.concatenate(
        [a, jnp.full((pad,) + a.shape[1:], value, a.dtype)], axis=0)
