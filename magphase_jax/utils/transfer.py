"""Host->device upload helper: big arrays go up as per-chunk-blocking
row slices.

Where a device_get issued behind an in-flight device_put waits for the
whole put, a pipeline that uploads each group as one big
tensor stalls its download thread for up to a whole group upload per
get; uploading the same bytes as per-chunk-blocking slices bounds that
stall at one chunk.  Whether this pays over PCIe is not measured.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["device_put_chunked", "upload_chunk_bytes"]


def upload_chunk_bytes() -> int:
    """Chunk size for big pipeline uploads (0 disables chunking).

    Default 8 MB: big enough that the per-chunk round trip is a small
    share of the chunk's transfer, small enough that a concurrent
    download's head-of-line stall is one chunk instead of a whole group.
    MAGPHASE_UPLOAD_CHUNK_MB overrides (A/B knob)."""
    return int(float(os.environ.get("MAGPHASE_UPLOAD_CHUNK_MB", "8"))
               * (1 << 20))


def device_put_chunked(arr: np.ndarray, chunk_bytes: int | None = None,
                       lookahead: int = 2):
    """Upload ``arr`` as per-chunk-blocking row slices; returns the
    device array (one device-side concatenate when chunked).

    Each chunk's ``block_until_ready`` paces the stream so a concurrent
    device_get waits at most ``lookahead + 1`` chunks; ``lookahead``
    chunks ride ahead unblocked to hide the per-chunk round trip.
    Arrays at or below one chunk (or with chunking disabled) take the
    plain single-put path.  Synchronous by contract: the returned array
    is fully transferred (the big-tensor upload stages rely on this to
    pay the upload on THEIR thread, not inside the next dispatch)."""
    if chunk_bytes is None:
        chunk_bytes = upload_chunk_bytes()
    if (chunk_bytes <= 0 or arr.ndim == 0 or arr.shape[0] < 2
            or arr.nbytes <= chunk_bytes):
        buf = jnp.asarray(arr)
        jax.block_until_ready(buf)
        return buf
    rows_per = max(1, int(chunk_bytes // max(arr.nbytes // arr.shape[0],
                                             1)))
    pend, parts = [], []
    for i in range(0, arr.shape[0], rows_per):
        b = jnp.asarray(arr[i:i + rows_per])
        parts.append(b)
        pend.append(b)
        if len(pend) > lookahead:
            jax.block_until_ready(pend.pop(0))
    for p in pend:
        jax.block_until_ready(p)
    out = jnp.concatenate(parts, axis=0)
    jax.block_until_ready(out)
    return out
