"""Host-side fan-out over utterances (libutils.py:32-63 parity).

The reference's entire parallelism strategy is ``multiprocessing.Pool().map``
over wav files, one process per core.  Here the heavy compute runs on the
accelerator inside jitted kernels, so host fan-out must NOT fork the process
(JAX runtimes are not fork-safe and each process would contend for the same
chip).  ``run_multithreaded`` therefore uses a thread pool: threads overlap
the host-side work (file IO, padding, feature packing) while device work
serialises naturally on the JAX stream.  For true multi-chip scale-out use
``magphase_jax.parallel`` (batched, pjit-sharded pipelines) instead.
"""
from __future__ import annotations

from multiprocessing.pool import ThreadPool


def run_multithreaded(func, *args, n_workers: int | None = None) -> list:
    """Reference-compatible fan-out (libutils.py:32-63): each ``list``
    argument is iterated element-wise, every other argument is broadcast
    to all runs.  Returns the list of per-run results (the reference
    discards them; we keep them)."""
    nruns = None
    for a in args:
        if isinstance(a, list):
            nruns = len(a)
            break
    if nruns is None:
        raise ValueError("run_multithreaded: at least one argument must be "
                         "a list (the per-run axis)")

    calls = []
    for r in range(nruns):
        calls.append(tuple(a[r] if isinstance(a, list) else a for a in args))

    with ThreadPool(n_workers) as pool:
        return pool.map(lambda c: func(*c), calls)
