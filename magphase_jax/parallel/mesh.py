"""Device mesh and sharding helpers.

The reference's only parallelism is a multiprocessing.Pool fan-out over
utterances (libutils.py:32-63).  Here the corpus batch axis is a first-class
``data`` mesh axis: utterance tensors are sharded over devices with
NamedSharding and every kernel is batch-vectorised, so XLA partitions the
whole vocoder pipeline with zero cross-device communication (collectives
appear only for metric reductions).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over all (or the first n) devices, axis name 'data'."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("data",))


def shard_batch(mesh: Mesh, *arrays):
    """Place arrays with their leading (batch) axis sharded over 'data'."""
    out = []
    for a in arrays:
        spec = P("data", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return out if len(out) > 1 else out[0]


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


_SHARDED_CACHE: dict = {}


def sharded_kernel(impl, mesh: Mesh, n_args: int, static_kw: dict):
    """jit(shard_map(impl)) over the 1-D data mesh, cached.

    Vocoding is embarrassingly parallel per utterance, so every batched
    kernel runs under shard_map with ALL operands (and outputs) sharded on
    the leading batch axis — each device executes the whole pipeline on its
    local batch rows and inter-device communication is impossible by
    construction.  (Letting GSPMD partition the jit instead was measured to
    ALL-GATHER every FFT operand — the partitioner has no batch-parallel
    rule for the FFT op — replicating the dominant FLOPs on every device;
    see __graft_entry__._dryrun_collectives_proof, which pins the compiled
    HLO of these wrappers to contain zero collectives.)

    The returned callable is cached on (impl, mesh, n_args, static items):
    a fresh shard_map/jit per call would recompile every time (CLAUDE.md
    design rule).  static_kw values must be hashable.
    """
    key = (impl, mesh, n_args, tuple(sorted(static_kw.items())))
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        import functools
        body = functools.partial(impl, **static_kw)
        fn = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=tuple([P("data")] * n_args),
            out_specs=P("data"), check_vma=False))
        _SHARDED_CACHE[key] = fn
    return fn


def pad_batch_to_devices(n: int, n_devices: int) -> int:
    """Batch size padded to a multiple of the device count."""
    return int(np.ceil(n / n_devices)) * n_devices


def capped_batch_step(mesh: Mesh | None, max_b: int, base: int = 8) -> int:
    """batch_step capped by an HBM row budget.  Both operands are already
    multiples of the mesh size (batch_step lcm's it; callers mesh-round
    max_b), so the min preserves even sharding."""
    return min(batch_step(mesh, base), max(1, max_b))


def batch_step(mesh: Mesh | None, base: int = 8) -> int:
    """Bucket step for the batch axis: a multiple of ``base`` (compile-
    variant bounding) that the mesh size divides (even sharding)."""
    import math
    if mesh is None:
        return base
    return math.lcm(base, mesh.size)


def budget_batch_cap(mesh: Mesh | None, max_b: int, base: int = 8) -> int:
    """Round an HBM-derived batch cap DOWN so batch-axis bucketing never
    exceeds it: bucket(n <= cap, capped_batch_step(mesh, cap)) <= cap.

    Caps at or above the batch step become multiples of the step (a raw
    cap of e.g. 9 would otherwise bucket a 9-utterance group up to 16 —
    1.78x the HBM budget); smaller caps are kept, rounded to the mesh
    size so one program still shards evenly (a cap below the mesh size
    is forced up to it — sharding needs at least one row per device)."""
    step = batch_step(mesh, base)
    if max_b >= step:
        return (max_b // step) * step
    if mesh is not None:
        return max(mesh.size, (max_b // mesh.size) * mesh.size)
    return max(1, max_b)


def partition_tokens(tokens, process_index: int | None = None,
                     process_count: int | None = None, weights=None):
    """This host's share of a corpus token list.

    Corpus work is embarrassingly parallel per utterance, so multi-host
    runs partition TOKENS across processes (each host batching over its
    local devices) instead of coordinating one global array — the
    reference's Pool-over-utterances (libutils.py:32-63) generalised to
    hosts.

    ``weights``: optional per-token durations (audio seconds, or any
    proportional cost).  When given, tokens are assigned greedy
    longest-first to the least-loaded host (LPT bin packing) — the
    static analogue of Pool's dynamic self-balancing (libutils.py:61);
    measured min/max per-host audio >= 0.9 at 2 and 4 hosts on the demo
    corpus vs 0.64 for round-robin (SCALING.md).  Without weights:
    round-robin.  Deterministic either way, and every host computes the
    same global assignment from the same scp, so shards are always a
    disjoint cover; per-utterance noise keys derive from the GLOBAL scp
    index, so partitioning never changes any output byte.  This host's
    tokens are returned in original scp order."""
    if process_count is None:
        process_count = jax.process_count()
        process_index = jax.process_index()
    if process_count <= 1:
        return list(tokens)
    tokens = list(tokens)
    if weights is None:
        return tokens[process_index::process_count]
    if len(weights) != len(tokens):
        raise ValueError(f"weights length {len(weights)} != "
                         f"tokens length {len(tokens)}")
    # LPT: heaviest first, each onto the least-loaded host; ties broken
    # by (load, host_index) and by original index within equal weights,
    # so the assignment is identical on every host
    order = sorted(range(len(tokens)), key=lambda i: (-float(weights[i]), i))
    loads = [0.0] * process_count
    mine = []
    for i in order:
        h = min(range(process_count), key=lambda j: (loads[j], j))
        loads[h] += float(weights[i])
        if h == process_index:
            mine.append(i)
    return [tokens[i] for i in sorted(mine)]


def maybe_initialize_distributed() -> None:
    """Multi-host initialisation — MUST run before any other JAX call
    (jax.distributed.initialize raises once the XLA backend exists, and
    even jax.process_count() initialises it).  Gated purely on the
    coordinator env var; idempotent."""
    import os
    if "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return
    if jax.distributed.is_initialized():
        return
    # num_processes/process_id have NO env fallback inside
    # jax.distributed.initialize (only Slurm/MPI/K8s cluster detection)
    # — honour the conventional env vars so bare-metal and CPU-emulated
    # multi-process launches work
    kw = {}
    if "JAX_NUM_PROCESSES" in os.environ:
        kw["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if "JAX_PROCESS_ID" in os.environ:
        kw["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    # real init failures (unreachable/mistyped coordinator) must surface:
    # silently degrading to process_count=1 would make every host process
    # the FULL corpus and race on one shared manifest
    jax.distributed.initialize(**kw)
