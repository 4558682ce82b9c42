"""Observability: structured logging, stage timers, throughput counters.

The reference's only observability is print statements (SURVEY.md §5).
Here: a lightweight metrics registry with stage timers and audio-seconds/s
counters, optional multi-host reduction via psum, and jax.profiler hooks.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict

logger = logging.getLogger("magphase_jax")


def setup_logging(level=logging.INFO) -> None:
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)


class Metrics:
    """Accumulates per-stage wall time and audio seconds processed."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.audio_seconds = 0.0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    def throughput(self, stage: str | None = None) -> float:
        t = self.times[stage] if stage else sum(self.times.values())
        return self.audio_seconds / t if t > 0 else 0.0

    def reduce_across_hosts(self):
        """Sum audio_seconds over all processes (psum over a throwaway
        mesh); no-op single-host."""
        import jax
        if jax.process_count() == 1:
            return self
        import jax.numpy as jnp
        total = jax.device_get(
            jax.pmap(lambda x: jax.lax.psum(x, "i"), axis_name="i")(
                jnp.asarray([self.audio_seconds])))[0]
        self.audio_seconds = float(total)
        return self

    def summary(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "stages": {k: {"s": round(v, 3), "n": self.counts[k]}
                       for k, v in self.times.items()},
            "audio_s_per_s": round(self.throughput(), 2),
        }

    def log_summary(self) -> None:
        logger.info("metrics %s", json.dumps(self.summary()))


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """jax.profiler trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
