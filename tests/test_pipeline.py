"""utils/pipeline.py: threaded stage pipeline semantics."""
import threading
import time

import pytest

from magphase_jax.utils.pipeline import run_staged


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_order_and_results(depth):
    out = list(run_staged(range(20), [lambda x: x + 1,
                                      lambda x: x * 2,
                                      lambda x: x - 3], depth=depth))
    assert out == [(x + 1) * 2 - 3 for x in range(20)]


def test_stages_overlap_in_time():
    """Three 30 ms stages over 6 items: serial = 540 ms, pipelined
    ~= 240 ms.  Gate at < 450 ms (loose for CI noise)."""
    def slow(x):
        time.sleep(0.03)
        return x

    t0 = time.perf_counter()
    out = list(run_staged(range(6), [slow, slow, slow]))
    dt = time.perf_counter() - t0
    assert out == list(range(6))
    assert dt < 0.45, dt


def test_stage_exception_propagates():
    def boom(x):
        if x == 3:
            raise ValueError("boom")
        return x

    with pytest.raises(ValueError, match="boom"):
        list(run_staged(range(10), [lambda x: x, boom, lambda x: x]))
    # no stuck threads
    time.sleep(0.2)
    assert all(not t.name.startswith("pipeline")
               for t in threading.enumerate() if t.daemon is False)


def test_early_abandon_does_not_hang():
    pipe = run_staged(range(100), [lambda x: x, lambda x: x])
    it = iter(pipe)
    got = [next(it) for _ in range(3)]
    assert got == [0, 1, 2]
    pipe.close()


def test_eager_start():
    """Work begins at construction, before the caller pulls results."""
    seen = []
    pipe = run_staged(range(4), [lambda x: seen.append(x) or x])
    deadline = time.time() + 2.0
    while not seen and time.time() < deadline:
        time.sleep(0.01)
    assert seen, "stage did not start before iteration"
    assert list(pipe) == [0, 1, 2, 3]


def test_empty_stages_and_items():
    assert list(run_staged([1, 2], [])) == [1, 2]
    assert list(run_staged([], [lambda x: x])) == []


def test_reiteration_raises():
    """Pipelines are single-shot: a second iteration would silently
    yield nothing (queues drained, threads joined) — it must raise."""
    pipe = run_staged(range(5), [lambda x: x])
    assert list(pipe) == list(range(5))
    with pytest.raises(RuntimeError, match="single-shot"):
        list(pipe)
