"""Batched corpus runner: chunk fault isolation, crash list, resume."""
import os

from magphase_jax.utils.corpus import run_corpus_batched


def test_batched_isolation_and_resume(tmp_path):
    out = str(tmp_path / "feats")
    crash = str(tmp_path / "crash.scp")
    tokens = [f"utt_{i:02d}" for i in range(10)]
    calls = []

    def process_batch(chunk):
        calls.append(tuple(chunk))
        if "utt_04" in chunk:
            raise RuntimeError("bad wav")
        return [1.0] * len(chunk)

    res = run_corpus_batched(tokens, process_batch, out, batch_size=4,
                             crash_list_path=crash)
    # only the bad utterance fails; its chunk-mates succeed via retries
    assert res.failed == ["utt_04"]
    assert sorted(res.done) == sorted(t for t in tokens if t != "utt_04")
    with open(crash) as f:
        assert f.read().split() == ["utt_04"]
    # the failing chunk was retried one token at a time
    assert ("utt_04",) in calls

    # resume: everything done is skipped, the failed token is retried
    calls.clear()

    def process_batch_ok(chunk):
        calls.append(tuple(chunk))
        return [1.0] * len(chunk)

    res2 = run_corpus_batched(tokens, process_batch_ok, out, batch_size=4,
                              crash_list_path=crash)
    assert res2.done == ["utt_04"]
    assert len(res2.skipped) == 9
    assert calls == [("utt_04",)]


def test_batched_deferred_pipeline(tmp_path):
    """process_batch_fn returning finalize() callables: chunks overlap,
    failures inside finalize still isolate to the bad utterance."""
    out = str(tmp_path / "feats")
    tokens = [f"utt_{i:02d}" for i in range(12)]
    events = []

    def process_batch(chunk):
        events.append(("dispatch", tuple(chunk)))

        def finalize():
            events.append(("finalize", tuple(chunk)))
            if "utt_06" in chunk and len(chunk) > 1:
                raise RuntimeError("bad utterance in finalize")
            return [1.0] * len(chunk)

        return finalize

    res = run_corpus_batched(tokens, process_batch, out, batch_size=4,
                             pipeline_depth=2)
    assert sorted(res.done) == tokens          # singles recover utt_06
    assert res.failed == []
    # pipelining: the second chunk was dispatched before the first finalized
    d1 = events.index(("dispatch", tuple(tokens[4:8])))
    f0 = events.index(("finalize", tuple(tokens[0:4])))
    assert d1 < f0
