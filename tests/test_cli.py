"""End-to-end CLI: extraction, generation, label conversion — the
reference's L4 batch-script workflows (SURVEY.md §3.2-3.4)."""
import os
import shutil

import numpy as np
import pytest

from magphase_jax.cli import main as cli_main
from magphase_jax.io import read_wav, read_binfile

DATA = "/root/reference/demos/data_48k"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    scp = d / "two.scp"
    scp.write_text("hvd_593\nhvd_594\n")
    pred_scp = d / "pred.scp"
    pred_scp.write_text("hvd_704\nhvd_705\n")
    return d


def test_generate_bad_utterance_isolated(tmp_path):
    """A corrupt/missing utterance mid-corpus: the pipelined fast path
    fails over to the chunk-isolating runner, which retries per
    utterance — the bad token lands on the crash list, every good one
    still renders (the reference's crash-list contract, SURVEY.md §5)."""
    feats = tmp_path / "feats"
    feats.mkdir()
    src = os.path.join(DATA, "params_predicted")
    toks = ["hvd_704", "hvd_705", "hvd_706"]
    for t in toks:
        for ext in (".mag", ".real", ".imag", ".lf0"):
            shutil.copy(os.path.join(src, t + ext), feats / (t + ext))
    # corrupt the middle utterance: truncated .mag (not a multiple of
    # the feature dim -> read_binfile raises)
    with open(feats / "hvd_705.mag", "wb") as f:
        f.write(b"\x00" * 37)
    scp = tmp_path / "gen.scp"
    scp.write_text("\n".join(toks) + "\n")
    out = tmp_path / "wavs"
    crash = tmp_path / "crash.scp"
    rc = cli_main(["generate", "--scp", str(scp), "--feats-dir",
                   str(feats), "--out-dir", str(out), "--fs", "48000",
                   "--batch-size", "2", "--pf-type", "no",
                   "--crash-list", str(crash)])
    assert rc == 1                      # failures reported
    assert (out / "hvd_704.wav").exists()
    assert (out / "hvd_706.wav").exists()
    assert not (out / "hvd_705.wav").exists()
    assert crash.read_text().split() == ["hvd_705"]


def test_extract_bad_wav_isolated(tmp_path):
    """A corrupt wav mid-corpus: extraction's chunk runner isolates it
    via singleton retries; good neighbours still extract."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for tok in ("hvd_593", "hvd_594"):
        shutil.copy(os.path.join(DATA, "wavs_nat", tok + ".wav"),
                    wavs / (tok + ".wav"))
    (wavs / "broken.wav").write_bytes(b"RIFFgarbage")
    scp = tmp_path / "ex.scp"
    scp.write_text("hvd_593\nbroken\nhvd_594\n")
    out = tmp_path / "feats"
    crash = tmp_path / "crash.scp"
    rc = cli_main(["extract", "--scp", str(scp), "--wav-dir", str(wavs),
                   "--out-dir", str(out), "--batch-size", "3",
                   "--crash-list", str(crash)])
    assert rc == 1
    for tok in ("hvd_593", "hvd_594"):
        assert (out / f"{tok}.mag").exists(), tok
    assert not (out / "broken.mag").exists()
    assert crash.read_text().split() == ["broken"]


def test_generate_waveforms(workdir):
    out = workdir / "wavs_syn"
    rc = cli_main(["generate", "--scp", str(workdir / "pred.scp"),
                   "--feats-dir", os.path.join(DATA, "params_predicted"),
                   "--out-dir", str(out), "--fs", "48000",
                   "--pf-type", "magphase", "--batch-size", "2"])
    assert rc == 0
    for tok in ("hvd_704", "hvd_705"):
        sig, fs = read_wav(str(out / f"{tok}.wav"))
        assert fs == 48000
        assert len(sig) > 40000
        assert 0.5 < np.max(np.abs(sig)) <= 1.0   # peak-normalised


def _ensure_feats(workdir):
    """Baseline extracted features (idempotent via the manifest) so tests
    do not depend on execution order."""
    feats = workdir / "feats"
    rc = cli_main(["extract", "--scp", str(workdir / "two.scp"),
                   "--wav-dir", os.path.join(DATA, "wavs_nat"),
                   "--out-dir", str(feats),
                   "--mag-dim", "60", "--phase-dim", "45"])
    assert rc == 0
    return feats


def test_extract_features_and_convert_labels(workdir):
    feats = _ensure_feats(workdir)
    for tok in ("hvd_593", "hvd_594"):
        mag = read_binfile(str(feats / f"{tok}.mag"), dim=60)
        lf0 = read_binfile(str(feats / f"{tok}.lf0"), dim=1)
        shift = read_binfile(str(feats / f"{tok}.shift"), dim=1)
        assert mag.shape[0] == lf0.shape[0] == shift.shape[0]
        assert np.all(shift > 0)
        voiced = lf0 > -1e9
        assert 0.1 < voiced.mean() < 0.9

    # resume: second run must skip everything
    rc = cli_main(["extract", "--scp", str(workdir / "two.scp"),
                   "--wav-dir", os.path.join(DATA, "wavs_nat"),
                   "--out-dir", str(feats),
                   "--mag-dim", "60", "--phase-dim", "45"])
    assert rc == 0

    # label conversion on the extracted shifts
    labs_out = workdir / "labs_var"
    rc = cli_main(["convert-labels", "--scp", str(workdir / "two.scp"),
                   "--shift-dir", str(feats),
                   "--lab-dir", os.path.join(DATA, "labs"),
                   "--out-dir", str(labs_out), "--fs", "48000",
                   "--crash-list", str(workdir / "crash.scp")])
    # conversion may legitimately fail if tracker frame counts disagree
    # with the lab timing beyond tolerance; require at least the files of
    # non-failed utterances to be valid
    done = [t for t in ("hvd_593", "hvd_594")
            if (labs_out / f"{t}.lab").exists()]
    for tok in done:
        lines = (labs_out / f"{tok}.lab").read_text().strip().split("\n")
        starts = [int(l.split()[0]) for l in lines]
        ends = [int(l.split()[1]) for l in lines]
        assert starts[0] == 0
        assert all(e > s for s, e in zip(starts, ends))
        assert all(s2 == e1 for e1, s2 in zip(ends[:-1], starts[1:]))


def test_extract_data_parallel_and_sorted(workdir):
    """--data-parallel shards chunks over the 8 virtual devices; length
    sorting must not change per-utterance features."""
    _ensure_feats(workdir)
    feats_dp = workdir / "feats_dp"
    rc = cli_main(["extract", "--scp", str(workdir / "two.scp"),
                   "--wav-dir", os.path.join(DATA, "wavs_nat"),
                   "--out-dir", str(feats_dp),
                   "--mag-dim", "60", "--phase-dim", "45",
                   "--data-parallel"])
    assert rc == 0
    for tok in ("hvd_593", "hvd_594"):
        a = read_binfile(str(workdir / "feats" / f"{tok}.mag"), dim=60)
        b = read_binfile(str(feats_dp / f"{tok}.mag"), dim=60)
        assert a.shape == b.shape
        assert np.array_equal(a, b)


def test_generate_data_parallel_matches_single_device(workdir, tmp_path):
    """generate --data-parallel (pipelined driver under the 8-device
    shard_map mesh) vs the single-device run: same per-utterance keys
    and composition-independent math, so outputs agree to <= 1 PCM16
    LSB.  (Byte-identity holds for a FIXED device topology — the
    multi-host guarantee — but changing the per-device batch shape
    changes XLA's f32 accumulation order at the ulp level, which can
    flip isolated PCM16 rounding boundaries.)"""
    import wave
    base = tmp_path / "wavs_base"
    dp = tmp_path / "wavs_dp"
    common = ["generate", "--scp", str(workdir / "pred.scp"),
              "--feats-dir", os.path.join(DATA, "params_predicted"),
              "--out-dir", None, "--fs", "48000", "--pf-type", "no",
              "--batch-size", "2"]
    for out, extra in ((base, []), (dp, ["--data-parallel"])):
        args = list(common)
        args[args.index(None)] = str(out)
        assert cli_main(args + extra) == 0
    for tok in ("hvd_704", "hvd_705"):
        def pcm(path):
            with wave.open(str(path)) as w:
                return np.frombuffer(w.readframes(w.getnframes()),
                                     np.int16).astype(np.int32)
        a, b = pcm(base / f"{tok}.wav"), pcm(dp / f"{tok}.wav")
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert d.max() <= 1, (tok, d.max())
        # rounding-boundary flips are rare, not systematic
        assert np.mean(d > 0) < 0.01, (tok, float(np.mean(d > 0)))


def test_generate_fallback_path_byte_identical(workdir, tmp_path,
                                               monkeypatch):
    """The chunk-isolating fallback runner must render byte-identical
    wavs to the pipelined fast path (same global-index keys, same
    det_fft_syn geometry, same blocked high-pass) — a crash mid-corpus
    must not change any utterance's audio on resume."""
    import hashlib
    import magphase_jax.cli as cli_mod

    fast = tmp_path / "wavs_fast"
    slow = tmp_path / "wavs_slow"
    common = ["generate", "--scp", str(workdir / "pred.scp"),
              "--feats-dir", os.path.join(DATA, "params_predicted"),
              "--out-dir", None, "--fs", "48000", "--pf-type", "no",
              "--batch-size", "2"]
    args = list(common)
    args[args.index(None)] = str(fast)
    assert cli_main(args) == 0

    def boom(*a, **kw):
        raise RuntimeError("forced: exercise the fallback runner")
        yield  # pragma: no cover — generator shape

    monkeypatch.setattr("magphase_jax.parallel.batch."
                        "synthesis_batches_pipelined", boom)
    args = list(common)
    args[args.index(None)] = str(slow)
    assert cli_main(args) == 0

    for tok in ("hvd_704", "hvd_705"):
        a = (fast / f"{tok}.wav").read_bytes()
        b = (slow / f"{tok}.wav").read_bytes()
        assert hashlib.sha256(a).digest() == hashlib.sha256(b).digest(), tok


def test_eval_command(workdir, capsys):
    import json
    _ensure_feats(workdir)
    # identical dirs -> near-zero waveform MSD
    rc = cli_main(["eval", "--scp", str(workdir / "two.scp"),
                   "--ref-dir", os.path.join(DATA, "wavs_nat"),
                   "--cand-dir", os.path.join(DATA, "wavs_nat")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mean_db"] == 0.0

    # feature-mode against the extracted corpus
    rc = cli_main(["eval", "--scp", str(workdir / "two.scp"),
                   "--ref-dir", str(workdir / "feats"),
                   "--cand-dir", str(workdir / "feats"),
                   "--mode", "feats"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mean_db"] == 0.0


def test_generate_unreadable_parks_only_failing_token(tmp_path, monkeypatch):
    """An unreadable feature file must park ONLY its own token: the
    healthy chunkmates stay on the pipelined fast path (witness: the
    fallback runner's batch synthesis is never invoked — the sole
    parked token fails at read time before any synthesis)."""
    import magphase_jax.parallel.batch as pbatch

    feats = tmp_path / "feats"
    feats.mkdir()
    src = os.path.join(DATA, "params_predicted")
    toks = ["hvd_704", "hvd_705", "hvd_706"]
    for t in toks:
        for ext in (".mag", ".real", ".imag", ".lf0"):
            shutil.copy(os.path.join(src, t + ext), feats / (t + ext))
    with open(feats / "hvd_705.mag", "wb") as f:
        f.write(b"\x00" * 37)
    scp = tmp_path / "gen.scp"
    scp.write_text("\n".join(toks) + "\n")
    out = tmp_path / "wavs"
    crash = tmp_path / "crash.scp"

    calls = []
    orig = pbatch.synthesis_from_compressed_batch

    def spy(utts, *a, **kw):
        calls.append(len(utts))
        return orig(utts, *a, **kw)

    monkeypatch.setattr(pbatch, "synthesis_from_compressed_batch", spy)
    # one 3-token chunk: under chunk-granular parking ALL of it would
    # demote to the fallback runner (= calls non-empty)
    rc = cli_main(["generate", "--scp", str(scp), "--feats-dir",
                   str(feats), "--out-dir", str(out), "--fs", "48000",
                   "--batch-size", "3", "--pf-type", "no",
                   "--crash-list", str(crash)])
    assert rc == 1
    assert (out / "hvd_704.wav").exists()
    assert (out / "hvd_706.wav").exists()
    assert crash.read_text().split() == ["hvd_705"]
    assert calls == []          # fast path handled every readable token
