"""chip_smoke.py's phases at a tiny size on the CPU (16 kHz, two short
utterances), and its refusal to report anything without a GPU."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

FS = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("smoke"))
    corpus, wav_dir, scp = cs.make_corpus(wd, 2, fs=FS, min_s=1.0,
                                          max_s=1.4)
    feats = os.path.join(wd, "feats")
    cs.extract(scp, wav_dir, feats)
    syn = os.path.join(wd, "syn")
    cs.generate(scp, feats, syn, fs=FS)
    return dict(wd=wd, corpus=corpus, wav_dir=wav_dir, scp=scp,
                feats=feats, syn=syn)


def test_corpus_phase_writes_wavs_and_scp(corpus):
    from magphase_jax.io import read_wav
    toks = open(corpus["scp"]).read().split()
    assert toks == [u.token for u in corpus["corpus"]]
    for u in corpus["corpus"]:
        sig, fs = read_wav(os.path.join(corpus["wav_dir"], u.token + ".wav"))
        assert fs == FS and 1.0 <= len(sig) / FS <= 1.4
        assert len(u.gci) and u.intervals


def test_extract_phase_checks_features(corpus):
    m = cs.check_features(corpus["corpus"], corpus["feats"])
    assert m["gpe"] < cs.VOICING_GATES["gpe"]


def test_generate_phase_checks_wavs_and_is_deterministic(corpus, tmp_path):
    cs.check_wavs(corpus["corpus"], corpus["feats"], corpus["syn"])
    again = str(tmp_path / "again")
    cs.generate(corpus["scp"], corpus["feats"], again, fs=FS)
    toks = [u.token for u in corpus["corpus"]]
    assert cs.compare_wav_dirs(toks, corpus["syn"], again) == (len(toks),
                                                               0.0)


def test_copy_synthesis_phase(corpus):
    assert cs.copy_synthesis(corpus["corpus"], corpus["wav_dir"], n=2) \
        < 2.0 ** -15


def test_oracle_phase(corpus):
    rows = cs.oracle(corpus["corpus"], corpus["wav_dir"], n=1, fft_len=1024)
    assert rows and all(ok for *_, ok in rows)


def test_serve_phase_matches_generate(corpus, tmp_path):
    tok = corpus["corpus"][0].token
    out = str(tmp_path / "served")
    cs.serve_one(tok, corpus["feats"], out, str(tmp_path / "s.sock"), fs=FS)
    assert cs.compare_wav_dirs([tok], corpus["syn"], out) == (1, 0.0)


def test_main_refuses_a_cpu_device(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(cs, "card_identity", lambda: "test card, 0 W")
    with pytest.raises(SystemExit) as e:
        cs.main(["--workdir", str(tmp_path / "w")])
    assert "needs a GPU" in str(e.value)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
