"""Multi-host corpus-scale proof (round-3 VERDICT item 3): a CPU-emulated
2-process run of `cli extract` + `cli generate` over a generated corpus
(utils/stimuli.py) must
produce per-host manifests that are a disjoint cover AND merged outputs
byte-identical to a single-host run.

Byte-identity across arbitrary host partitions is a designed property:
 * extraction — all kernels are row-local, so padded batch geometry
   cannot change an utterance's features (test_long_utterance);
 * generation — per-utterance noise keys come from the GLOBAL scp index
   (cli.py:cmd_generate), the adaptive synthesis FFT is floored at the
   50 Hz worst case (det_fft_syn), and the high-pass uses
   length-independent overlap-save blocks (core/filters.py:sosfilt
   mode='blocked').
The reference has no equivalent guarantee (its Pool workers draw unseeded
noise, magphase.py:883).
"""
import glob
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000            # small FFTs keep CPU time down
N_UTTS = 6


def _make_corpus(root):
    from magphase_jax.utils.stimuli import make_corpus, write_corpus
    corpus = make_corpus(N_UTTS, FS, seed=3, min_s=1.0, max_s=2.0)
    wav_dir = os.path.join(root, "wavs")
    scp = os.path.join(root, "file_id.scp")
    write_corpus(corpus, wav_dir, scp)
    return [u.token for u in corpus], wav_dir, scp


# force the CPU backend from inside the interpreter: jax.config wins over
# an accelerator platform pinned in the environment (as tests/conftest.py)
_WRAP = ("import sys, json; sys.path.insert(0, {repo!r}); "
         "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "from magphase_jax.cli import main; "
         "sys.exit(main(json.loads({args!r})))")


def _cli_env(extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    env.pop("JAX_NUM_PROCESSES", None)
    env.pop("JAX_PROCESS_ID", None)
    if extra:
        env.update(extra)
    return env


def _cmd(args):
    return [sys.executable, "-c",
            _WRAP.format(repo=REPO, args=json.dumps(args))]


def _run_cli(args, env, timeout=900):
    p = subprocess.run(_cmd(args), env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-4000:]
    return p


def _extract_generate(scp, wav_dir, out_root, env_extra=None,
                      nprocs=1, timeout=900):
    feats = os.path.join(out_root, "feats")
    wavs = os.path.join(out_root, "wavs_syn")
    ex_args = ["extract", "--scp", scp, "--wav-dir", wav_dir,
               "--out-dir", feats, "--batch-size", "4"]
    gen_args = ["generate", "--scp", scp, "--feats-dir", feats,
                "--out-dir", wavs, "--fs", str(FS), "--batch-size", "4",
                "--pf-type", "no"]
    if nprocs == 1:
        _run_cli(ex_args, _cli_env(env_extra))
        _run_cli(gen_args, _cli_env(env_extra))
        return feats, wavs

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for args in (ex_args, gen_args):
        procs = []
        for pid in range(nprocs):
            env = _cli_env({
                "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "JAX_NUM_PROCESSES": str(nprocs),
                "JAX_PROCESS_ID": str(pid),
            })
            procs.append(subprocess.Popen(
                _cmd(args), env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
        port += 1     # fresh coordinator port for the generate phase
    return feats, wavs


def _tree_hashes(d):
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("."):
            continue
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.mark.slow
def test_two_host_corpus_merge_is_byte_identical(tmp_path):
    toks, wav_dir, scp = _make_corpus(str(tmp_path))

    f1, w1 = _extract_generate(scp, wav_dir, str(tmp_path / "single"))
    f2, w2 = _extract_generate(scp, wav_dir, str(tmp_path / "multi"),
                               nprocs=2)

    # per-host manifests: disjoint cover of the corpus
    manifests = sorted(glob.glob(os.path.join(f2, ".magphase_manifest.p*")))
    assert len(manifests) == 2
    shards = []
    for m in manifests:
        with open(m) as fh:
            shards.append(set(json.load(fh)["done"]))
    assert shards[0].isdisjoint(shards[1])
    assert shards[0] | shards[1] == set(toks)

    # merged outputs byte-identical to the single-host run
    h_f1, h_f2 = _tree_hashes(f1), _tree_hashes(f2)
    assert set(h_f1) == set(h_f2)
    diff = [f for f in h_f1 if h_f1[f] != h_f2[f]]
    assert not diff, f"feature files differ: {diff}"
    assert len(h_f1) == N_UTTS * 5           # mag/real/imag/lf0/shift

    h_w1, h_w2 = _tree_hashes(w1), _tree_hashes(w2)
    assert set(h_w1) == set(h_w2) and len(h_w1) == N_UTTS
    diff = [f for f in h_w1 if h_w1[f] != h_w2[f]]
    assert not diff, f"waveforms differ: {diff}"
