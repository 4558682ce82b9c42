#!/usr/bin/env python
"""Multi-host corpus runs: correctness and orchestration evidence.

Runs the FULL `cli extract` + `cli generate` corpus workflow at 1, 2 and
4 emulated hosts (separate OS processes joined through a localhost
jax.distributed coordinator — the code path of a real multi-host
deployment, with the CPU backend standing in for the accelerators) over
a generated corpus (utils/stimuli.py), verifies the merged outputs are
byte-identical to the single-host run, and writes SCALING.md with the
per-host timing table.

Wall-clock here measures ORCHESTRATION scaling — disjoint partitioning,
coordinator overhead, per-host manifests — not device scaling; the
device-level story is the zero-collectives shard_map proof
(`__graft_entry__._dryrun_collectives_proof`, run on four GPUs by
`chip_smoke.py --four`).

Usage: python tools/multihost_scaling.py [out_md]
"""
import glob
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FS = 16000
N_UTTS = 20          # lengths drawn from 1-4 s: a duration SPREAD for the
                     # LPT duration balancing to balance

_WRAP = ("import sys, json; sys.path.insert(0, {repo!r}); "
         "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "from magphase_jax.cli import main; "
         "sys.exit(main(json.loads({args!r})))")


def _make_corpus(root):
    from magphase_jax.utils.stimuli import make_corpus, write_corpus
    corpus = make_corpus(N_UTTS, FS, seed=5, min_s=1.0, max_s=4.0)
    wav_dir = os.path.join(root, "wavs")
    scp = os.path.join(root, "file_id.scp")
    write_corpus(corpus, wav_dir, scp)
    return ([u.token for u in corpus], wav_dir, scp,
            sum(u.duration for u in corpus))


def _cmd(args):
    return [sys.executable, "-c",
            _WRAP.format(repo=REPO, args=json.dumps(args))]


def _env(extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    if extra:
        env.update(extra)
    return env


def _parse_metrics(stderr: str):
    """Per-host summary from the utils.metrics log line."""
    for line in reversed(stderr.splitlines()):
        if "INFO metrics " in line:
            return json.loads(line.split("INFO metrics ", 1)[1])
    return {}


def _run_phase(args, nprocs):
    """Run one CLI command at ``nprocs`` emulated hosts.

    Returns (wall_s, [per-host metrics dict])."""
    t0 = time.perf_counter()
    if nprocs == 1:
        p = subprocess.run(_cmd(args), env=_env(), cwd=REPO,
                           capture_output=True, text=True, timeout=1800)
        assert p.returncode == 0, p.stderr[-4000:]
        return time.perf_counter() - t0, [_parse_metrics(p.stderr)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(nprocs):
        procs.append(subprocess.Popen(
            _cmd(args), cwd=REPO,
            env=_env({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                      "JAX_NUM_PROCESSES": str(nprocs),
                      "JAX_PROCESS_ID": str(pid)}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    per_host = []
    for p in procs:
        _, err = p.communicate(timeout=1800)
        assert p.returncode == 0, err[-4000:]
        per_host.append(_parse_metrics(err))
    return time.perf_counter() - t0, per_host


def _tree_hash(d):
    h = hashlib.sha256()
    for f in sorted(os.listdir(d)):
        if f.startswith("."):
            continue
        with open(os.path.join(d, f), "rb") as fh:
            h.update(f.encode())
            h.update(fh.read())
    return h.hexdigest()


def main(out_md=os.path.join(REPO, "SCALING.md")):
    root = os.path.join(REPO, ".smoke", "scaling")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    toks, wav_dir, scp, audio_s = _make_corpus(root)

    ncores = os.cpu_count()
    rows = []
    hashes = {}
    for n in (1, 2, 4):
        out = os.path.join(root, f"hosts{n}")
        feats, wavs = os.path.join(out, "feats"), os.path.join(out, "wavs")
        t_ex, mx = _run_phase(["extract", "--scp", scp, "--wav-dir",
                               wav_dir, "--out-dir", feats,
                               "--batch-size", "4"], n)
        t_gen, mg = _run_phase(["generate", "--scp", scp, "--feats-dir",
                                feats, "--out-dir", wavs, "--fs", str(FS),
                                "--batch-size", "4", "--pf-type", "no"], n)
        hashes[n] = (_tree_hash(feats), _tree_hash(wavs))
        manifests = glob.glob(os.path.join(feats, ".magphase_manifest.p*"))
        def _audio(ms):
            return [round(m.get("audio_seconds", 0.0), 1) for m in ms]

        def _proc(ms):
            return [round(m.get("stages", {}).get("process", {})
                          .get("s", 0.0), 1) for m in ms]

        per_host_audio = _audio(mx)
        rows.append(dict(
            hosts=n, extract_wall_s=round(t_ex, 1),
            generate_wall_s=round(t_gen, 1),
            per_host_audio_s=per_host_audio,
            per_host_process_s=_proc(mx),
            gen_per_host_process_s=_proc(mg),
            partition_balance=round(
                min(per_host_audio) / max(max(per_host_audio), 1e-9), 3),
            gen_balance=round(
                min(_audio(mg)) / max(max(_audio(mg)), 1e-9), 3),
            manifests=len(manifests) or 1))

    ident = all(hashes[n] == hashes[1] for n in hashes)
    assert ident, f"multi-host outputs differ from single-host: {hashes}"

    lines = [
        "# Multi-host corpus runs — correctness and scaling evidence",
        "",
        "Full `cli extract` + `cli generate` workflow over the "
        f"{N_UTTS}-utterance generated corpus ({audio_s:.1f} audio-s at "
        f"{FS/1000:.0f} kHz, `utils/stimuli.py`), run at 1/2/4 emulated "
        "hosts: separate OS processes joined through a `jax.distributed` "
        "localhost coordinator — the exact code path of a real "
        "multi-host deployment, with the CPU backend standing in for the "
        "accelerators.  Regenerate with `python tools/multihost_scaling.py`.",
        "",
        "## What is proven here",
        "",
        "1. **Byte-identical merges.** The union of the hosts' outputs "
        "equals the single-host run byte for byte (SHA-256 over every "
        "feature file and waveform) at 2 and 4 hosts.  This is designed, "
        "not accidental: per-utterance noise keys derive from the GLOBAL "
        "scp index, the adaptive synthesis FFT is floored at the 50 Hz "
        "worst case (`det_fft_syn`), and the high-pass uses "
        "length-independent overlap-save blocks — no output sample "
        "depends on which utterances share a batch or a host.  Gated "
        "continuously by `tests/test_multihost_corpus.py`.",
        "2. **Disjoint balanced partitions.** Each host writes its own "
        "manifest over a duration-balanced token shard (greedy "
        "longest-first LPT over per-utterance audio seconds, "
        "`parallel/mesh.py:partition_tokens` — the static analogue of "
        "Pool's dynamic self-balancing); shards are disjoint, "
        "cover the corpus, and carry near-equal audio seconds (the "
        "`balance` column = min/max per-host audio).",
        "3. **Fault-isolated resume.** Per-host manifests mean a host "
        "crash loses only its in-flight chunk; re-running resumes from "
        "the manifests (same contract as single-host).",
        "",
        "| hosts | extract wall s | generate wall s | per-host audio-s "
        "| extract per-host process s | generate per-host process s | "
        "balance (ex / gen) | manifests |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['hosts']} | {r['extract_wall_s']} | "
            f"{r['generate_wall_s']} | {r['per_host_audio_s']} | "
            f"{r['per_host_process_s']} | {r['gen_per_host_process_s']} | "
            f"{r['partition_balance']} / {r['gen_balance']} | "
            f"{r['manifests']} |")
    lines += [
        "",
        "## What wall-clock here cannot prove — and what covers it",
        "",
        f"The table was taken on **{ncores} CPU cores**, so N emulated "
        "hosts contend for the same silicon: wall time grows with N "
        "(per-process jax start-up is a large share of the total) and no "
        "emulated configuration can exhibit real speedup.  The "
        "scaling-efficiency argument for real hardware is therefore "
        "structural:",
        "",
        "* **Zero inter-host communication in the workload.**  Hosts "
        "share nothing but the filesystem; each drives its own local "
        "device batch (the reference's Pool semantics, libutils.py:32-63,"
        " lifted to whole hosts).",
        "* **Zero inter-device communication within a host.**  "
        "`__graft_entry__.dryrun_multichip` compiles the production "
        "kernels under a `shard_map` data mesh, asserts sharded == "
        "unsharded outputs AND pins the optimized HLO to ZERO "
        "collectives; `chip_smoke.py --four` runs the same proof and a "
        "data-parallel extract + generate on four GPUs.  Per-device work "
        "is embarrassingly parallel by construction.",
        "* Therefore corpus throughput should scale with devices and "
        "hosts up to each host's I/O and link bandwidth; a measured "
        "four-GPU scaling efficiency is not taken yet (ROADMAP R4).",
    ]
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps({"rows": rows, "byte_identical": ident,
                      "out": out_md}))


if __name__ == "__main__":
    main(*(sys.argv[1:2] or []))
