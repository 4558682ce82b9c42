"""Real multi-process jax.distributed smoke test (CPU emulation).

SURVEY.md §4(d): multi-host behaviour must be testable without a pod.
Two subprocess workers form a process group through a localhost
coordinator, each takes its partition_tokens shard, runs a tiny
analysis_compressed_batch on its share, and reports its manifest name —
the parent asserts the shards are a disjoint cover and the per-host
manifests cannot collide (cli.py:_host_partition semantics)."""
import json
import os
import socket
import subprocess
import sys

import numpy as np

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["MAGPHASE_REPO"])

# jax.config wins over an accelerator platform pinned in the environment
# (as tests/conftest.py)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

# MUST run before any other JAX call (even process_count() initialises
# the backend) — this is the production ordering contract
from magphase_jax.parallel.mesh import maybe_initialize_distributed
maybe_initialize_distributed()

import numpy as np
assert jax.process_count() == 2, jax.process_count()

from magphase_jax.cli import _host_partition
from magphase_jax.parallel.analysis_batch import analysis_compressed_batch

tokens = [f"utt{i:02d}" for i in range(7)]
mine, manifest = _host_partition(tokens)

# tiny per-host workload: given-epochs analysis (16 kHz, small fft) on
# as many signals as this host's token share
fs = 16000
rng = np.random.RandomState(jax.process_index())
sigs, eps = [], []
for _ in mine:
    n = 1600
    sigs.append(0.1 * np.sin(2 * np.pi * 200 * np.arange(n) / fs))
    pm = np.arange(80, n - 160, 80)
    eps.append((pm / fs, (pm % 160 == 0).astype(float)))
feats = analysis_compressed_batch(sigs, fs, mag_dim=10, phase_dim=5,
                                  fft_len=512, epochs=eps)
ok = (len(feats) == len(mine)
      and all(np.all(np.isfinite(f[0])) for f in feats))

out = {"process_index": jax.process_index(), "tokens": mine,
       "manifest": manifest, "feats_ok": bool(ok)}
with open(os.environ["MAGPHASE_OUT"], "w") as f:
    json.dump(out, f)
"""


def test_two_process_distributed_smoke(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"worker{pid}.json"
        outs.append(out)
        env = dict(os.environ)
        env.update({
            "MAGPHASE_REPO": os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            "MAGPHASE_OUT": str(out),
            "JAX_PLATFORMS": "cpu",
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))

    results = []
    for p, out in zip(procs, outs):
        stdout, stderr = p.communicate(timeout=480)
        assert p.returncode == 0, stderr.decode()[-3000:]
        with open(out) as f:
            results.append(json.load(f))

    shards = [set(r["tokens"]) for r in results]
    assert shards[0].isdisjoint(shards[1])
    assert shards[0] | shards[1] == {f"utt{i:02d}" for i in range(7)}
    # round-robin keeps the length-sorted order balanced
    assert abs(len(shards[0]) - len(shards[1])) <= 1
    assert results[0]["manifest"] != results[1]["manifest"]
    assert all(r["feats_ok"] for r in results)
