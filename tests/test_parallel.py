"""Batched + sharded vocoding on the 8-device virtual CPU mesh."""
import os

import numpy as np
import jax
import pytest

from magphase_jax.io import read_binfile
from magphase_jax.parallel import data_mesh, synthesis_from_compressed_batch
from magphase_jax.vocoder import synthesis_from_compressed

PRED_DIR = "/root/reference/demos/data_48k/params_predicted"
TOKENS = ["hvd_704", "hvd_705", "hvd_706", "hvd_708"]


def _load(token):
    return (read_binfile(os.path.join(PRED_DIR, token + ".mag"), dim=60),
            read_binfile(os.path.join(PRED_DIR, token + ".real"), dim=45),
            read_binfile(os.path.join(PRED_DIR, token + ".imag"), dim=45),
            read_binfile(os.path.join(PRED_DIR, token + ".lf0"), dim=1))


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


def test_batch_matches_single(monkeypatch):
    """Batched synthesis must equal the single-utterance path per utterance
    (same per-utterance PRNG key stream)."""
    utts = [_load(t) for t in TOKENS[:2]]
    key = jax.random.PRNGKey(3)
    outs = synthesis_from_compressed_batch(utts, 48000, key=key,
                                           b_out_hpf=False)
    keys = jax.random.split(key, 2)
    for i, u in enumerate(utts):
        single = synthesis_from_compressed(*u, 48000, b_out_hpf=False,
                                           key=keys[i])
        assert outs[i].shape == single.shape
        np.testing.assert_allclose(outs[i], single, atol=2e-4)


def test_batch_sharded_over_mesh():
    mesh = data_mesh()
    utts = [_load(TOKENS[i % 4]) for i in range(8)]
    outs = synthesis_from_compressed_batch(utts, 48000, mesh=mesh,
                                           b_out_hpf=False)
    assert len(outs) == 8
    for o in outs:
        assert np.all(np.isfinite(o)) and np.std(o) > 1e-5
    # identical params + identical split keys across replicas? keys differ
    # per utterance, so repeated utterances must still produce finite audio
    # of identical length
    assert outs[0].shape == outs[4].shape


def test_dryrun_multichip_8_devices():
    """The driver's multi-chip dry run must pass on the virtual mesh."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_analysis_batch_sharded_over_mesh():
    from magphase_jax.parallel import data_mesh
    from magphase_jax.parallel.analysis_batch import analysis_lossless_batch
    rng = np.random.RandomState(0)
    mesh = data_mesh()
    sigs = [rng.randn(4096) * 0.1 for _ in range(8)]
    epochs = [(np.cumsum(rng.randint(100, 200, 10)) / 48000.0,
               (rng.rand(10) > 0.5).astype(np.float64)) for _ in range(8)]
    ref = analysis_lossless_batch(sigs, 48000, fft_len=512, epochs=epochs)
    got = analysis_lossless_batch(sigs, 48000, fft_len=512, epochs=epochs,
                                  mesh=mesh)
    for (a, b) in zip(ref, got):
        np.testing.assert_allclose(a[0], b[0], atol=1e-6)


def test_mesh_size_not_dividing_base_bucket():
    """A mesh whose size does not divide the base batch bucket (8) must
    still shard evenly (lcm bucketing): 3 devices, 2 real utterances."""
    import jax
    import numpy as np
    from magphase_jax.parallel.mesh import data_mesh
    from magphase_jax.parallel.analysis_batch import analysis_compressed_batch

    mesh = data_mesh(3)
    rng = np.random.RandomState(0)
    t = np.arange(6000) / 48000.0
    sigs = [np.sin(2 * np.pi * 130 * t) * 0.5,
            np.sin(2 * np.pi * 170 * t) * 0.5]
    out = analysis_compressed_batch(sigs, 48000, mag_dim=20, phase_dim=10,
                                    fft_len=512, mesh=mesh)
    assert len(out) == 2
    assert all(np.all(np.isfinite(o[0])) for o in out)


def test_budget_split_nonblocking_matches_blocking(monkeypatch):
    """HBM sub-batch splitting must also apply with block_result=False
    (the production generate-CLI path) and produce the same waveforms."""
    import jax
    import numpy as np
    from magphase_jax.parallel import batch as pb

    rng = np.random.RandomState(0)
    utts = []
    for b in range(4):
        n = 40 + b
        mag = rng.randn(n, 20).astype(np.float32) * 0.3 - 3.0
        real = np.clip(rng.randn(n, 10) * 0.3, -1, 1)
        imag = np.clip(rng.randn(n, 10) * 0.3, -1, 1)
        lf0 = np.log(rng.uniform(90, 250, n))
        lf0[rng.rand(n) < 0.3] = -1.0e10
        utts.append((mag, real, imag, lf0))

    ref = pb.synthesis_from_compressed_batch(
        utts, 48000, fft_len=512, key=jax.random.PRNGKey(7))

    # force a split into sub-batches of <= 2
    monkeypatch.setattr(pb, "max_frame_elems", lambda: 2 * 128 * 512)
    split_blocking = pb.synthesis_from_compressed_batch(
        utts, 48000, fft_len=512, key=jax.random.PRNGKey(7))
    rows, lens = pb.synthesis_from_compressed_batch(
        utts, 48000, fft_len=512, key=jax.random.PRNGKey(7),
        block_result=False)
    assert len(rows) == len(lens) == 4
    for w_ref, row, n in zip(split_blocking, rows, lens):
        w = np.asarray(jax.device_get(row))[:n]
        np.testing.assert_allclose(w, w_ref, atol=1e-5)
    # same audio content as the unsplit run (same key -> same noise split)
    for a, b in zip(ref, split_blocking):
        assert len(a) == len(b)


def test_partition_tokens_round_robin():
    from magphase_jax.parallel.mesh import partition_tokens
    toks = [f"u{i}" for i in range(10)]
    shards = [partition_tokens(toks, i, 3) for i in range(3)]
    assert sorted(sum(shards, [])) == sorted(toks)
    assert max(len(s) for s in shards) - min(len(s) for s in shards) <= 1
    # single process: identity
    assert partition_tokens(toks, 0, 1) == toks


def test_budget_batch_cap_invariant():
    """bucket(n <= cap, capped_batch_step(mesh, cap)) must never exceed
    the HBM-derived cap (round-up past the budget risks device OOM)."""
    from magphase_jax.parallel.mesh import (budget_batch_cap,
                                            capped_batch_step)
    from magphase_jax.utils.padding import bucket

    mesh = data_mesh()
    for m in (None, mesh):
        size = 1 if m is None else m.size
        for raw in (1, 2, 5, 7, 8, 9, 12, 15, 16, 17, 33, 100):
            cap = budget_batch_cap(m, raw)
            assert cap <= max(raw, size)     # never above budget (except
            # the mesh-size floor: sharding needs a row per device)
            assert cap % size == 0           # even sharding
            for n in range(1, cap + 1):
                assert bucket(n, capped_batch_step(m, cap)) <= cap


def test_partition_tokens_duration_balanced():
    """LPT duration balancing (VERDICT r4 item 6): disjoint cover,
    scp-order within a shard, deterministic across hosts, and min/max
    per-host audio >= 0.9 on a skewed duration distribution where
    round-robin lands at ~0.6."""
    from magphase_jax.parallel.mesh import partition_tokens

    rng = np.random.RandomState(7)
    toks = [f"utt{i:03d}" for i in range(24)]
    w = (1.0 + 9.0 * rng.rand(24)).tolist()

    for n in (2, 4):
        shards = [partition_tokens(toks, i, n, weights=w)
                  for i in range(n)]
        # disjoint cover
        flat = sorted(t for s in shards for t in s)
        assert flat == sorted(toks)
        # scp order within each shard
        for s in shards:
            assert s == sorted(s, key=toks.index)
        # balance: >= 0.9 on a 24-utterance skewed corpus, and strictly
        # better than round-robin (10-item corner cases can dip to ~0.89
        # — LPT's intrinsic limit with few chunky items)
        loads = [sum(w[toks.index(t)] for t in s) for s in shards]
        rr = [sum(w[toks.index(t)] for t in toks[i::n]) for i in range(n)]
        assert min(loads) / max(loads) >= 0.9, (n, loads)
        assert min(loads) / max(loads) > min(rr) / max(rr), (n, loads, rr)

    # weight list must align with tokens
    import pytest
    with pytest.raises(ValueError):
        partition_tokens(toks, 0, 2, weights=w[:-1])


def test_device_put_chunked_bitwise():
    """Chunked blocking upload must reproduce the array exactly for any
    shape/dtype mix (incl. non-dividing row counts and sub-chunk
    arrays)."""
    from magphase_jax.utils.transfer import device_put_chunked

    rng = np.random.RandomState(0)
    for arr in (rng.randn(13, 1000).astype(np.float32),
                (rng.randn(7, 33, 5) * 100).astype(np.int16),
                rng.randn(1, 8).astype(np.float16),
                np.arange(5, dtype=np.int32)):
        got = np.asarray(device_put_chunked(arr, chunk_bytes=4000))
        np.testing.assert_array_equal(got, arr)
    # chunking disabled -> plain path
    arr = rng.randn(16, 16).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(device_put_chunked(arr, chunk_bytes=0)), arr)


def test_hpf_mode_spectral_matches_blocked(monkeypatch):
    """Default 'spectral' output high-pass (per-bin complex gain folded
    into the frame spectra) vs the reference-faithful 'blocked' FFT-conv
    mode: same length, small waveform deviation, and equivalent
    low-frequency attenuation.  This cheap gate catches a broken H table
    or a mode-wiring regression."""
    utts = [_load(TOKENS[0])]
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), 1),
                      np.uint32)
    outs = {"nohpf": np.asarray(synthesis_from_compressed_batch(
        utts, 48000, keys=keys, b_out_hpf=False)[0])}
    for mode in ("blocked", "spectral"):
        monkeypatch.setenv("MAGPHASE_HPF_MODE", mode)
        outs[mode] = np.asarray(
            synthesis_from_compressed_batch(utts, 48000, keys=keys)[0])
    a, b = outs["blocked"], outs["spectral"]
    assert a.shape == b.shape
    rel = np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2))
    assert rel < 0.10, rel            # corpus-measured 0.030-0.053

    def lo25(x):
        X = np.abs(np.fft.rfft(x))
        f = np.fft.rfftfreq(len(x), 1 / 48000.0)
        return np.sqrt(np.mean(X[f < 25.0] ** 2))

    # measured on hvd_704 (lo25 RMS): nohpf 30.8, blocked 0.42 (73x),
    # spectral 6.3 (4.9x — floored by anti-ringing-window leakage from
    # the 50-150 Hz band back into the zeroed bins, not by H itself;
    # -22 dB below the speech band, MSD-neutral vs natural)
    ref = lo25(outs["nohpf"])
    assert lo25(a) < 0.05 * ref, (lo25(a), ref)
    assert lo25(b) < 0.30 * ref, (lo25(b), ref)
