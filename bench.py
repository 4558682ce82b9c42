#!/usr/bin/env python
"""Benchmark on one GPU, in one process: batch compressed vocoding and
batch compressed analysis on a generated corpus (utils/stimuli.py).

Workloads (the reference's two batch scripts):
  * synthesis — batch_waveform_generation (magphase.py:825-997): 48 kHz
    waveforms from 60/45/45/1-dim features, end to end through the
    threaded pipeline (synthesis_batches_pipelined) and device-only (the
    fused kernel on operands already on the device).
  * analysis — batch_feature_extraction_for_tts (magphase.py:2947-2988):
    wav -> tracker -> epochs -> pitch-sync analysis -> mel compression,
    end to end through the async two-phase pipeline, and device-only
    (the two fused programs on signals already on the device).

Features for synthesis come from the repo's own analysis of the corpus.
Every timed block ends in block_until_ready or a host transfer.  A
correctness witness runs first (lossless copy-synthesis p99 < 2^-15);
any failure exits non-zero.  Refuses to run without a GPU.

Prints the card's name and power limit, then ONE JSON line.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FS = 48000
N_UTTS = 32
BATCH = 128
ITERS = 8
ANALYSIS_BATCH = 192
REPS = 3


def _corpus():
    from magphase_jax.utils.stimuli import make_corpus
    # on the PCM16 lattice, as read from 16-bit wavs
    return [np.rint(u.sig * 32768.0) / 32768.0
            for u in make_corpus(N_UTTS, FS, seed=0)]


def _cycle(xs, n):
    return [xs[i % len(xs)] for i in range(n)]


def check_aux_bitcast_roundtrip():
    """Every one of the 65536 u16 bit patterns must survive the device
    bitcast + concatenate + download bit-exactly: the analysis download
    carries lf0/shift as bitcast u16 lanes of the feature tensor
    (parallel/analysis_batch.py)."""
    import jax
    import jax.numpy as jnp

    lo = np.arange(65536, dtype=np.uint32).reshape(64, 64, 16)
    bits = (np.uint32(0x42340000) | lo).astype(np.uint32)  # finite f32s
    src = bits.view(np.float32).reshape(64, 64, 16)
    feats = np.linspace(-4.0, 4.0, 64 * 64 * 2, dtype=np.float32
                        ).reshape(64, 64, 2)

    @jax.jit
    def pack(f, a):
        B, F, C = a.shape
        f16 = jax.lax.bitcast_convert_type(f.astype(jnp.float16),
                                           jnp.uint16)
        a16 = jax.lax.bitcast_convert_type(a, jnp.uint16)
        return jnp.concatenate([f16, a16.reshape(B, F, 2 * C)], axis=-1)

    out = np.asarray(jax.device_get(pack(jnp.asarray(feats),
                                         jnp.asarray(src))))
    got = np.ascontiguousarray(out[:, :, 2:]).view(np.float32)
    assert got.tobytes() == src.tobytes(), \
        "u16 bitcast aux transport is not bit-transparent on this backend"
    got_f = np.ascontiguousarray(out[:, :, :2]).view(np.float16)
    assert np.abs(got_f.astype(np.float32) - feats).max() < 4e-3, \
        "u16-wire f16 feature lanes decoded wrong"


def check_correctness(signals):
    """Lossless round trip through the batched copy-synthesis program."""
    from magphase_jax.parallel.copy_synthesis import copy_synthesis_batch

    subset = signals[:4]
    for i, (sig, syn) in enumerate(zip(subset,
                                       copy_synthesis_batch(subset, FS))):
        n = min(len(sig), len(syn))
        p99 = float(np.percentile(np.abs(syn[2000:n - 2000]
                                         - sig[2000:n - 2000]), 99))
        assert np.all(np.isfinite(syn)), f"utt {i}: non-finite output"
        assert np.std(syn) > 1e-4, f"utt {i}: silent output"
        assert p99 < 2.0 ** -15, f"utt {i}: lossless p99 err {p99:.3e}"


def _timed(fn, reps=REPS):
    import jax
    jax.block_until_ready(fn())                     # warmup / compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def synthesis(utts):
    """(E2E audio-s/s, device audio-s/s) for BATCH-utterance batches."""
    import jax
    import jax.numpy as jnp
    from magphase_jax.config import (define_alpha, define_crossfade_params,
                                     define_fft_len)
    from magphase_jax.parallel import batch as pb
    from magphase_jax.vocoder.compressed import \
        get_num_full_mel_coeffs_from_num_phase_coeffs

    batch = _cycle(utts, BATCH)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), BATCH),
                      np.uint32)

    def consume(bufs, host):
        jax.device_get(bufs)
        return sum(host["out_lens"][:host["n_real"]]) / FS

    def e2e():
        audio_s = sum(pb.synthesis_batches_pipelined(
            ((batch, keys) for _ in range(ITERS)), FS, pf_type="magphase",
            consume=consume))
        return jnp.asarray(audio_s)

    audio_s = float(e2e())
    e2e_rate = audio_s / _timed(e2e)

    # device-only: one prepared group, operands on the device
    alpha = define_alpha(FS)
    fft_len = define_fft_len(FS)
    fft_syn, max_b = pb._synthesis_geometry(batch, FS, fft_len, True, None)
    host = pb._prepare_synthesis_group(
        batch[:max_b], n_real=min(max_b, BATCH), keys=keys[:max_b],
        mesh=None, max_b=max_b, fs=FS, fft_syn=fft_syn, alpha=alpha,
        alpha_phase=alpha, mag_dim=60, phase_dim=45,
        mag_dim_ph=get_num_full_mel_coeffs_from_num_phase_coeffs(
            define_crossfade_params(FS)[0], 45, alpha, FS),
        b_voi_ap_win=True, per_phase_type="magphase", b_out_hpf=True,
        pf_type="magphase", transport="f16")
    dev = pb._upload_synthesis_group(host, None)
    dt = _timed(lambda: pb._execute_synthesis_group(dev, None,
                                                    pcm16=False))
    dev_rate = sum(host["out_lens"][:host["n_real"]]) / FS / dt
    return e2e_rate, dev_rate


def analysis(signals):
    """(E2E audio-s/s, device audio-s/s) for ANALYSIS_BATCH signals."""
    import jax.numpy as jnp
    from magphase_jax.config import (define_alpha, define_crossfade_params,
                                     define_fft_len)
    from magphase_jax.parallel import analysis_batch as ab
    from magphase_jax.vocoder.compressed import \
        get_num_full_mel_coeffs_from_num_phase_coeffs

    batch = _cycle(signals, ANALYSIS_BATCH)
    audio_s = sum(len(s) for s in batch) / FS

    def e2e():
        feats = ab.analysis_compressed_batch_async(batch, FS)()
        assert len(feats) == ANALYSIS_BATCH
        m, r, i, lf0, sh = feats[0]
        assert np.all(np.isfinite(m)) and np.all(np.isfinite(lf0)), \
            "analysis: non-finite features"
        assert m.shape[1] == 60 and r.shape[1] == 45, "analysis: bad dims"
        return jnp.zeros(())

    e2e_rate = audio_s / _timed(e2e)

    # device-only: the two fused programs of one budget group
    fft_len = define_fft_len(FS)
    alpha = define_alpha(FS)
    group = ab._split_for_budget(batch, FS, fft_len)[0]
    _, host, S, Tmax, m_max, n_real = ab._host_signal_batch(group, FS)
    dev = ab._upload_signal_batch(host)

    def device():
        marks, flags, n_marks = ab._track_place_kernel(
            *dev, fs=FS, n_frames_max=Tmax, m_max=m_max)
        return ab._analyze_compress_kernel(
            dev[0], marks, flags, n_marks, dev[1], fs=FS, fft_len=fft_len,
            F=m_max, mag_dim=60, phase_dim=45,
            mag_dim_ph=get_num_full_mel_coeffs_from_num_phase_coeffs(
                define_crossfade_params(FS)[0], 45, alpha, FS),
            alpha=alpha, alpha_phase=alpha, feats_f16=True, pack=True)

    dev_rate = sum(len(s) for s in group[:n_real]) / FS / _timed(device)
    return e2e_rate, dev_rate


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform}")

    from magphase_jax.parallel.analysis_batch import \
        analysis_compressed_batch

    signals = _corpus()
    check_aux_bitcast_roundtrip()
    check_correctness(signals)
    utts = [f[:4] for f in analysis_compressed_batch(signals, FS)]
    synth, synth_dev = synthesis(utts)
    ana, ana_dev = analysis(signals)
    print(json.dumps({
        "metric": "compressed_vocoding_throughput",
        "value": synth, "unit": "audio_s_per_s",
        "device_metric": "compressed_vocoding_device_throughput",
        "device_value": synth_dev,
        "analysis_metric": "compressed_analysis_throughput",
        "analysis_value": ana, "analysis_unit": "audio_s_per_s",
        "analysis_device_metric": "compressed_analysis_device_throughput",
        "analysis_device_value": ana_dev,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "checks": "ok",
    }))


if __name__ == "__main__":
    main()
