#!/usr/bin/env python
"""Smoke run of the main path on a GPU: extract -> generate ->
copy-synthesis, checked against ground truth and the numpy oracle.

    python chip_smoke.py            # one GPU, phases a-h
    python chip_smoke.py --four     # four GPUs: data-parallel extract +
                                    # generate vs one GPU, no collectives

Phases (one process; any failed check exits non-zero):
  a  card identity, device, memory budget
  b  a seeded 48 kHz corpus with known epochs (utils/stimuli.py)
  c  `cli extract` at 60/45 dims, fft_len 4096, batch 8: finite features
     of the right dims whose voicing matches the stimulus truth
  d  `cli generate --pf-type magphase`, twice: finite, non-silent wavs
     of the expected length; the second run is compared bytewise
  e  batched lossless copy-synthesis: reconstruction p99 < 2^-15
  f  the plain numpy reference (tests/oracle/refport.py) at fft_len 4096
  g  one request through the `cli serve` daemon, run on a thread here
  h  the Pallas epoch-walk kernel, compiled, vs the XLA walk it replaces

The last line is one JSON object: {"ok": true, "device": {...}}.
"""
import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FS = 48000
MAG_DIM, PHASE_DIM = 60, 45
BATCH = 8
PCM_STEP = 1.0 / 32768.0
# voicing gates (corpus means of utils/tracker_eval metrics): gpe and
# voi_miss as tests/test_tracker_groundtruth.py; voi_fa looser, because
# the formant-filtered noise of the unvoiced segments reads as weakly
# voiced in places (the tracker scores 0.154 on the first 12 utterances
# of this corpus on the CPU)
VOICING_GATES = dict(gpe=0.01, voi_miss=0.02, voi_fa=0.25)
SHARDED_ATOL = 2e-4        # sharded vs unsharded, __graft_entry__.py
# extracted features leave the device as float16; a 2-utterance and an
# 8-utterance device batch may take other cuBLAS/cuFFT kernels, so their
# float32 results differ in the last bits and can round to adjacent
# float16 values: one float16 step is at most 2^-10 of the value
F16_RTOL = 2.0 ** -10


def card_identity() -> str:
    """name, power limit of the card, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


@contextlib.contextmanager
def phase(name: str, times: dict):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    times[name] = time.perf_counter() - t0
    print(f"   phase {name}: {times[name]:.2f} s wall", flush=True)


def _cli(argv) -> None:
    from magphase_jax import cli
    rc = cli.main(list(argv))
    assert rc == 0, f"cli {argv[0]} returned {rc}"


def _refport():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle import refport
    return refport


# --------------------------------------------------------------------- b
def make_corpus(workdir: str, n: int, fs: int = FS, seed: int = 0,
                min_s: float = 1.5, max_s: float = 8.0):
    from magphase_jax.utils.stimuli import make_corpus as mk, write_corpus

    corpus = mk(n, fs, seed=seed, min_s=min_s, max_s=max_s)
    wav_dir = os.path.join(workdir, "wavs")
    scp = os.path.join(workdir, "corpus.scp")
    write_corpus(corpus, wav_dir, scp)
    secs = [u.duration for u in corpus]
    print(f"   corpus: {n} utts at {fs} Hz, {sum(secs):.1f} s audio, "
          f"lengths {min(secs):.2f}-{max(secs):.2f} s")
    return corpus, wav_dir, scp


# --------------------------------------------------------------------- c
def extract(scp: str, wav_dir: str, feats_dir: str, batch: int = BATCH,
            fft_len: int = 0, data_parallel: bool = False) -> None:
    argv = ["extract", "--scp", scp, "--wav-dir", wav_dir, "--out-dir",
            feats_dir, "--mag-dim", str(MAG_DIM), "--phase-dim",
            str(PHASE_DIM), "--batch-size", str(batch)]
    if fft_len:
        argv += ["--fft-len", str(fft_len)]
    _cli(argv + (["--data-parallel"] if data_parallel else []))


def read_features(feats_dir: str, token: str):
    from magphase_jax.io import read_binfile

    p = os.path.join(feats_dir, token)
    return (read_binfile(p + ".mag", MAG_DIM),
            read_binfile(p + ".real", PHASE_DIM),
            read_binfile(p + ".imag", PHASE_DIM),
            np.atleast_1d(read_binfile(p + ".lf0", 1)),
            np.atleast_1d(read_binfile(p + ".shift", 1)))


def check_features(corpus, feats_dir: str) -> dict:
    """Finite features of the configured dims, one frame per mark, and
    voicing that matches the stimulus truth (corpus means of the
    utils/tracker_eval metrics against VOICING_GATES)."""
    from magphase_jax.utils.tracker_eval import tracker_metrics

    ms = []
    for u in corpus:
        mag, real, imag, lf0, shift = read_features(feats_dir, u.token)
        n = len(lf0)
        assert mag.shape == (n, MAG_DIM), (u.token, mag.shape)
        assert real.shape == imag.shape == (n, PHASE_DIM), u.token
        assert shift.shape == (n,), u.token
        for a in (mag, real, imag, lf0, shift):
            assert np.all(np.isfinite(a)), f"{u.token}: non-finite feature"
        pm_sec = np.cumsum(shift) / u.fs
        voi = lf0 > 0.0          # unvoiced frames carry lf0 = -1e10
        ms.append(tracker_metrics(pm_sec, voi, u.gci, u.intervals, u.f0_at,
                                  u.duration))
    mean = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
    print("   voicing vs stimulus truth (corpus mean): " + ", ".join(
        f"{k}={mean[k]:.4f}" + (f" (< {VOICING_GATES[k]})"
                                if k in VOICING_GATES else "")
        for k in mean))
    for k, gate in VOICING_GATES.items():
        assert mean[k] < gate, f"voicing metric {k}={mean[k]:.4f} >= {gate}"
    return mean


# --------------------------------------------------------------------- d
def generate(scp: str, feats_dir: str, out_dir: str, fs: int = FS,
             batch: int = BATCH, data_parallel: bool = False,
             server: str | None = None) -> None:
    argv = ["generate", "--scp", scp, "--feats-dir", feats_dir,
            "--out-dir", out_dir, "--fs", str(fs), "--mag-dim",
            str(MAG_DIM), "--phase-dim", str(PHASE_DIM), "--pf-type",
            "magphase", "--batch-size", str(batch)]
    if data_parallel:
        argv.append("--data-parallel")
    if server:
        argv += ["--server", server]
    _cli(argv)


def expected_len(lf0: np.ndarray, fs: int) -> int:
    """Output samples implied by the features' pitch-mark geometry:
    pm[-1] + last shift + 1 (parallel/batch.py, magphase.py:58-60)."""
    from magphase_jax.vocoder.framerate import truncate_shifts

    f0 = np.exp(np.asarray(lf0, np.float64))
    pm = np.cumsum(truncate_shifts(fs / np.where(f0 == 0.0, 200.0, f0)))
    return int(pm[-1] + (pm[-1] - pm[-2]) + 1)


def check_wavs(corpus, feats_dir: str, out_dir: str) -> None:
    from magphase_jax.io import read_wav

    for u in corpus:
        syn, fs = read_wav(os.path.join(out_dir, u.token + ".wav"))
        assert fs == u.fs, (u.token, fs)
        assert np.all(np.isfinite(syn)), f"{u.token}: non-finite output"
        assert np.std(syn) > 1e-4, f"{u.token}: silent output"
        lf0 = read_features(feats_dir, u.token)[3]
        assert len(syn) == expected_len(lf0, fs), \
            (u.token, len(syn), expected_len(lf0, fs))


def compare_wav_dirs(tokens, dir_a: str, dir_b: str) -> tuple:
    """(bytewise-identical count, max |a - b| in PCM16 steps)."""
    from magphase_jax.io import read_wav

    same, worst = 0, 0.0
    for t in tokens:
        pa, pb = (os.path.join(d, t + ".wav") for d in (dir_a, dir_b))
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            same += fa.read() == fb.read()
        a, b = read_wav(pa)[0], read_wav(pb)[0]
        assert a.shape == b.shape, (t, a.shape, b.shape)
        worst = max(worst, float(np.max(np.abs(a - b))) / PCM_STEP)
    return same, worst


# --------------------------------------------------------------------- e
def copy_synthesis(corpus, wav_dir: str, n: int = 8) -> float:
    from magphase_jax.io import read_wav
    from magphase_jax.parallel.copy_synthesis import copy_synthesis_batch

    sigs = [read_wav(os.path.join(wav_dir, u.token + ".wav"))[0]
            for u in corpus[:n]]
    outs = copy_synthesis_batch(sigs, corpus[0].fs)
    worst = 0.0
    for u, sig, syn in zip(corpus, sigs, outs):
        assert np.all(np.isfinite(syn)), f"{u.token}: non-finite output"
        m = min(len(sig), len(syn))
        p99 = float(np.percentile(np.abs(syn[2000:m - 2000]
                                         - sig[2000:m - 2000]), 99))
        worst = max(worst, p99)
    print(f"   lossless copy-synthesis, {n} utts: worst p99 |err| = "
          f"{worst:.3e} (< 2^-15 = {2.0 ** -15:.3e})")
    assert worst < 2.0 ** -15, f"lossless p99 {worst:.3e}"
    return worst


# --------------------------------------------------------------------- f
def _oracle_check(rows: list, tok: str, name: str, err: float, tol: float,
                  precision: str) -> None:
    ok = err <= tol if tol == 0.0 else err < tol
    print(f"   oracle {tok} {name}: {err:.3e} "
          f"{'==' if tol == 0.0 else '<'} {tol:.1e} [{precision}] "
          f"{'ok' if ok else 'FAIL'}")
    rows.append((tok, name, err, tol, ok))


def oracle(corpus, wav_dir: str, n: int = 2, fft_len: int = 4096) -> list:
    """The framework vs the numpy port of the reference, same epochs.
    Tolerances are those of tests/test_ref_parity.py."""
    import jax
    from magphase_jax import epochs
    from magphase_jax.config import define_alpha, define_crossfade_params
    from magphase_jax.io import read_wav
    from magphase_jax.vocoder import compressed, lossless, postfilter

    ref = _refport()
    fft_p = "float32 FFT"
    mm_p = "float32 FFT, matmul precision=HIGHEST"
    rows = []
    for u in sorted(corpus, key=lambda u: u.duration)[:n]:
        path = os.path.join(wav_dir, u.token + ".wav")
        sig, fs = read_wav(path)
        pm_sec, voi = epochs.extract_epochs(sig, fs)
        r = ref.analysis_lossless(sig, fs, pm_sec, voi, fft_len=fft_len)
        g = lossless.analysis_lossless(path, fft_len=fft_len, pm_sec=pm_sec,
                                       voi=voi)
        r_mag, r_real, r_imag, r_f0, _, r_shift = r
        g_mag, g_real, g_imag, g_f0, _, g_shift = g
        assert g_mag.shape == r_mag.shape, (g_mag.shape, r_mag.shape)
        t = u.token
        _oracle_check(rows, t, "shift max|d|", float(np.max(np.abs(
            g_shift - r_shift))), 0.0, "int")
        _oracle_check(rows, t, "f0 max|d|", float(np.max(np.abs(
            g_f0 - r_f0))), 0.0, "float64 host")
        scale = float(np.max(r_mag))
        _oracle_check(rows, t, "mag max|d|/max", float(np.max(np.abs(
            g_mag - r_mag))) / scale, 2e-6, fft_p)
        for nm, rr, gg in (("real", r_real, g_real),
                           ("imag", r_imag, g_imag)):
            d = np.abs(gg - rr)
            _oracle_check(rows, t, f"{nm} p99|d|",
                          float(np.percentile(d, 99)), 2e-4, fft_p)
            _oracle_check(rows, t, f"{nm} max|d|*mag/max",
                          float(np.max(d * r_mag / scale)), 2e-5, fft_p)

        v_ref = ref.synthesis_from_lossless(r_mag, r_real, r_imag, r_f0, fs)
        v_got = lossless.synthesis_from_lossless(r_mag, r_real, r_imag,
                                                 r_f0, fs)
        assert v_got.shape == v_ref.shape
        _oracle_check(rows, t, "lossless resynthesis max|d|/max", float(
            np.max(np.abs(v_got - v_ref)) / np.max(np.abs(v_ref))), 1e-5,
            fft_p)

        r_c = ref.format_for_modelling(r_mag, r_real, r_imag, r_f0, fs,
                                       mag_dim=MAG_DIM, phase_dim=PHASE_DIM)
        g_c = compressed.format_for_modelling(r_mag, r_real, r_imag, r_f0,
                                              fs, mag_dim=MAG_DIM,
                                              phase_dim=PHASE_DIM)
        for nm, k in (("mel mag", 0), ("mel real", 1), ("mel imag", 2)):
            _oracle_check(rows, t, f"{nm} max|d|", float(np.max(np.abs(
                np.asarray(g_c[k]) - r_c[k]))), 2e-3, mm_p)
        _oracle_check(rows, t, "lf0 max|d|", float(np.max(np.abs(
            np.asarray(g_c[3]) - r_c[3]))), 1e-9, "float64 host")

        r_mml, r_mrm, r_mim = r_c[0], r_c[1], r_c[2]
        alpha = define_alpha(fs)
        mag_dim_ph = compressed.get_num_full_mel_coeffs_from_num_phase_coeffs(
            define_crossfade_params(fs)[0], PHASE_DIM, alpha, fs)
        u_mag, u_real, u_imag = (np.asarray(a) for a in jax.jit(
            compressed._unwarp_kernel, static_argnames=(
                "fft_len", "mag_dim_ph", "alpha", "alpha_phase"))(
            np.float32(r_mml), np.float32(r_mrm), np.float32(r_mim),
            fft_len=fft_len, mag_dim_ph=mag_dim_ph, alpha=alpha,
            alpha_phase=alpha))
        w_mag = np.exp(ref.sp_mel_unwarp(r_mml, fft_len // 2 + 1,
                                         alpha=alpha, in_type="log"))
        w_real, w_imag = ref.phase_uncompress_type1_mcep(
            r_mrm, r_mim, alpha, fft_len, fs)
        _oracle_check(rows, t, "unwarp log-mag max|d|", float(np.max(np.abs(
            np.log(u_mag) - np.log(w_mag)))), 1e-3, mm_p)
        for nm, a, b in (("unwarp real", u_real, w_real),
                         ("unwarp imag", u_imag, w_imag)):
            _oracle_check(rows, t, f"{nm} max|d|", float(np.max(np.abs(
                a - b))), 1e-3, mm_p)

        g_pf = np.asarray(postfilter.post_filter(np.float32(r_mml), fs))
        _oracle_check(rows, t, "post-filter max|d|", float(np.max(np.abs(
            g_pf - ref.post_filter(np.float32(r_mml), fs)))), 2e-4,
            "matmul precision=HIGHEST")
    bad = [r for r in rows if not r[4]]
    assert not bad, f"oracle mismatches: {bad}"
    return rows


# --------------------------------------------------------------------- g
def serve_one(token: str, feats_dir: str, out_dir: str, sock: str,
              fs: int = FS) -> float:
    """One `generate --server` request to a daemon on a thread of this
    process; returns the request's wall seconds."""
    from magphase_jax.serve import request, serve_forever

    ready = threading.Event()
    th = threading.Thread(target=serve_forever, args=(sock,),
                          kwargs=dict(ready_cb=ready.set), daemon=True)
    th.start()
    assert ready.wait(60), "serve daemon did not start"
    scp = os.path.join(os.path.dirname(out_dir), "serve.scp")
    with open(scp, "w") as f:
        f.write(token + "\n")
    try:
        t0 = time.perf_counter()
        generate(scp, feats_dir, out_dir, fs=fs, batch=1, server=sock)
        dt = time.perf_counter() - t0
    finally:
        request(sock, shutdown=True)
        th.join(60)
    return dt


# --------------------------------------------------------------------- h
def walk_witness(corpus, wav_dir: str, batch: int = 24, reps: int = 10):
    """The Pallas (Triton) epoch walk, compiled, vs the vmapped XLA walk:
    sample-exact equality and phase-1 (track + place) device time."""
    import functools

    import jax
    from magphase_jax.epochs import placement_device as pd
    from magphase_jax.io import read_wav
    from magphase_jax.parallel import analysis_batch as ab

    fs = corpus[0].fs
    sigs = [read_wav(os.path.join(wav_dir, u.token + ".wav"))[0]
            for u in corpus[:batch]]
    _, dev, _, Tmax, m_max, _ = ab._device_signal_batch(sigs, fs, None)
    sigs_d, n_sigs, n_frames = dev
    kw = dict(fs=fs, n_frames_max=Tmax, m_max=m_max)

    def xla_phase1(s, ns, nf):
        s = ab._sigs_f32(s)
        y, f0, voi = jax.vmap(functools.partial(
            pd._track_one, fs=fs, n_frames_max=Tmax))(s, nf)
        return jax.vmap(functools.partial(
            pd.place_epochs_kernel, fs=fs, m_max=m_max,
            frame_step=pd._walk_frame_step(fs)))(y, f0, voi, ns, nf)

    def prod_phase1(s, ns, nf):
        return pd.track_and_place_batch(ab._sigs_f32(s), ns, nf, **kw)

    progs = {"pallas": jax.jit(prod_phase1), "xla": jax.jit(xla_phase1)}
    hlo = progs["pallas"].lower(sigs_d, n_sigs, n_frames).as_text()
    assert "triton" in hlo, "production walk did not lower to Triton"
    outs = {k: [np.asarray(a) for a in jax.block_until_ready(
        f(sigs_d, n_sigs, n_frames))] for k, f in progs.items()}
    for a, b in zip(outs["pallas"], outs["xla"]):
        np.testing.assert_array_equal(a, b)
    times = {k: [] for k in progs}
    for _ in range(reps):
        for k, f in progs.items():
            t0 = time.perf_counter()
            jax.block_until_ready(f(sigs_d, n_sigs, n_frames))
            times[k].append(time.perf_counter() - t0)
    med = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    print(f"   epoch walk: Pallas(Triton) == XLA walk, marks "
          f"{int(outs['xla'][2][:len(sigs)].sum())} over {len(sigs)} utts")
    print(f"   phase-1 program (track + place), batch {len(sigs)}, {fs} Hz:"
          f" Pallas walk {med['pallas']:.3f} ms, XLA walk {med['xla']:.3f}"
          f" ms (median of {reps})")
    return med


# --------------------------------------------------------------------- main
def _peak_bytes(devices) -> list:
    return [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
            for d in devices]


def _compare_feature_dirs(corpus, dir_a: str, dir_b: str) -> tuple:
    """(max |d|, worst |d| / (SHARDED_ATOL + F16_RTOL * |value|)) over
    the mag/real/imag streams; pitch-mark shifts and voicing must agree
    exactly, lf0 to float32 rounding."""
    worst_abs, worst_ratio = 0.0, 0.0
    for u in corpus:
        fa, fb = read_features(dir_a, u.token), read_features(dir_b, u.token)
        np.testing.assert_array_equal(fa[4], fb[4], err_msg=u.token)
        np.testing.assert_array_equal(fa[3] > 0, fb[3] > 0, err_msg=u.token)
        np.testing.assert_allclose(fa[3], fb[3], rtol=1e-6, err_msg=u.token)
        for a, b in zip(fa[:3], fb[:3]):
            assert a.shape == b.shape, (u.token, a.shape, b.shape)
            d = np.abs(a.astype(np.float64) - b)
            tol = SHARDED_ATOL + F16_RTOL * np.maximum(np.abs(a), np.abs(b))
            worst_abs = max(worst_abs, float(np.max(d)))
            worst_ratio = max(worst_ratio, float(np.max(d / tol)))
    return worst_abs, worst_ratio


def run_four(corpus, wav_dir, scp, workdir, times) -> None:
    """--four: extract data-parallel over four GPUs and on one GPU, then
    generate from the same features both ways, in this process; outputs
    compared, and zero collectives in the compiled sharded kernels."""
    import jax
    from jax.sharding import Mesh

    import __graft_entry__ as graft

    fs = corpus[0].fs
    tokens = [u.token for u in corpus]
    feats = {t: os.path.join(workdir, f"feats_{t}") for t in ("4gpu", "1gpu")}
    wavs = {t: os.path.join(workdir, f"syn_{t}") for t in ("4gpu", "1gpu")}
    for tag, dp in (("4gpu", True), ("1gpu", False)):
        with phase(f"c extract ({tag})", times):
            extract(scp, wav_dir, feats[tag], data_parallel=dp)
            check_features(corpus, feats[tag])
    for tag, dp in (("4gpu", True), ("1gpu", False)):
        with phase(f"d generate ({tag}, from the 1-GPU features)", times):
            generate(scp, feats["1gpu"], wavs[tag], fs=fs, data_parallel=dp)
            check_wavs(corpus, feats["1gpu"], wavs[tag])
    print(f"   peak bytes per device: {_peak_bytes(jax.devices())}")
    d_abs, d_ratio = _compare_feature_dirs(corpus, feats["4gpu"],
                                           feats["1gpu"])
    same, d_wav = compare_wav_dirs(tokens, wavs["4gpu"], wavs["1gpu"])
    print(f"   extract, 4 GPUs vs 1 GPU: shifts and voicing identical; "
          f"mag/real/imag max|d| {d_abs:.3e}, at most {d_ratio:.3f} x "
          f"(atol {SHARDED_ATOL} + rtol 2^-10 (one float16 step))")
    print(f"   generate, 4 GPUs vs 1 GPU: wavs max|d| {d_wav * PCM_STEP:.3e}"
          f" ({d_wav:.0f} PCM16 steps, atol {SHARDED_ATOL}), "
          f"{same}/{len(tokens)} bytewise identical")
    assert d_ratio <= 1.0, f"features differ by {d_ratio:.3f} x tolerance"
    assert d_wav * PCM_STEP <= SHARDED_ATOL, f"wavs differ by {d_wav} steps"
    with phase("collectives proof (4 GPUs)", times):
        graft._dryrun_collectives_proof(
            Mesh(np.asarray(jax.devices()[:4]), axis_names=("data",)), 4)
        print("   compiled sharded kernels: zero collectives")


def run_one(corpus, wav_dir, scp, workdir, times, walk: bool = True,
            fft_len: int = 0) -> None:
    """Phases c-h on one device (``walk``: phase h, which needs a GPU)."""
    import jax

    fs = corpus[0].fs
    tokens = [u.token for u in corpus]
    feats = os.path.join(workdir, "feats")
    syn, syn2 = (os.path.join(workdir, d) for d in ("syn", "syn_rerun"))
    with phase("c extract", times):
        extract(scp, wav_dir, feats, fft_len=fft_len)
        check_features(corpus, feats)
    print(f"   peak bytes in use after c: {_peak_bytes(jax.devices()[:1])}")
    with phase("d generate", times):
        generate(scp, feats, syn, fs=fs)
        check_wavs(corpus, feats, syn)
    print(f"   peak bytes in use after d: {_peak_bytes(jax.devices()[:1])}")
    with phase("e copy-synthesis", times):
        copy_synthesis(corpus, wav_dir)
    with phase("f oracle", times):
        oracle(corpus, wav_dir, fft_len=fft_len or 4096)
    if walk:
        with phase("h kernel witness", times):
            walk_witness(corpus, wav_dir)
    with phase("d generate (rerun)", times):
        generate(scp, feats, syn2, fs=fs)
    same, worst = compare_wav_dirs(tokens, syn, syn2)
    print(f"   determinism: {same}/{len(tokens)} wavs bytewise identical "
          f"across two runs, max |d| {worst:.0f} PCM16 steps")
    assert same == len(tokens), "generate is not run-to-run deterministic"
    with phase("g serve", times):
        out = os.path.join(workdir, "syn_serve")
        dt = serve_one(tokens[0], feats, out, os.path.join(workdir, "s.sock"),
                       fs=fs)
        same1, worst1 = compare_wav_dirs(tokens[:1], syn, out)
        print(f"   serve request ({tokens[0]}): {dt:.3f} s wall; vs phase d:"
              f" bytewise identical {bool(same1)}, max |d| {worst1:.0f} "
              f"PCM16 steps")
        assert same1 == 1, "served output differs from phase d"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four GPUs: data-parallel vs one GPU, and the "
                    "zero-collectives proof (no other phase)")
    ap.add_argument("--n-utts", type=int, default=32)
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke"))
    args = ap.parse_args(argv)

    card = card_identity()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, REPO)
    import jax

    from magphase_jax.utils.padding import max_frame_elems

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform}")
    if args.four and len(devs) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}")
    times: dict = {}
    with phase("a identity", times):
        stats = devs[0].memory_stats() or {}
        print(f"   jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}"
              f" ({devs[0].platform}); XLA_FLAGS="
              f"{os.environ.get('XLA_FLAGS', '')!r}; default matmul "
              f"precision {jax.config.jax_default_matmul_precision}")
        print(f"   allocator bytes_limit {stats.get('bytes_limit')}; frame "
              f"budget max_frame_elems() = {max_frame_elems()} row-elements")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    with phase("b corpus", times):
        corpus, wav_dir, scp = make_corpus(args.workdir, args.n_utts)
    (run_four if args.four else run_one)(corpus, wav_dir, scp, args.workdir,
                                         times)
    print("phase wall seconds: " + json.dumps(
        {k: round(v, 3) for k, v in times.items()}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
