"""Batched corpus analysis: epoch tracking + lossless analysis +
mel-compression for many utterances in fused device calls.

Replaces the reference's Pool-parallel batch_feature_extraction_for_tts.py
(one process + one REAPER + three SPTK subprocesses per utterance) with
two device programs per utterance batch — tracking + on-device epoch
placement, then analysis + mel-compression at the realised frame bucket —
all shardable over the 'data' mesh axis.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..epochs import tracker
from ..epochs.placement_device import placement_m_max, track_and_place_batch
from ..utils.padding import (FRM_STEP, bucket, bucket_frames,
                             bucket_signal, max_frame_elems, pad_to)
from ..vocoder.compressed import (
    _format_kernel, get_num_full_mel_coeffs_from_num_phase_coeffs)
from .mesh import (budget_batch_cap, capped_batch_step, shard_batch,
                   sharded_kernel)


@functools.partial(jax.jit, static_argnames=("fs", "n_frames_max"))
def _track_batch_kernel(sigs, n_frames, *, fs: int, n_frames_max: int):
    """vmapped preprocess + NCCF + candidates + Viterbi."""
    def one(sig, nf):
        fs_a = tracker.analysis_rate(fs)[0]
        xa, y_snap = tracker._preprocess(sig, fs=fs)
        nccf, valid = tracker._nccf(xa, nf, n_frames_max=n_frames_max,
                                    fs_a=fs_a,
                                    whiten=tracker.nccf_whiten_mode())
        vals, lags = tracker._candidates(nccf)
        states = tracker._viterbi(vals, lags, valid, fs_a=fs_a)
        return states, vals, lags, y_snap

    return jax.vmap(one)(sigs, n_frames)


def track_f0_batch(signals: list, fs: int):
    """Batched F0 tracks.  Returns list of (f0, voiced, y_snap)."""
    B = len(signals)
    S = bucket_signal(max(len(s) for s in signals))
    sigs = np.stack([pad_to(np.asarray(s, np.float32), S) for s in signals])

    fs_a, dec = tracker.analysis_rate(fs)
    step = int(round(tracker.FRAME_STEP_S * fs_a))
    w = int(round(tracker.CORR_WIN_S * fs_a))
    max_lag = int(round(fs_a / tracker.F0_MIN))
    n_frames = np.asarray(
        [max(1, (len(s) // dec - (w + max_lag)) // step + 1)
         for s in signals], np.int32)
    Tmax = bucket(int(n_frames.max()), 128)

    states, vals, lags, y_snap = _track_batch_kernel(
        jnp.asarray(sigs), jnp.asarray(n_frames), fs=fs,
        n_frames_max=Tmax)
    states = np.asarray(jax.device_get(states))
    lags = np.asarray(jax.device_get(lags))
    y_snap = np.asarray(jax.device_get(y_snap))

    out = []
    for b in range(B):
        nf = int(n_frames[b])
        st = states[b, :nf]
        voiced = st < tracker.N_CAND
        lag_sel = np.where(
            voiced, lags[b, np.arange(nf),
                         np.clip(st, 0, tracker.N_CAND - 1)], 0.0)
        f0 = np.where(voiced & (lag_sel > 0),
                      fs_a / np.maximum(lag_sel, 1.0), 0.0)
        out.append((f0, voiced, y_snap[b, :len(signals[b])]))
    return out


def _tracker_frame_geometry(signals: list, fs: int):
    """Per-utterance NCCF frame counts + the bucketed frame maximum."""
    fs_a, dec = tracker.analysis_rate(fs)
    step = int(round(tracker.FRAME_STEP_S * fs_a))
    w = int(round(tracker.CORR_WIN_S * fs_a))
    max_lag = int(round(fs_a / tracker.F0_MIN))
    n_frames = np.asarray(
        [max(1, (len(s) // dec - (w + max_lag)) // step + 1)
         for s in signals], np.int32)
    return n_frames, bucket(int(n_frames.max()), 128)


def _budget_geometry(signals: list, fs: int, fft_len: int, mesh=None):
    """(S, m_max, max_batch): signal bucket, worst-case frame capacity of
    the longest utterance, and the largest device batch whose fused
    program stays inside the device-memory budget (max_frame_elems() —
    long utterances mean fewer utterances per program)."""
    S = bucket_signal(max(len(s) for s in signals))
    m_max = placement_m_max(S, fs, FRM_STEP)
    # the budget is PER DEVICE: a data mesh shards the batch axis, so the
    # total batch scales with the mesh size
    budget = max_frame_elems() * (mesh.size if mesh is not None else 1)
    max_b = max(1, int(budget // (m_max * fft_len)))
    return S, m_max, budget_batch_cap(mesh, max_b)


def _split_for_budget(signals: list, fs: int, fft_len: int, mesh=None):
    """Split an utterance list into groups that each fit the HBM budget."""
    _, _, max_b = _budget_geometry(signals, fs, fft_len, mesh)
    if len(signals) <= max_b:
        return [signals]
    return [signals[i:i + max_b] for i in range(0, len(signals), max_b)]


def _epochs_budget(epochs, fft_len: int, mesh=None) -> int:
    """Max batch for the given-epochs kernels under the device-memory
    budget (the frame axis comes from the provided epochs, not the walk
    capacity)."""
    F_est = bucket(max(len(p) for p, _ in epochs), FRM_STEP)
    budget = max_frame_elems() * (mesh.size if mesh is not None else 1)
    max_b = max(1, int(budget // (F_est * fft_len)))
    return budget_batch_cap(mesh, max_b)


def assemble_signal_rows(signals: list, B: int, S: int) -> np.ndarray:
    """(B, S) padded batch matrix, preallocated + row-assigned.

    Uploaded as int16 when every signal is exactly PCM16-valued (true for
    anything read from a 16-bit wav): halves the upload bytes, and the
    kernels rescale on device bit-identically (k/32768 is exact in
    float32).  Any non-PCM16 signal falls back to one float32 batch."""
    rows16 = np.zeros((B, S), np.int16)
    for b, s in enumerate(signals):
        a = np.asarray(s)
        q = np.rint(a * 32768.0)
        if not (q.size == 0 or
                (q.min(initial=0) >= -32768 and q.max(initial=0) <= 32767
                 and np.array_equal(q / 32768.0, a))):
            break
        rows16[b, :len(a)] = q.astype(np.int16)
    else:
        return rows16
    rows = np.zeros((B, S), np.float32)
    for b, s in enumerate(signals):
        rows[b, :len(s)] = s
    return rows


def _sigs_f32(sigs):
    """Device-side inverse of assemble_signal_rows' int16 packing."""
    if sigs.dtype == jnp.int16:
        return sigs.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
    return sigs


def _run_kernel(jitted, impl, mesh, args, static_kw):
    """Run a batched kernel: plain jit on one device, jit(shard_map(impl))
    over the data mesh otherwise (communication-free by construction —
    see parallel/mesh.py:sharded_kernel)."""
    if mesh is None:
        return jitted(*args, **static_kw)
    return sharded_kernel(impl, mesh, len(args), static_kw)(*args)


def _host_signal_batch(signals: list, fs: int, mesh=None,
                       fft_len: int = 4096):
    """Host half of the signal-batch assembly (no device transfer).

    Returns (signals_incl_dummies, (sigs, n_sigs, n_frames) numpy,
    S, Tmax, m_max, n_real).  The batch axis is padded with short silent
    dummies to a bucket step (compile-variant bounding) capped by the HBM
    budget — a single long utterance must not be padded to a batch of 8.
    """
    n_real = len(signals)
    S, m_max, max_b = _budget_geometry(signals, fs, fft_len, mesh)
    B = bucket(n_real, capped_batch_step(mesh, max_b))
    if B > n_real:
        signals = list(signals) + [np.zeros(1024)] * (B - n_real)
    sigs = assemble_signal_rows(signals, B, S)
    n_sigs = np.asarray([len(s) for s in signals], np.int32)
    n_frames, Tmax = _tracker_frame_geometry(signals, fs)
    return signals, (sigs, n_sigs, n_frames), S, Tmax, m_max, n_real


def _upload_signal_batch(host_arrays, mesh=None):
    """Device half: push (sigs, n_sigs, n_frames), optionally sharded.

    Blocks until the transfer lands so the upload's cost is paid HERE —
    on the pipeline's upload thread — not inside the next kernel
    dispatch on the compute thread (device_put is fire-and-forget).  The
    big signal tensor goes up as per-chunk-blocking slices
    (utils/transfer.py), which bounds a concurrent download's stall
    behind it at one chunk."""
    if mesh is not None:
        sigs_d, n_sigs_d, n_frames_d = (jnp.asarray(a)
                                        for a in host_arrays)
        sigs_d, n_sigs_d, n_frames_d = shard_batch(
            mesh, sigs_d, n_sigs_d, n_frames_d)
        jax.block_until_ready(sigs_d)
        return sigs_d, n_sigs_d, n_frames_d
    from ..utils.transfer import device_put_chunked
    # small operands FIRST: queued ahead of the chunked put they ride
    # the stream for free, queued after it they each pay their own
    # post-upload round trip (CLAUDE.md; same ordering as
    # batch.py:_upload_synthesis_group)
    n_sigs_d, n_frames_d = (jnp.asarray(a) for a in host_arrays[1:])
    sigs_d = device_put_chunked(host_arrays[0])
    jax.block_until_ready((n_sigs_d, n_frames_d))
    return sigs_d, n_sigs_d, n_frames_d


def _device_signal_batch(signals: list, fs: int, mesh=None,
                         fft_len: int = 4096):
    """Bucket/pad a list of signals for the fused tracker kernels and
    upload them (host assembly + transfer in one step; the pipelined
    paths split these across threads)."""
    signals, host, S, Tmax, m_max, n_real = _host_signal_batch(
        signals, fs, mesh, fft_len)
    return (signals, _upload_signal_batch(host, mesh), S, Tmax, m_max,
            n_real)


@functools.partial(jax.jit, static_argnames=("n",))
def _trim_frames(arrs, *, n: int):
    """Slice the frame axis to the realised bucket before host transfer.

    The fused kernels pad frames to the static worst case m_max; the actual
    mark counts are usually far below it, so slicing on device first cuts
    the (transfer-bound) feature download proportionally."""
    return tuple(a[:, :n] for a in arrs)


def _fused_track_lossless_impl(sigs, n_sigs, n_frames, *, fs: int,
                                 n_frames_max: int, m_max: int,
                                 fft_len: int, transport: str = "f32"):
    """Tracking + epoch placement + lossless analysis in ONE device program.

    Replaces the reference's REAPER-subprocess-then-analyse sequence
    (magphase.py:2869-2906) without the low-passed-signal download the
    host epoch walk needs (6.5 MB per 10-utterance batch); only
    the feature tensors and the tiny mark arrays leave the device.

    ``transport`` — download encoding of the full-resolution features
    (the dominant download of lossless corpus extraction):
      * 'f32': exact (12 B/bin: mag, real, imag float32).
      * 'compact': phasor as an int16 angle (6 B/bin; host reconstructs
        real=cos, imag=sin).  Mag stays float32 because f16 mag alone
        breaks the sub-PCM16 copy-synthesis budget (measured p99 8.8e-5
        vs the 2^-15 = 3.05e-5 gate; f32 mag + int16 angle: 1.1e-5).
      * 'compact16': 'compact' + per-(utterance, bin) affine uint16 mag
        over valid frames (4 B/bin, 3x under f32).  Unlike f16 (relative
        ~4.9e-4 everywhere) the affine step is ABSOLUTE at bin-peak /
        65535 ~= 1.5e-5 relative to the bin's loudest frame — the frames
        that carry the synthesis energy — so the waveform budget holds
        (gated in tests/test_analysis_batch.py).
        Frame-axis outputs come first so the download trim stays
        uniform; (scale, lo) is frameless.
    """
    from ..vocoder.lossless import analysis_core_batch

    sigs = _sigs_f32(sigs)
    marks, flags, n_marks = track_and_place_batch(
        sigs, n_sigs, n_frames, fs=fs, n_frames_max=n_frames_max,
        m_max=m_max)
    mag, real, imag, _f0, shift = analysis_core_batch(
        sigs, marks, n_marks, n_sigs, flags, fft_len=fft_len, fs=fs)
    if transport in ("compact", "compact16"):
        ang = jnp.arctan2(imag, real)
        ang_i16 = jnp.clip(jnp.rint(ang * jnp.float32(32768.0 / np.pi)),
                           -32768, 32767).astype(jnp.int16)
        if transport == "compact16":
            F = mag.shape[1]
            valid = (jnp.arange(F)[None, :, None]
                     < n_marks[:, None, None])
            big = jnp.float32(3.0e38)
            lo = jnp.min(jnp.where(valid, mag, big), axis=1)
            hi = jnp.max(jnp.where(valid, mag, -big), axis=1)
            lo = jnp.minimum(lo, hi)
            scale = jnp.where(hi > lo, (hi - lo) / 65535.0, 1.0)
            q = jnp.clip(jnp.rint((mag - lo[:, None, :])
                                  / scale[:, None, :]), 0, 65535
                         ).astype(jnp.uint16)
            return (q, ang_i16, shift, flags,
                    jnp.stack([scale, lo], axis=1), n_marks)
        return mag, ang_i16, shift, flags, n_marks
    return mag, real, imag, shift, flags, n_marks


_fused_track_lossless_kernel = functools.partial(
    jax.jit, static_argnames=("fs", "n_frames_max", "m_max", "fft_len",
                              "transport"))(_fused_track_lossless_impl)


def _compress_streams(mag, real, imag, f0, *, mag_dim, phase_dim,
                      mag_dim_ph, alpha, alpha_phase):
    """(B, F, h) lossless streams -> (B, F, dims) compressed streams + lf0
    (format_for_modelling, magphase.py:2490-2544, incl. the on-device
    medfilt f0 smoothing of 2499-2501)."""
    from ..core.filters import medfilt3
    from ..core.spectral import f0_to_lf0

    B, F, h = mag.shape
    voi_f = (f0 > 0).astype(mag.dtype)
    mml, mrm, mim = _format_kernel(
        mag.reshape(B * F, h), real.reshape(B * F, h),
        imag.reshape(B * F, h), voi_f.reshape(B * F),
        mag_dim=mag_dim, phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
        alpha=alpha, alpha_phase=alpha_phase)
    f0_smth = voi_f * jax.vmap(medfilt3)(f0)
    lf0 = f0_to_lf0(f0_smth)
    return (mml.reshape(B, F, mag_dim), mrm.reshape(B, F, phase_dim),
            mim.reshape(B, F, phase_dim), lf0)


def _const_resample_batch(mag, real, imag, f0, pm, nfrms, *, crs: float,
                          fc_max: int):
    """Batched variable -> constant 5 ms grid resampling of the lossless
    streams (analysis_compressed's const-rate block, magphase.py:2967-2980)."""
    from ..vocoder.framerate import const_rate_resample_core

    def one(m, r, i, f, p, n):
        (mc, rc, ic), f0c, n_const = const_rate_resample_core(
            (m, r, i), f, p, n, const_rate_smpls=crs, fc_max=fc_max)
        return mc, rc, ic, f0c, n_const

    return jax.vmap(one)(mag, real, imag, f0, pm, nfrms)


def _track_place_impl(sigs, n_sigs, n_frames, *, fs: int,
                      n_frames_max: int, m_max: int):
    """Phase 1 of the two-phase production path: tracking + placement.
    Returns (marks, flags, n_marks) — stays on device."""
    return track_and_place_batch(_sigs_f32(sigs), n_sigs, n_frames,
                                 fs=fs, n_frames_max=n_frames_max,
                                 m_max=m_max)


_track_place_kernel = functools.partial(
    jax.jit, static_argnames=("fs", "n_frames_max", "m_max"))(
        _track_place_impl)


def _analyze_compress_impl(sigs, marks, flags, n_marks, n_sigs, *,
                             fs: int, fft_len: int, F: int, mag_dim: int,
                             phase_dim: int, mag_dim_ph: int, alpha: float,
                             alpha_phase: float, fc_max: int = 0,
                             feats_f16: bool = False, pack: bool = False):
    """Phase 2: analysis + mel-compression at the REALISED frame bucket F.

    The walk capacity m_max is the 400-marks/s worst case; real speech
    places ~40% of that, so running the FFT + mcep solve at
    F = bucket(max n_marks) instead of m_max cuts the padded frame
    compute ~2x.  Only the tiny n_marks array crosses the host link
    between the phases (the signals and marks stay on device).

    ``pack`` (variable-rate only): return (feats, aux, n_valid) with the
    mel streams concatenated into ONE (B, F, mag+2*phase) tensor and
    lf0/shift stacked into (B, F, 2) f32 — one big download instead of
    several small ones."""
    from ..vocoder.lossless import analysis_core_batch

    sigs = _sigs_f32(sigs)
    marks = marks[:, :F]
    flags = flags[:, :F]
    mag, real, imag, f0, shift = analysis_core_batch(
        sigs, marks, n_marks, n_sigs, flags, fft_len=fft_len, fs=fs)
    if fc_max > 0:
        mag, real, imag, f0, n_valid = _const_resample_batch(
            mag, real, imag, f0, marks, n_marks,
            crs=fs * 5.0 / 1000.0, fc_max=fc_max)
    else:
        n_valid = n_marks
    mml, mrm, mim, lf0 = _compress_streams(
        mag, real, imag, f0, mag_dim=mag_dim, phase_dim=phase_dim,
        mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase)
    if pack and fc_max == 0:
        feats = jnp.concatenate([mml, mrm, mim], axis=-1)
        aux = jnp.stack([lf0, shift.astype(jnp.float32)], axis=-1)
        if feats_f16 == "u8":
            # int8 transfer encoding (quarter of f32): per-(utterance,
            # coefficient) affine over VALID frames, computed on device —
            # mirrors parallel/batch.py:quantise_feats for the upload
            # direction.  Max error = range/510 per coefficient (~0.5%
            # of the utterance's per-coeff dynamic range) — opt-in for
            # transfer-bound links; training-grade extraction keeps f16.
            B, F, D = feats.shape
            valid = (jnp.arange(F)[None, :, None]
                     < n_valid[:, None, None])
            big = jnp.float32(3.0e38)
            lo = jnp.min(jnp.where(valid, feats, big), axis=1)
            hi = jnp.max(jnp.where(valid, feats, -big), axis=1)
            lo = jnp.minimum(lo, hi)
            scale = jnp.where(hi > lo, (hi - lo) / 255.0, 1.0)
            q = jnp.clip(jnp.rint((feats - lo[:, None, :])
                                  / scale[:, None, :]), 0, 255
                         ).astype(jnp.uint8)
            return q, jnp.stack([scale, lo], axis=1), aux, n_valid
        if feats_f16:
            # f16 download encoding:
            # the mel streams quantise to ~1e-3 relative — far below the
            # mel compression error — lf0 (MAGIC -1e10)/shift stay f32,
            # BITCAST into four extra u16 channels so the whole group
            # leaves as ONE tensor (one device_get instead of several).
            # The combined tensor is downloaded as
            # UINT16, never float16: a backend may canonicalise f16 NaN
            # payloads in transit (bench.py:check_aux_bitcast_roundtrip
            # checks the device), and an f32 lf0's low mantissa half
            # forms such a pattern ~3% of the time — integer lanes are
            # bit-transparent
            Bp, Fp, _ = feats.shape
            feats16 = jax.lax.bitcast_convert_type(
                feats.astype(jnp.float16), jnp.uint16)
            aux16 = jax.lax.bitcast_convert_type(
                aux.astype(jnp.float32), jnp.uint16).reshape(Bp, Fp, 4)
            return jnp.concatenate([feats16, aux16], axis=-1), n_valid
        return feats, aux, n_valid
    if feats_f16:
        mml, mrm, mim = (x.astype(jnp.float16) for x in (mml, mrm, mim))
    return mml, mrm, mim, lf0, shift, n_valid


_analyze_compress_kernel = functools.partial(
    jax.jit, static_argnames=("fs", "fft_len", "F", "mag_dim", "phase_dim",
                              "mag_dim_ph", "alpha", "alpha_phase",
                              "fc_max", "feats_f16", "pack"))(
                                  _analyze_compress_impl)


def _analysis_batch_impl(sigs, pm, nfrms, n_sig, voi, *, fft_len: int,
                         fs: int):
    from ..vocoder.lossless import analysis_core_batch
    return analysis_core_batch(sigs, pm, nfrms, n_sig, voi,
                               fft_len=fft_len, fs=fs)


# module-level jit: a per-call jax.jit(partial(...)) would recompile
# on every invocation (the partial is a fresh callable each time)
_analysis_batch_jit = functools.partial(
    jax.jit, static_argnames=("fft_len", "fs"))(_analysis_batch_impl)


def analysis_lossless_batch(signals: list, fs: int,
                            fft_len: int | None = None,
                            epochs: list | None = None,
                            mesh=None, transport: str = "f32"):
    """Batched lossless analysis.  Returns list of
    (m_mag, m_real, m_imag, v_f0, v_shift) float32/int numpy tuples.

    ``epochs``: optional list of (pm_sec, voi) overriding the tracker.
    ``mesh``: optional 1-D data mesh; the batch axis is sharded over it.
    ``transport`` (tracker path): 'f32' (exact), 'compact' (phasor as
    int16 angle over the host link — half the download bytes) or
    'compact16' (additionally uint16-affine mag per (utterance, bin) —
    a third of f32).  Both compressed encodings stay inside the
    sub-PCM16 copy-synthesis budget (gated in
    tests/test_analysis_batch.py); the on-disk float32 feature contract
    (libutils.py:112-127) is unchanged — only the link encoding differs.
    """
    if fft_len is None:
        fft_len = define_fft_len(fs)

    if epochs is None:
        # fused device path: tracking + placement + analysis in one
        # program, split into sub-batches under the device-memory budget; the
        # upload / compute / download legs run on separate threads
        # (utils/pipeline.py) so the link works both directions while
        # the device computes
        if transport not in ("f32", "compact", "compact16"):
            raise ValueError(f"unknown transport {transport!r}")

        def prep(group):
            signals_g, host, S, Tmax, m_max, n_real = _host_signal_batch(
                group, fs, mesh, fft_len=fft_len)
            return dict(signals=signals_g, host=host, Tmax=Tmax,
                        m_max=m_max, n_real=n_real)

        def upload(p):
            p["dev"] = _upload_signal_batch(p["host"], mesh)
            del p["host"]
            return p

        def compute(p):
            """No device round-trip here: the mark counts are fetched on
            the download thread (where a tiny device_get serialises
            naturally with downstream traffic instead of stalling the
            dispatch queue — see analysis_compressed_batch_async)."""
            out = _run_kernel(
                _fused_track_lossless_kernel, _fused_track_lossless_impl,
                mesh, p["dev"], dict(fs=fs, n_frames_max=p["Tmax"],
                                     m_max=p["m_max"], fft_len=fft_len,
                                     transport=transport))
            try:
                out[-1].copy_to_host_async()
            except Exception:
                pass
            p["out_full"] = out
            del p["dev"]
            return p

        def download(p):
            out_full = p.pop("out_full")
            nm = np.asarray(jax.device_get(out_full[-1]))
            Fa = min(p["m_max"], bucket(int(nm.max()), FRM_STEP))
            # device-side trim to the realised bucket: the (transfer-
            # bound) full-resolution download moves only real frames
            # (compact16's (scale, lo) operand has no frame axis)
            n_frame_axis = 4 if transport == "compact16" else \
                len(out_full) - 1
            p["out"] = (_trim_frames(tuple(out_full[:n_frame_axis]),
                                     n=Fa)
                        + tuple(out_full[n_frame_axis:-1]))
            n_real = p["n_real"]
            out = []
            if transport in ("compact", "compact16"):
                got = jax.device_get(p["out"])
                if transport == "compact16":
                    q16, ang, shift, flags, scale_lo = got
                else:
                    mag_f32, ang, shift, flags = got
                for b in range(n_real):
                    n = int(nm[b])
                    if transport == "compact16":
                        mag_b = (q16[b, :n].astype(np.float64)
                                 * scale_lo[b, 0] + scale_lo[b, 1]
                                 ).astype(np.float32)
                    else:
                        mag_b = mag_f32[b, :n]
                    a = ang[b, :n].astype(np.float64) * (np.pi / 32768.0)
                    sh = shift[b, :n].astype(np.int64)
                    f0 = (flags[b, :n].astype(np.float64) * fs /
                          np.maximum(sh, 1).astype(np.float64))
                    # digitally-silent bins: the exact transport stores
                    # (real, imag) = (0, 0) (lossless.py:63-65); the
                    # angle decode would yield (cos 0, sin 0) = (1, 0),
                    # diverging saved feature files by 1.0 there
                    nz = mag_b > 0.0
                    out.append((mag_b,
                                np.where(nz, np.cos(a), 0.0
                                         ).astype(np.float32),
                                np.where(nz, np.sin(a), 0.0
                                         ).astype(np.float32), f0, sh))
            else:
                mag, real, imag, shift, flags = jax.device_get(p["out"])
                for b in range(n_real):
                    n = int(nm[b])
                    sh = shift[b, :n].astype(np.int64)
                    f0 = (flags[b, :n].astype(np.float64) * fs /
                          np.maximum(sh, 1).astype(np.float64))
                    out.append((mag[b, :n], real[b, :n], imag[b, :n],
                                f0, sh))

            trunc = [b for b in range(n_real) if int(nm[b]) >= p["m_max"]]
            if trunc:
                from ..epochs.tracker import extract_epochs
                from ..utils.metrics import logger
                logger.warning("epoch-walk capacity hit for %d utterance(s);"
                               " host-walk fallback", len(trunc))
                sigs_g = p["signals"]
                eps = [extract_epochs(sigs_g[b], fs) for b in trunc]
                fixed = analysis_lossless_batch(
                    [sigs_g[b] for b in trunc], fs, fft_len=fft_len,
                    epochs=eps)
                for j, b in enumerate(trunc):
                    out[b] = fixed[j]
            return out

        from ..utils.pipeline import run_staged
        groups = _split_for_budget(signals, fs, fft_len, mesh)
        all_out = []
        for chunk in run_staged(map(prep, groups),
                                [upload, compute, download]):
            all_out.extend(chunk)
        return all_out

    # HBM budget + bucket the batch axis (dummies dropped on return)
    n_real = len(signals)
    max_b = _epochs_budget(epochs, fft_len, mesh)
    if n_real > max_b:
        out = []
        for i in range(0, n_real, max_b):
            out.extend(analysis_lossless_batch(
                signals[i:i + max_b], fs, fft_len=fft_len,
                epochs=epochs[i:i + max_b], mesh=mesh))
        return out
    B = bucket(n_real, capped_batch_step(mesh, max_b))
    if B > n_real:
        d_sig = np.zeros(1024)
        d_ep = (np.asarray([100, 300]) / float(fs), np.zeros(2))
        signals = list(signals) + [d_sig] * (B - n_real)
        epochs = list(epochs) + [d_ep] * (B - n_real)

    pms = [np.asarray(np.round(np.asarray(p) * fs), np.int64)
           for p, _ in epochs]
    vois = [np.asarray(v, np.float64) for _, v in epochs]
    nfrms = [len(p) for p in pms]

    S = bucket_signal(max(len(s) for s in signals))
    F = bucket(max(nfrms), FRM_STEP)
    sigs_d = jnp.asarray(np.stack(
        [pad_to(np.asarray(s, np.float32), S) for s in signals]))
    pm_d = jnp.asarray(np.stack(
        [pad_to(p.astype(np.int32), F) for p in pms]))
    voi_d = jnp.asarray(np.stack(
        [pad_to(v.astype(np.float32), F) for v in vois]))
    nfrms_d = jnp.asarray(np.asarray(nfrms, np.int32))
    nsig_d = jnp.asarray(np.asarray([len(s) for s in signals], np.int32))

    if mesh is not None:
        sigs_d, pm_d, nfrms_d, nsig_d, voi_d = shard_batch(
            mesh, sigs_d, pm_d, nfrms_d, nsig_d, voi_d)

    mag, real, imag, _f0, shift = _run_kernel(
        _analysis_batch_jit, _analysis_batch_impl, mesh,
        (sigs_d, pm_d, nfrms_d, nsig_d, voi_d),
        dict(fft_len=fft_len, fs=fs))
    mag, real, imag, shift = jax.device_get((mag, real, imag, shift))

    out = []
    for b in range(n_real):
        n = nfrms[b]
        sh = shift[b, :n].astype(np.int64)
        f0 = vois[b][:n] * fs / sh.astype(np.float64)
        out.append((mag[b, :n], real[b, :n], imag[b, :n], f0, sh))
    return out


def _fused_compressed_impl(sigs, pm, nfrms, n_sig, voi, *, fft_len, fs,
                             mag_dim, phase_dim, mag_dim_ph, alpha,
                             alpha_phase, fc_max: int = 0):
    """Analysis + mel-compression in ONE device program (epochs given).

    Materialising the lossless (B, F, fft_len/2+1) feature tensors to host
    between the two stages moves ~50 MB per batch to the host and back for
    features that are immediately re-uploaded; fusing keeps them in HBM and
    returns only the compressed (B, F, mag_dim/phase_dim) streams.
    fc_max > 0 selects constant 5 ms frame-rate output."""
    from ..vocoder.lossless import analysis_core_batch

    mag, real, imag, f0, shift = analysis_core_batch(
        sigs, pm, nfrms, n_sig, voi, fft_len=fft_len, fs=fs)
    if fc_max > 0:
        mag, real, imag, f0, n_valid = _const_resample_batch(
            mag, real, imag, f0, pm, nfrms,
            crs=fs * 5.0 / 1000.0, fc_max=fc_max)
    else:
        n_valid = nfrms
    mml, mrm, mim, lf0 = _compress_streams(
        mag, real, imag, f0, mag_dim=mag_dim, phase_dim=phase_dim,
        mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase)
    return mml, mrm, mim, lf0, shift, n_valid


_fused_compressed_kernel = functools.partial(
    jax.jit, static_argnames=("fft_len", "fs", "mag_dim", "phase_dim",
                              "mag_dim_ph", "alpha", "alpha_phase",
                              "fc_max"))(_fused_compressed_impl)


def analysis_compressed_batch(signals: list, fs: int, mag_dim: int = 60,
                              phase_dim: int = 45,
                              fft_len: int | None = None,
                              epochs: list | None = None,
                              alpha_phase: float | None = None,
                              b_const_rate: bool = False,
                              mesh=None, feat_dtype=np.float16):
    """Batched compressed analysis, fully fused on device.  Returns list of
    (mag_mel_log, real_mel, imag_mel, lf0, shift); with b_const_rate the
    feature streams are on the constant 5 ms grid while shift stays the
    variable-rate track (analysis_compressed contract,
    magphase.py:2947-2988)."""
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)

    def fc_max_for(S):
        if not b_const_rate:
            return 0
        return bucket(int(np.ceil(S / (fs * 5.0 / 1000.0))), FRM_STEP)

    if epochs is None:
        return analysis_compressed_batch_async(
            signals, fs, mag_dim=mag_dim, phase_dim=phase_dim,
            fft_len=fft_len, alpha_phase=alpha_phase,
            b_const_rate=b_const_rate, mesh=mesh,
            feat_dtype=feat_dtype)()

    # HBM budget + bucket the batch axis (dummies dropped on return)
    n_real = len(signals)
    max_b = _epochs_budget(epochs, fft_len, mesh)
    if n_real > max_b:
        out = []
        for i in range(0, n_real, max_b):
            out.extend(analysis_compressed_batch(
                signals[i:i + max_b], fs, mag_dim=mag_dim,
                phase_dim=phase_dim, fft_len=fft_len,
                epochs=epochs[i:i + max_b], alpha_phase=alpha_phase,
                b_const_rate=b_const_rate, mesh=mesh))
        return out
    B = bucket(n_real, capped_batch_step(mesh, max_b))
    if B > n_real:
        d_sig = np.zeros(1024)
        d_ep = (np.asarray([100, 300]) / float(fs), np.zeros(2))
        signals = list(signals) + [d_sig] * (B - n_real)
        epochs = list(epochs) + [d_ep] * (B - n_real)

    pms = [np.asarray(np.round(np.asarray(p) * fs), np.int64)
           for p, _ in epochs]
    vois = [np.asarray(v, np.float64) for _, v in epochs]
    nfrms = [len(p) for p in pms]

    S = bucket_signal(max(len(s) for s in signals))
    F = bucket(max(nfrms), FRM_STEP)
    sigs_d = jnp.asarray(np.stack(
        [pad_to(np.asarray(s, np.float32), S) for s in signals]))
    pm_d = jnp.asarray(np.stack(
        [pad_to(p.astype(np.int32), F) for p in pms]))
    voi_d = jnp.asarray(np.stack(
        [pad_to(v.astype(np.float32), F) for v in vois]))
    nfrms_d = jnp.asarray(np.asarray(nfrms, np.int32))
    nsig_d = jnp.asarray(np.asarray([len(s) for s in signals], np.int32))

    if mesh is not None:
        sigs_d, pm_d, nfrms_d, nsig_d, voi_d = shard_batch(
            mesh, sigs_d, pm_d, nfrms_d, nsig_d, voi_d)

    mml, mrm, mim, lf0, shift, n_valid = _run_kernel(
        _fused_compressed_kernel, _fused_compressed_impl, mesh,
        (sigs_d, pm_d, nfrms_d, nsig_d, voi_d),
        dict(fft_len=fft_len, fs=fs, mag_dim=mag_dim, phase_dim=phase_dim,
             mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase,
             fc_max=fc_max_for(S)))
    n_valid = np.asarray(jax.device_get(n_valid))
    Fa = bucket(int(n_valid.max()), FRM_STEP)
    mml, mrm, mim, lf0 = jax.device_get(_trim_frames(
        (mml, mrm, mim, lf0), n=Fa))
    shift = np.asarray(jax.device_get(shift))

    out = []
    for b in range(n_real):
        n = int(n_valid[b])
        out.append((mml[b, :n].astype(np.float64),
                    mrm[b, :n].astype(np.float64),
                    mim[b, :n].astype(np.float64),
                    lf0[b, :n].astype(np.float64),
                    shift[b, :nfrms[b]].astype(np.int64)))
    return out


def analysis_compressed_batch_async(signals: list, fs: int,
                                    mag_dim: int = 60, phase_dim: int = 45,
                                    fft_len: int | None = None,
                                    alpha_phase: float | None = None,
                                    b_const_rate: bool = False,
                                    mesh=None, feat_dtype=np.float16):
    """Threaded three-stage tracking -> analysis+compression production
    path for one utterance batch; work starts immediately, returns
    ``finalize() -> feats``.

    ``feat_dtype``: host-link transfer encoding for the mel streams —
    np.float16 (default: halves the dominant feature download, ~1e-3
    relative quantisation, far below the mel compression error),
    np.float32 (bit-exact parity with the epochs-given sync path), or
    np.uint8 (quarter of f32 via a device-side per-(utterance,
    coefficient) affine; max error range/510 per coefficient — for
    transfer-bound links where the downstream leg paces the pipeline;
    applies to the variable-rate packed path, const-rate falls back to
    float16).

    Schedule (utils/pipeline.py:run_staged, one thread per stage): while
    group k's two device programs run, group k+1's signal rows ride the
    link upstream and group k-1's packed feature tensor rides it
    downstream, so steady-state cost is the slowest leg, not the sum.
    Downloads are packed into one (B, F, D) f16 tensor + one (B, F, 2)
    f32 aux: one big transfer instead of several small ones."""
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)
    if np.dtype(feat_dtype) == np.uint8:
        feats_enc = "u8"          # device-side affine int8 (see kernel)
    else:
        feats_enc = np.dtype(feat_dtype) == np.float16

    def prep(group):
        """Feeder thread: host-side batch assembly (numpy only)."""
        signals_g, host, S, Tmax, m_max, n_real = _host_signal_batch(
            group, fs, mesh, fft_len=fft_len)
        fc_max = (bucket(int(np.ceil(S / (fs * 5.0 / 1000.0))), FRM_STEP)
                  if b_const_rate else 0)
        return dict(signals=signals_g, host=host, Tmax=Tmax, m_max=m_max,
                    n_real=n_real, fc_max=fc_max)

    def upload(p):
        """Upload thread: push the signal rows (the upstream leg)."""
        p["dev"] = _upload_signal_batch(p["host"], mesh)
        del p["host"]
        return p

    def compute(p):
        """Compute thread: phase 1, then phase 2 dispatched SPECULATIVELY
        at the walk capacity m_max — no device round-trip gates dispatch.

        The realised mark counts are fetched on the DOWNLOAD thread
        instead (where a tiny device_get naturally serialises with the
        other downstream traffic): a compute-thread device_get(n_marks)
        can queue behind the previous group's feature download on the
        shared downstream channel, stalling every subsequent dispatch.
        The padded phase-2 compute (m_max vs the ~40% realised bucket) costs
        ~2x device time;
        the download still moves only the realised bucket because the
        trim happens on device before the big get.
        MAGPHASE_ANALYSIS_SYNC=1 restores the synced schedule (A/B)."""
        dev = p["dev"]
        marks, flags, n_marks = _run_kernel(
            _track_place_kernel, _track_place_impl, mesh, dev,
            dict(fs=fs, n_frames_max=p["Tmax"], m_max=p["m_max"]))
        if os.environ.get("MAGPHASE_ANALYSIS_SYNC") == "1":
            # synced schedule: (B,) mark counts are downloaded here and
            # phase 2 runs at the realised geometric frame bucket
            nm = np.asarray(jax.device_get(n_marks))
            Fa = min(p["m_max"], bucket_frames(int(nm.max())))
            p["nm"] = nm
        else:
            nm = None
            Fa = p["m_max"]
            try:
                # start the tiny mark-count transfer in the background;
                # by the time the download thread reads it the bytes are
                # usually already on host
                n_marks.copy_to_host_async()
            except Exception:
                pass
        p["out"] = _run_kernel(
            _analyze_compress_kernel, _analyze_compress_impl, mesh,
            (dev[0], marks, flags, n_marks, dev[1]),
            dict(fs=fs, fft_len=fft_len, F=Fa, mag_dim=mag_dim,
                 phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
                 alpha=alpha, alpha_phase=alpha_phase, fc_max=p["fc_max"],
                 feats_f16=feats_enc, pack=(p["fc_max"] == 0)))
        if nm is None:
            p["nm_dev"] = n_marks
            p["nm"] = None
        del p["dev"]
        return p

    def download(p):
        """Download thread: pull the packed features (downstream leg).

        Speculative schedule: first fetch the (B,) mark counts and trim
        the m_max-padded outputs ON DEVICE to the realised bucket, so
        the big transfer still moves only realised frames (bitwise equal
        to the synced schedule's — per-frame ops don't depend on the
        padded frame count; gated in tests/test_analysis_batch.py)."""
        if p["nm"] is None:
            nm = np.asarray(jax.device_get(p.pop("nm_dev")))
            p["nm"] = nm
            Fa = min(p["m_max"], bucket_frames(int(nm.max())))
            if Fa < p["m_max"]:
                if p["fc_max"] == 0:
                    if len(p["out"]) == 4:      # int8 transfer encoding
                        q, szp, aux, nv = p["out"]
                        q, aux = _trim_frames((q, aux), n=Fa)
                        p["out"] = (q, szp, aux, nv)
                    elif len(p["out"]) == 2:    # f16, aux bitcast-packed
                        feats, nv = p["out"]
                        (feats,) = _trim_frames((feats,), n=Fa)
                        p["out"] = (feats, nv)
                    else:
                        feats, aux, nv = p["out"]
                        feats, aux = _trim_frames((feats, aux), n=Fa)
                        p["out"] = (feats, aux, nv)
                else:
                    mml, mrm, mim, lf0, shift, nv = p["out"]
                    (shift,) = _trim_frames((shift,), n=Fa)
                    p["out"] = (mml, mrm, mim, lf0, shift, nv)
        nm, n_real = p["nm"], p["n_real"]
        out = []
        if p["fc_max"] == 0:
            if len(p["out"]) == 4:            # int8 transfer encoding
                q, scale_zp, aux = jax.device_get(p["out"][:3])
                for b in range(n_real):
                    n = int(nm[b])
                    f = (q[b, :n].astype(np.float64) * scale_zp[b, 0]
                         + scale_zp[b, 1])
                    out.append((f[:, :mag_dim],
                                f[:, mag_dim:mag_dim + phase_dim],
                                f[:, mag_dim + phase_dim:],
                                aux[b, :n, 0].astype(np.float64),
                                aux[b, :n, 1].astype(np.int64)))
                feats = None
            elif len(p["out"]) == 2:      # f16, aux bitcast-packed
                D = mag_dim + 2 * phase_dim
                packed = np.asarray(jax.device_get(p["out"][0]))
                # u16 wire tensor: first D channels are the f16 mel
                # streams' bits, last 4 the f32 (lf0, shift) pair —
                # reinterpret the bytes back on the host
                feats = np.ascontiguousarray(
                    packed[:, :, :D]).view(np.float16)
                aux = np.ascontiguousarray(
                    packed[:, :, D:D + 4]).view(np.float32)
                for b in range(n_real):
                    n = int(nm[b])
                    f = feats[b, :n, :D].astype(np.float64)
                    out.append((f[:, :mag_dim],
                                f[:, mag_dim:mag_dim + phase_dim],
                                f[:, mag_dim + phase_dim:],
                                aux[b, :n, 0].astype(np.float64),
                                aux[b, :n, 1].astype(np.int64)))
            else:
                feats, aux, _ = p["out"]
                feats, aux = jax.device_get((feats, aux))
                for b in range(n_real):
                    n = int(nm[b])
                    f = feats[b, :n].astype(np.float64)
                    out.append((f[:, :mag_dim],
                                f[:, mag_dim:mag_dim + phase_dim],
                                f[:, mag_dim + phase_dim:],
                                aux[b, :n, 0].astype(np.float64),
                                aux[b, :n, 1].astype(np.int64)))
        else:
            mml, mrm, mim, lf0, shift, n_valid = p["out"]
            nv = np.asarray(jax.device_get(n_valid))
            Fv = bucket_frames(int(nv.max()))
            a, b_, c, d = jax.device_get(_trim_frames(
                (mml, mrm, mim, lf0), n=Fv))
            sh = jax.device_get(shift)
            for b in range(n_real):
                n = int(nv[b])
                out.append((a[b, :n].astype(np.float64),
                            b_[b, :n].astype(np.float64),
                            c[b, :n].astype(np.float64),
                            d[b, :n].astype(np.float64),
                            sh[b, :int(nm[b])].astype(np.int64)))

        # capacity-exhausted walks (pathological mark density): redo
        # those with the exact host walk + given-epochs path
        trunc = [b for b in range(n_real) if int(nm[b]) >= p["m_max"]]
        if trunc:
            from ..epochs.tracker import extract_epochs
            from ..utils.metrics import logger
            logger.warning("epoch-walk capacity hit for %d "
                           "utterance(s); host-walk fallback", len(trunc))
            sigs_g = p["signals"]
            eps = [extract_epochs(sigs_g[b], fs) for b in trunc]
            fixed = analysis_compressed_batch(
                [sigs_g[b] for b in trunc], fs, mag_dim=mag_dim,
                phase_dim=phase_dim, fft_len=fft_len,
                alpha_phase=alpha_phase, b_const_rate=b_const_rate,
                epochs=eps)
            for j, b in enumerate(trunc):
                out[b] = fixed[j]
        return out

    from ..utils.pipeline import run_staged
    groups = _split_for_budget(signals, fs, fft_len, mesh)
    pipe = run_staged(map(prep, groups), [upload, compute, download])

    def finalize():
        out = []
        for chunk in pipe:
            out.extend(chunk)
        return out

    return finalize
