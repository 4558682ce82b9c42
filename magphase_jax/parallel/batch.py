"""Corpus-scale batched vocoding, sharded over the ``data`` mesh axis.

This replaces the reference's multiprocessing.Pool fan-out
(libutils.py:32-63, scripts/batch_waveform_generation.py:58): utterances are
padded into dense (B, frames, ...) tensors, every kernel is vmapped over the
batch axis, and the batch axis is sharded over devices — one jit, zero
cross-device communication inside the pipeline.

Performance notes: at batch 32 the device pipeline is far from saturated,
so throughput is bounded by host-side batch assembly and dispatch.  The
host path therefore avoids per-array np.pad (preallocated (B, F, d)
buffers with row assignment), packs the three feature streams into ONE
(B, F, mag+2*phase) tensor (one transfer), derives the shift/pitch-mark
geometry with vectorised numpy over the whole batch, and runs post-filter
+ mel-unwarp + synthesis + high-pass as a single fused jit (one dispatch
per batch).
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..core.filters import butter_highpass_sos, sosfilt
from ..utils.padding import (FRM_STEP, bucket, bucket_signal,
                             max_frame_elems)
from ..vocoder.compressed import (
    _unwarp_kernel, get_num_full_mel_coeffs_from_num_phase_coeffs,
    max_pitch_sync_framelen, synthesis_core_batch, synthesis_fft_len)
from ..vocoder.framerate import truncate_shifts
from ..vocoder.postfilter import post_filter, post_filter_merlin
from .mesh import (budget_batch_cap, capped_batch_step, shard_batch,
                   sharded_kernel)


def _fused_batch_impl(feats, voi, pm, shifts, nfrms, ns_len, keys,
                      q_scale=None, q_zp=None, *,
                      fs, fft_len, alpha, alpha_phase, mag_dim, phase_dim,
                      mag_dim_ph, b_voi_ap_win, per_phase_type,
                      out_len_max, ns_len_max, b_out_hpf, pf_type,
                      hpf_mode="blocked"):
    """One dispatch for the whole batch: [post-filter] -> mel-unwarp ->
    synthesis core -> [40 Hz high-pass]
    (magphase.py:825-997 + 3259-3268 batched).

    ``keys``: (B, 2) uint32 per-utterance noise keys.  Every operand is
    batch-leading so the impl runs unchanged under shard_map (B = the
    device-local batch there; see parallel/mesh.py:sharded_kernel).
    """
    B, F, _D = feats.shape
    h = fft_len // 2 + 1
    # features arrive float16 (halves the host-link upload bytes) or uint8
    # with per-(utterance, coefficient) affine params (quarters them, see
    # quantise_feats); all compute is float32
    feats = feats.astype(jnp.float32)
    if q_scale is not None:
        feats = feats * q_scale[:, None, :] + q_zp[:, None, :]
    mag_mel = feats[..., :mag_dim].reshape(B * F, mag_dim)
    real_mel = feats[..., mag_dim:mag_dim + phase_dim].reshape(B * F,
                                                              phase_dim)
    imag_mel = feats[..., mag_dim + phase_dim:].reshape(B * F, phase_dim)

    if pf_type == "magphase":
        mag_mel = post_filter(mag_mel, fs)
    elif pf_type == "merlin":
        mag_mel = post_filter_merlin(mag_mel, fs)

    m_mag, m_real, m_imag = _unwarp_kernel(
        mag_mel, real_mel, imag_mel, fft_len=fft_len,
        mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase)

    spectral_hpf = b_out_hpf and hpf_mode == "spectral"
    bufs = synthesis_core_batch(
        m_mag.reshape(B, F, h), m_real.reshape(B, F, h),
        m_imag.reshape(B, F, h), voi, pm, shifts, nfrms, ns_len, keys,
        fs=fs, fft_len=fft_len, alpha=alpha, b_voi_ap_win=b_voi_ap_win,
        per_phase_type=per_phase_type, out_len_max=out_len_max,
        ns_len_max=ns_len_max,
        out_hpf="spectral" if spectral_hpf else None)
    if b_out_hpf and not spectral_hpf:
        # 'blocked' (MAGPHASE_HPF_MODE=blocked, the reference-faithful
        # A/B form): FFT convolution on the OLA'd signal in
        # signal-length-independent sections, so each utterance's audio
        # is bitwise invariant to the batch's padded length (multi-host
        # merge == single-host, byte for byte).  The default 'spectral'
        # mode instead folds the filter into the frame spectra inside
        # the core — per-frame by construction, so equally
        # composition-independent, with no extra pass over the signal
        sos = butter_highpass_sos(4, 40.0, fs)
        bufs = jax.vmap(lambda x: sosfilt(sos, x, mode="blocked"))(bufs)
    return bufs


# single-device jit of the impl; the sharded path wraps the same impl in
# shard_map, so sharded == unsharded per utterance
_fused_batch_kernel = functools.partial(
    jax.jit,
    static_argnames=("fs", "fft_len", "alpha", "alpha_phase", "mag_dim",
                     "phase_dim", "mag_dim_ph", "b_voi_ap_win",
                     "per_phase_type", "out_len_max", "ns_len_max",
                     "b_out_hpf", "pf_type", "hpf_mode"))(_fused_batch_impl)


def quantise_feats(feats16: np.ndarray, nfrms: np.ndarray):
    """Per-(utterance, coefficient) affine uint8 quantisation of the
    packed (B, F, D) float16 feature tensor — the int8 transport encoding
    for the host link (halves the bytes again vs float16).

    The affine range is computed over each utterance's VALID rows only
    (padding rows dequantise to arbitrary in-range values; every consumer
    masks frames >= nfrms).  Max dequantisation error is scale/2 =
    range/510 per coefficient — for the clipped [-1, 1] phase streams
    that is <= 1/255, and for log-mag it is ~0.5% of the utterance's
    per-coefficient dynamic range; the measured effect on synthesis is
    far below the mel-compression error (tests/test_batch.py).
    Returns (q (B, F, D) uint8, scale (B, D) f32, zp (B, D) f32).
    """
    B, F, D = feats16.shape
    x = feats16.astype(np.float32)
    valid = np.arange(F)[None, :, None] < nfrms[:, None, None]
    big = np.float32(np.finfo(np.float32).max)
    lo = np.min(np.where(valid, x, big), axis=1)
    hi = np.max(np.where(valid, x, -big), axis=1)
    lo = np.minimum(lo, hi)                      # empty guard
    scale = (hi - lo) / 255.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint((x - lo[:, None, :]) / scale[:, None, :]),
                0, 255).astype(np.uint8)
    return q, scale, lo.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("norm",))
def _pcm16_kernel(bufs, lens, *, norm: float = 0.98):
    """Device-side peak-normalised PCM16 encode of (B, O) OLA buffers.

    Matches write_audio_file + write_wav exactly (io/wav.py:132-134,
    153-161): peak over the per-utterance valid length, scale to ``norm``,
    round-to-nearest, clip — so only 2-byte samples cross the host link
    and the host writes raw frames."""
    B, O = bufs.shape
    mask = jnp.arange(O)[None, :] < lens[:, None]
    x = jnp.where(mask, bufs, 0.0)
    peak = jnp.max(jnp.abs(x), axis=1, keepdims=True)
    x = x * jnp.where(peak > 0, norm / jnp.maximum(peak, 1e-30), 1.0)
    q = jnp.clip(jnp.rint(x * 32768.0), -32768, 32767)
    return q.astype(jnp.int16)


def _synthesis_geometry(utts, fs: int, fft_len: int, det_fft_syn: bool,
                        mesh):
    """(fft_syn, max_b) for one synthesis call — the ONE place the
    adaptive-FFT and HBM-budget arithmetic lives (the blocking entry,
    its budget-split recursion and the pipelined driver all share it).

    Adaptive mode: smallest power-of-2 containing every realised
    pitch-sync frame (vocoder.compressed.synthesis_fft_len) — also
    relaxes the HBM budget, so smaller FFTs admit larger sub-batches.

    ``det_fft_syn``: the FFT is FIXED from the 50 Hz worst case —
    independent of content, so every output sample is independent of
    which utterances share a batch (byte-identical multi-host merges).
    Frames of pathological f0 < 50 Hz (below the tracker's F0_MIN and
    the reference's REAPER floor, libaudio.py:453) get truncated to the
    fft length exactly as the reference truncates over-long frames
    (magphase.py:311-315); clamping — rather than flooring — is what
    keeps a sub-50 Hz utterance from silently changing its batchmates'
    audio."""
    if det_fft_syn:
        framelen_call = 2 * int(fs / 50.0) + 1
    else:
        framelen_call = max(
            max_pitch_sync_framelen(
                (fs / np.where(f0 == 0.0, 200.0, f0)).astype(np.int64))
            for f0 in (np.exp(np.atleast_1d(np.squeeze(np.asarray(
                u[3], np.float64)))) for u in utts))
    fft_syn = synthesis_fft_len(fft_len, framelen_call)

    # HBM budget: the kernel materialises (B, F, fft_syn) spectra — split
    # oversized batches (long utterances) into sequential sub-batches
    F_est = bucket(max(np.atleast_1d(np.squeeze(u[3])).shape[0]
                       for u in utts), FRM_STEP)
    budget = max_frame_elems() * (mesh.size if mesh is not None else 1)
    max_b = budget_batch_cap(mesh, max(1, int(budget // (F_est * fft_syn))))
    return fft_syn, max_b


def synthesis_from_compressed_batch(utts, fs: int,
                                    fft_len: int | None = None,
                                    b_voi_ap_win: bool = True,
                                    per_phase_type: str = "magphase",
                                    alpha_phase: float | None = None,
                                    b_out_hpf: bool = True,
                                    pf_type: str = "no",
                                    key=None, mesh=None,
                                    block_result: bool = True,
                                    pcm16: bool = False,
                                    transport: str = "f16",
                                    keys=None,
                                    det_fft_syn: bool = False):
    """Batch synthesis from compressed features.

    utts: list of (m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0) numpy
    tuples.  Returns list of float64 waveforms (or device buffers + lengths
    when ``block_result`` is False, for benchmarking).

    ``pcm16`` (requires ``block_result=False``): buffers are
    peak-normalised and quantised to int16 ON DEVICE (see _pcm16_kernel),
    halving the dominant waveform download of corpus generation; write
    rows with io.wav.write_wav_pcm16.

    ``transport``: host-link encoding of the packed feature tensor —
    "f16" (default) or "int8" (per-utterance-per-coefficient affine,
    see quantise_feats; halves the upload again, for transfer-bound
    serving links).  Compute is float32 on device either way.

    ``keys``: explicit (len(utts), 2) uint32 per-utterance noise keys,
    overriding the derivation from ``key``.  Corpus drivers pass keys
    derived from the GLOBAL utterance index of the full scp so each
    utterance's audio is invariant to chunking and multi-host
    partitioning (cli.py:cmd_generate).

    ``det_fft_syn``: floor the adaptive synthesis-FFT choice at the
    50 Hz worst case so the chosen FFT does not depend on which
    utterances share a batch — combined with global-index keys and the
    'blocked' high-pass this makes every output sample independent of
    batch composition (byte-identical multi-host merges).
    """
    if pcm16 and block_result:
        # validate BEFORE any device work (and independent of python -O):
        # int16 PCM rows must not be handed back as float64 "waveforms"
        raise ValueError("pcm16=True is a device transfer encoding; use "
                         "block_result=False and write the int16 rows "
                         "with io.wav.write_wav_pcm16")
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    if key is None:
        key = jax.random.PRNGKey(0)
    if keys is None:
        # per-utterance noise keys, derived ONCE from the root key by
        # global utterance index.  jax.random.split is prefix-stable
        # (split(k, m)[i] == split(k, n)[i] for i < min(m, n), asserted in
        # tests), so utterance i's audio is identical whether the call
        # buckets, shards, or budget-splits the batch in any way.
        keys = np.asarray(jax.random.split(key, len(utts)), np.uint32)

    mag_dim = np.atleast_2d(utts[0][0]).shape[1]
    phase_dim = np.atleast_2d(utts[0][1]).shape[1]
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)

    fft_syn, max_b = _synthesis_geometry(utts, fs, fft_len, det_fft_syn,
                                         mesh)
    if len(utts) > max_b:
        out, rows, lens_all = [], [], []
        for i in range(0, len(utts), max_b):
            r = synthesis_from_compressed_batch(
                utts[i:i + max_b], fs, fft_len=fft_len,
                b_voi_ap_win=b_voi_ap_win, per_phase_type=per_phase_type,
                alpha_phase=alpha_phase, b_out_hpf=b_out_hpf,
                pf_type=pf_type, key=key, mesh=mesh,
                block_result=block_result, pcm16=pcm16,
                transport=transport, keys=keys[i:i + max_b],
                det_fft_syn=det_fft_syn)
            if block_result:
                out.extend(r)
            else:
                bufs_g, lens_g = r
                rows.extend(bufs_g[j] for j in range(len(lens_g)))
                lens_all.extend(lens_g)
        return out if block_result else (rows, lens_all)

    host = _prepare_synthesis_group(
        utts, n_real=len(utts), keys=np.asarray(keys, np.uint32),
        mesh=mesh, max_b=max_b, fs=fs,
        fft_syn=fft_syn, alpha=alpha, alpha_phase=alpha_phase,
        mag_dim=mag_dim, phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
        b_voi_ap_win=b_voi_ap_win, per_phase_type=per_phase_type,
        b_out_hpf=b_out_hpf, pf_type=pf_type, transport=transport)
    dev = _upload_synthesis_group(host, mesh)
    bufs = _execute_synthesis_group(dev, mesh, pcm16=pcm16)
    out_lens = host["out_lens"]
    n_real = host["n_real"]
    if not block_result:
        return bufs, out_lens[:n_real]
    bufs = jax.device_get(bufs)
    return [np.asarray(bufs[i][:out_lens[i]], np.float64)
            for i in range(n_real)]


def _prepare_synthesis_group(utts, *, n_real, keys, mesh, max_b, fs,
                             fft_syn, alpha, alpha_phase, mag_dim,
                             phase_dim, mag_dim_ph, b_voi_ap_win,
                             per_phase_type, b_out_hpf, pf_type,
                             transport):
    """Host half of one synthesis group: batch-axis bucketing, feature
    packing, vectorised framing geometry, transport encoding.  Pure
    numpy — safe on a feeder thread; no device traffic."""
    # bucket the batch axis so arbitrary corpus-tail batch sizes reuse the
    # same compiled program (dummy 2-frame unvoiced utterances, dropped on
    # return)
    B = bucket(n_real, capped_batch_step(mesh, max_b))
    if B > n_real:
        dummy = (np.full((2, mag_dim), -3.0, np.float32),
                 np.zeros((2, phase_dim), np.float32),
                 np.zeros((2, phase_dim), np.float32),
                 np.full(2, -1.0e10))
        utts = list(utts) + [dummy] * (B - n_real)

    nfrms = np.asarray([np.atleast_1d(np.squeeze(u[3])).shape[0]
                        for u in utts], np.int64)
    F = bucket(int(nfrms.max()), FRM_STEP)
    D = mag_dim + 2 * phase_dim

    # one preallocated feature tensor + MAGIC-padded lf0 (no per-array
    # pad).  float16: halves the dominant upload over the host link; the
    # kernel computes in float32 (same quantisation as the single path)
    feats = np.zeros((B, F, D), np.float16)
    lf0_b = np.full((B, F), -1.0e10)
    for b, (mag, real, imag, lf0) in enumerate(utts):
        n = nfrms[b]
        feats[b, :n, :mag_dim] = np.atleast_2d(mag)
        feats[b, :n, mag_dim:mag_dim + phase_dim] = np.atleast_2d(real)
        feats[b, :n, mag_dim + phase_dim:] = np.atleast_2d(imag)
        lf0_b[b, :n] = np.squeeze(np.asarray(lf0, np.float64))

    # vectorised framing math (float64 parity with f0_to_shift_np:
    # f0==0 -> 200 Hz i.e. the 5 ms unvoiced rate, magphase.py:2210-2215)
    v_f0 = np.exp(lf0_b)
    voi_b = v_f0 > 1.0
    shifts_b = truncate_shifts(fs / np.where(v_f0 == 0.0, 200.0, v_f0))
    pm_b = np.cumsum(shifts_b, axis=1)
    rows = np.arange(B)
    last = pm_b[rows, nfrms - 1]
    prev = pm_b[rows, np.maximum(nfrms - 2, 0)]
    ns_lens = last + (last - prev)
    out_lens = (ns_lens + 1).tolist()
    O = bucket_signal(int(max(out_lens)))
    NS = bucket_signal(int(ns_lens.max()))

    if transport == "int8":
        feats_t, q_scale, q_zp = quantise_feats(feats, nfrms)
        extra = (q_scale, q_zp)
    elif transport == "f16":
        feats_t, extra = feats, (None, None)
    else:
        raise ValueError(f"unknown transport {transport!r}")
    args = (feats_t, voi_b.astype(np.float32), pm_b.astype(np.int32),
            shifts_b.astype(np.int32), nfrms.astype(np.int32),
            ns_lens.astype(np.int32))
    static_kw = dict(fs=fs, fft_len=fft_syn, alpha=alpha,
                     alpha_phase=alpha_phase, mag_dim=mag_dim,
                     phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
                     b_voi_ap_win=b_voi_ap_win,
                     per_phase_type=per_phase_type, out_len_max=O,
                     ns_len_max=NS, b_out_hpf=b_out_hpf, pf_type=pf_type,
                     hpf_mode=os.environ.get("MAGPHASE_HPF_MODE",
                                             "spectral"))
    keys_b = np.zeros((B, 2), np.uint32)
    keys_b[:n_real] = keys[:n_real]         # dummy rows: outputs dropped
    return dict(args=args, extra=extra, keys=keys_b, static_kw=static_kw,
                out_lens=out_lens, n_real=n_real)


def synthesis_batches_pipelined(batches, fs: int,
                                fft_len: int | None = None,
                                b_voi_ap_win: bool = True,
                                per_phase_type: str = "magphase",
                                alpha_phase: float | None = None,
                                b_out_hpf: bool = True,
                                pf_type: str = "no",
                                mesh=None, pcm16: bool = False,
                                transport: str = "f16",
                                consume=None,
                                det_fft_syn: bool = True):
    """Threaded four-stage corpus synthesis: prepare -> upload -> execute
    -> download, one thread per stage (utils/pipeline.py:run_staged).

    ``det_fft_syn`` defaults to True HERE (unlike the blocking entry):
    this driver computes the adaptive synthesis-FFT geometry per
    caller-supplied batch, so with an adaptive FFT the output would
    depend on how the caller chunks batches.  Waveform parity with
    synthesis_from_compressed_batch is guaranteed only when both sides
    use the same det_fft_syn (or the content happens to land in the
    same FFT bucket).

    ``batches``: iterable of (utts, keys[, tag]) with utts as in
    synthesis_from_compressed_batch, keys a (len(utts), 2) uint32
    per-utterance key array, and ``tag`` an opaque value handed back as
    ``host['tag'] = (tag, first_utt_index)`` for corpus attribution.
    Yields one result per device GROUP (a batch
    may split into several groups under the device-memory budget), in order:
    ``consume(bufs, host_meta)`` if given (runs on the download thread —
    device_get + wav-write there overlaps the next group's compute), else
    the float64 waveform list.

    Why threads: a serial loop pays feature read + upload + compute +
    download + wav write as a SUM; on stage threads they overlap, making
    steady-state cost the slowest leg.  This is the schedule behind
    `cli generate`."""
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha

    def gen_groups():
        for batch in batches:
            utts, keys = batch[0], batch[1]
            tag = batch[2] if len(batch) > 2 else None
            keys = np.asarray(keys, np.uint32).reshape(len(utts), 2)
            mag_dim = np.atleast_2d(utts[0][0]).shape[1]
            phase_dim = np.atleast_2d(utts[0][1]).shape[1]
            mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
                define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)
            fft_syn, max_b = _synthesis_geometry(utts, fs, fft_len,
                                                 det_fft_syn, mesh)
            for i in range(0, len(utts), max_b):
                host = _prepare_synthesis_group(
                    utts[i:i + max_b], n_real=len(utts[i:i + max_b]),
                    keys=keys[i:i + max_b], mesh=mesh, max_b=max_b,
                    fs=fs, fft_syn=fft_syn, alpha=alpha,
                    alpha_phase=alpha_phase, mag_dim=mag_dim,
                    phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
                    b_voi_ap_win=b_voi_ap_win,
                    per_phase_type=per_phase_type, b_out_hpf=b_out_hpf,
                    pf_type=pf_type, transport=transport)
                # batch attribution for corpus consumers: (caller's tag,
                # index of this group's first utterance within the batch)
                host["tag"] = (tag, i)
                yield host

    def upload(host):
        return _upload_synthesis_group(host, mesh)

    def execute(dev):
        bufs = _execute_synthesis_group(dev, mesh, pcm16=pcm16)
        return bufs, dev["host"]

    def download(x):
        bufs, host = x
        if consume is not None:
            return consume(bufs, host)
        arr = jax.device_get(bufs)
        return [np.asarray(arr[i][:host["out_lens"][i]], np.float64)
                for i in range(host["n_real"])]

    from ..utils.pipeline import run_staged
    yield from run_staged(gen_groups(), [upload, execute, download])


def _upload_synthesis_group(host: dict, mesh):
    """Device half 1: push the group's operands (the upstream link leg).

    Blocks until EVERY operand lands so the upload is paid on the
    pipeline's upload thread, not inside the compute dispatch
    (device_put is fire-and-forget even in per-dispatch-sync mode).
    The feature tensor goes up as per-chunk-blocking slices
    (utils/transfer.py): a device_get issued behind a monolithic
    in-flight put waits for the WHOLE put, so one big upload stalls the
    download thread for a full group — chunking bounds the stall at one
    chunk."""
    if mesh is not None:
        args = tuple(jnp.asarray(a) for a in host["args"])
        keys_d = jnp.asarray(host["keys"])
        extra = tuple(None if e is None else jnp.asarray(e)
                      for e in host["extra"])
        sm_args = args + (keys_d,)
        if extra[0] is not None:
            sm_args = sm_args + extra
        sm_args = shard_batch(mesh, *sm_args)
        jax.block_until_ready(sm_args[0])
        return dict(sm_args=sm_args, host=host)
    from ..utils.transfer import device_put_chunked
    # queue the small operands FIRST (fire-and-forget): they ride the
    # stream ahead of/with the big blocking feats chunks, so the final
    # block costs no extra round trip
    rest = tuple(jnp.asarray(a) for a in host["args"][1:])
    keys_d = jnp.asarray(host["keys"])
    extra = tuple(None if e is None else jnp.asarray(e)
                  for e in host["extra"])
    feats_d = device_put_chunked(host["args"][0])
    jax.block_until_ready(rest + (keys_d,)
                          + tuple(e for e in extra if e is not None))
    return dict(args=(feats_d,) + rest, keys=keys_d, extra=extra,
                host=host)


def _execute_synthesis_group(dev: dict, mesh, *, pcm16: bool):
    """Device half 2: dispatch the fused kernel (+ device PCM16 encode)."""
    host = dev["host"]
    static_kw = host["static_kw"]
    if mesh is not None:
        # shard_map over the data mesh with every operand (incl. the
        # per-utterance keys) sharded on the batch axis —
        # communication-free by construction (see mesh.sharded_kernel)
        bufs = sharded_kernel(_fused_batch_impl, mesh,
                              len(dev["sm_args"]), static_kw)(
                                  *dev["sm_args"])
    else:
        bufs = _fused_batch_kernel(*dev["args"], dev["keys"],
                                   *dev["extra"], **static_kw)
    if pcm16:
        bufs = _pcm16_kernel(bufs, jnp.asarray(np.asarray(
            host["out_lens"], np.int32)))
    return bufs
