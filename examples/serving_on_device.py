#!/usr/bin/env python
"""Serving integration: acoustic model -> vocoder fused in ONE device
program — the deployment shape of TTS serving.

The reference's serving story is file-based: Merlin writes predicted
.mag/.real/.imag/.lf0 to disk, then batch_waveform_generation.py reads
them back and vocodes (scripts/batch_waveform_generation.py:58-63).  On
an accelerator the acoustic model's outputs should never visit the
host: this example fuses a stand-in acoustic network (a small MLP over
linguistic features — swap in any flax/haiku model) with the full
compressed synthesis pipeline (mel-unwarp -> masks/noise -> iFFT ->
PSOLA) in one jit.  Only the linguistic features go up and the PCM16
waveform comes down.

Run:  python examples/serving_on_device.py            (GPU or CPU)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from magphase_jax.config import (define_alpha, define_crossfade_params)
from magphase_jax.vocoder.compressed import (
    _unwarp_kernel, get_num_full_mel_coeffs_from_num_phase_coeffs,
    synthesis_core_batch)

FS = 48000
FFT_SYN = 2048          # 50 Hz-floored deterministic synthesis FFT
MAG_DIM, PHASE_DIM = 60, 45
LING_DIM = 128          # stand-in linguistic feature width
F = 256                 # frames per utterance (padded)
B = 8                   # utterances per batch


def init_acoustic_params(key, hidden=256):
    """A stand-in acoustic model: 2-layer MLP emitting the four MagPhase
    streams per frame.  Replace with any jittable flax/haiku network."""
    k1, k2 = jax.random.split(key)
    out_dim = MAG_DIM + 2 * PHASE_DIM + 1
    return {
        "w1": jax.random.normal(k1, (LING_DIM, hidden)) * 0.05,
        "b1": jnp.zeros(hidden),
        "w2": jax.random.normal(k2, (hidden, out_dim)) * 0.05,
        "b2": jnp.zeros(out_dim),
    }


def acoustic_model(params, ling):
    h = jnp.tanh(ling @ params["w1"] + params["b1"])
    y = h @ params["w2"] + params["b2"]
    mag_mel_log = y[..., :MAG_DIM] - 3.0
    real_mel = jnp.clip(y[..., MAG_DIM:MAG_DIM + PHASE_DIM], -1, 1)
    imag_mel = jnp.clip(y[..., MAG_DIM + PHASE_DIM:-1], -1, 1)
    # stand-in prosody: smooth lf0 around 120 Hz, all voiced
    lf0 = jnp.log(120.0) + 0.1 * jnp.tanh(y[..., -1])
    return mag_mel_log, real_mel, imag_mel, lf0


def build_tts_step():
    """One fused device program: linguistic features -> waveform."""
    alpha = define_alpha(FS)
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(FS)[0], PHASE_DIM, alpha, FS)
    h = FFT_SYN // 2 + 1
    out_len_max = 1 << 18
    ns_len_max = 1 << 18

    @jax.jit
    def tts_step(params, ling, keys):
        mag_mel_log, real_mel, imag_mel, lf0 = acoustic_model(params, ling)
        Bx, Fx, _ = mag_mel_log.shape
        # frame geometry from predicted lf0, fully on device (the
        # host-float64 parity path is for file round-trips; serving
        # tolerates f32 shifts)
        f0 = jnp.exp(lf0)
        voi = (f0 > 1.0).astype(jnp.float32)
        shifts = jnp.floor(FS / jnp.where(f0 == 0.0, 200.0, f0)
                           ).astype(jnp.int32)
        pm = jnp.cumsum(shifts, axis=1)
        nfrms = jnp.full((Bx,), Fx, jnp.int32)
        ns_len = pm[:, -1] + (pm[:, -1] - pm[:, -2])

        m_mag, m_real, m_imag = _unwarp_kernel(
            mag_mel_log.reshape(Bx * Fx, MAG_DIM),
            real_mel.reshape(Bx * Fx, PHASE_DIM),
            imag_mel.reshape(Bx * Fx, PHASE_DIM),
            fft_len=FFT_SYN, mag_dim_ph=mag_dim_ph, alpha=alpha,
            alpha_phase=alpha)
        bufs = synthesis_core_batch(
            m_mag.reshape(Bx, Fx, h), m_real.reshape(Bx, Fx, h),
            m_imag.reshape(Bx, Fx, h), voi, pm, shifts, nfrms, ns_len,
            keys, fs=FS, fft_len=FFT_SYN, alpha=alpha, b_voi_ap_win=True,
            per_phase_type="magphase", out_len_max=out_len_max,
            ns_len_max=ns_len_max)
        # device-side PCM16 (only 2-byte samples cross the link)
        lens = ns_len + 1
        mask = jnp.arange(out_len_max)[None, :] < lens[:, None]
        x = jnp.where(mask, bufs, 0.0)
        peak = jnp.max(jnp.abs(x), axis=1, keepdims=True)
        x = x * jnp.where(peak > 0, 0.98 / jnp.maximum(peak, 1e-30), 1.0)
        pcm = jnp.clip(jnp.rint(x * 32768.0), -32768, 32767
                       ).astype(jnp.int16)
        return pcm, lens

    return tts_step


def main():
    key = jax.random.PRNGKey(0)
    params = init_acoustic_params(key)
    ling = jax.random.normal(jax.random.PRNGKey(1), (B, F, LING_DIM))
    keys = jax.random.split(jax.random.PRNGKey(2), B)

    tts_step = build_tts_step()
    pcm, lens = tts_step(params, ling, keys)        # compile + run
    pcm, lens = np.asarray(pcm), np.asarray(lens)
    audio_s = float(lens.sum()) / FS
    print(f"batch of {B}: {audio_s:.1f} s of audio, "
          f"pcm dtype {pcm.dtype}, finite: {np.all(np.isfinite(lens))}")

    t0 = time.perf_counter()
    pcm2, lens2 = tts_step(params, ling, keys)
    np.asarray(pcm2)                                 # force completion
    dt = time.perf_counter() - t0
    print(f"warm step: {dt*1e3:.1f} ms -> {audio_s/dt:.0f} audio-s/s "
          f"(acoustic model + vocoder + PCM16, one fused program)")

    out = os.path.join(os.path.dirname(__file__), "..", ".smoke",
                       "examples")
    os.makedirs(out, exist_ok=True)
    from magphase_jax.io.wav import write_wav_pcm16
    write_wav_pcm16(os.path.join(out, "serving_demo.wav"),
                    pcm[0, :int(lens[0])], FS)
    print(f"wrote {out}/serving_demo.wav")


if __name__ == "__main__":
    main()
