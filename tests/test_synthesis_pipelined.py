"""Pipelined corpus synthesis driver == the blocking batch entry,
waveform-for-waveform (same per-utterance keys)."""
import os

import jax
import numpy as np

from magphase_jax.io import read_binfile
from magphase_jax.parallel.batch import (synthesis_batches_pipelined,
                                         synthesis_from_compressed_batch)

PRED_DIR = "/root/reference/demos/data_48k/params_predicted"
TOKENS = ["hvd_704", "hvd_705", "hvd_706", "hvd_708"]
FS = 48000


def _utts(n):
    utts = []
    for i in range(n):
        t = TOKENS[i % len(TOKENS)]
        utts.append((read_binfile(os.path.join(PRED_DIR, t + ".mag"), 60),
                     read_binfile(os.path.join(PRED_DIR, t + ".real"), 45),
                     read_binfile(os.path.join(PRED_DIR, t + ".imag"), 45),
                     read_binfile(os.path.join(PRED_DIR, t + ".lf0"), 1)))
    return utts


def test_pipelined_matches_blocking_batch():
    utts = _utts(6)
    key = jax.random.PRNGKey(11)
    keys = np.asarray(jax.random.split(key, len(utts)), np.uint32)

    # det_fft_syn on BOTH sides: the pipelined driver defaults to the
    # batch-composition-independent FFT, and parity with the blocking
    # entry is only guaranteed under a matching choice
    ref = synthesis_from_compressed_batch(utts, FS, key=key,
                                          det_fft_syn=True)

    got = []
    for group in synthesis_batches_pipelined(
            iter([(utts[:3], keys[:3]), (utts[3:], keys[3:])]), FS):
        got.extend(group)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_pipelined_pcm16_consume():
    """consume() runs on the download thread and sees the device PCM16
    rows; matches the blocking pcm16 path exactly."""
    utts = _utts(3)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), 3),
                      np.uint32)
    bufs_ref, lens_ref = synthesis_from_compressed_batch(
        utts, FS, key=jax.random.PRNGKey(0), block_result=False,
        pcm16=True, det_fft_syn=True)
    rows_ref = np.asarray(jax.device_get(bufs_ref))

    got = []

    def consume(bufs, host):
        rows = np.asarray(jax.device_get(bufs))
        return [(rows[i, :host["out_lens"][i]], host["out_lens"][i])
                for i in range(host["n_real"])]

    for group in synthesis_batches_pipelined(
            iter([(utts, keys)]), FS, pcm16=True, consume=consume):
        got.extend(group)
    assert len(got) == 3
    for i, (row, n) in enumerate(got):
        assert n == lens_ref[i]
        np.testing.assert_array_equal(row, rows_ref[i, :n])
        assert row.dtype == np.int16
