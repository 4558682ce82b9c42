#!/usr/bin/env python
"""End-to-end copy-synthesis experiment over a corpus (reference:
development/run_merlin_experiment.py — a Merlin training driver; Merlin
itself is external, so the self-contained equivalent here exercises the
same framework surface: corpus feature extraction -> waveform generation
-> objective metric (mel-spectral distortion, standing in for CALMCD)).

Usage:
  python examples/run_experiment.py [--data-dir DIR] [--out-dir DIR]
      [--mag-dim 60] [--phase-dim 45] [--limit N]

--data-dir holds file_id.scp and wavs_nat/ (the reference's demo
layout); without it a 10-utterance 48 kHz corpus is generated
(utils/stimuli.py).
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(__file__), "..", ".smoke", "experiment"))
    ap.add_argument("--mag-dim", type=int, default=60)
    ap.add_argument("--phase-dim", type=int, default=45)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    from magphase_jax.io import (read_scp_file, read_wav, write_audio_file,
                                 mkdir)
    from magphase_jax.parallel.analysis_batch import analysis_compressed_batch
    from magphase_jax.parallel.batch import synthesis_from_compressed_batch
    from magphase_jax.utils.eval import mel_spectral_distortion_piecewise
    from magphase_jax.utils.metrics import Metrics, setup_logging

    setup_logging()
    met = Metrics()
    if args.data_dir is None:
        from magphase_jax.utils.stimuli import make_corpus, write_corpus
        args.data_dir = os.path.join(args.out_dir, "data")
        write_corpus(make_corpus(10, 48000, seed=0, min_s=1.5, max_s=4.0),
                     os.path.join(args.data_dir, "wavs_nat"),
                     os.path.join(args.data_dir, "file_id.scp"))
    tokens = read_scp_file(os.path.join(args.data_dir, "file_id.scp"))
    if args.limit:
        tokens = tokens[:args.limit]
    mkdir(args.out_dir)

    sigs, fss = [], set()
    for tok in tokens:
        sig, fs = read_wav(os.path.join(args.data_dir, "wavs_nat",
                                        tok + ".wav"))
        sigs.append(sig)
        fss.add(fs)
    (fs,) = fss
    audio_s = sum(len(s) for s in sigs) / fs
    print(f"{len(tokens)} utterances, {audio_s:.1f} audio-s @ {fs} Hz")

    with met.stage("extract"):
        feats = analysis_compressed_batch(sigs, fs, mag_dim=args.mag_dim,
                                          phase_dim=args.phase_dim)
    print(f"extract: {audio_s / met.times['extract']:.1f} audio-s/s")

    with met.stage("generate"):
        utts = [(m, r, i, l) for (m, r, i, l, _s) in feats]
        wavs = synthesis_from_compressed_batch(utts, fs,
                                               key=jax.random.PRNGKey(0))
    print(f"generate: {audio_s / met.times['generate']:.1f} audio-s/s")

    msds = []
    for tok, sig, w in zip(tokens, sigs, wavs):
        write_audio_file(os.path.join(args.out_dir, tok + ".wav"), w, fs)
        # gating convention (tests/test_corpus_quality.py): floor 40 dB
        # below peak — without it, digital silence in the natural
        # recording vs the vocoder's noise floor dominates the mean with
        # content-free distortion (+~18 dB of pure metric artifact)
        msds.append(mel_spectral_distortion_piecewise(
            sig, np.asarray(w), fs, floor_db=40.0))
    print(f"copy-synthesis piecewise MSD (floor 40 dB): "
          f"mean {np.mean(msds):.2f} dB  "
          f"(per-utt {' '.join('%.2f' % m for m in msds)})")
    print("wavs ->", args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
