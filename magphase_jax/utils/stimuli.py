"""A seeded speech-like corpus with known epochs, for tests, the smoke
run and the bench.

Each utterance alternates unvoiced (filtered noise) and voiced
(pulse-train-excited formant) segments built by
``tracker_eval.make_stimulus``, so its glottal closure instants, voicing
intervals and f0 contour are known exactly.  Nothing is downloaded: the
same seed gives the same corpus on every machine.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .tracker_eval import make_stimulus


@dataclass
class Utterance:
    token: str
    sig: np.ndarray          # float64 in [-0.5, 0.5]
    fs: int
    gci: np.ndarray          # true glottal closure instants (s)
    intervals: list          # voiced (start_s, end_s) intervals
    f0_at: object            # t (s) -> true f0 inside voiced intervals

    @property
    def duration(self) -> float:
        return len(self.sig) / self.fs


def random_segments(rng: np.random.RandomState, dur_s: float) -> list:
    """(duration_s, f0_start, f0_end) segments summing to ``dur_s``:
    unvoiced lead-in, then voiced runs (0.3-1.2 s, f0 glides within
    80-300 Hz) separated by unvoiced gaps (0.15-0.4 s)."""
    segs, t, voiced = [], 0.0, False
    while t < dur_s - 1e-9:
        if voiced:
            d = rng.uniform(0.3, 1.2)
            f0s, f0e = rng.uniform(80.0, 300.0, size=2)
            seg = (d, float(f0s), float(f0e))
        else:
            d = rng.uniform(0.15, 0.4)
            seg = (d, None, None)
        d = min(d, dur_s - t)
        segs.append((d,) + seg[1:])
        t += d
        voiced = not voiced
    return segs


def make_corpus(n: int, fs: int, seed: int = 0, min_s: float = 1.5,
                max_s: float = 8.0) -> list:
    """``n`` utterances with lengths drawn uniformly from [min_s, max_s]."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        segs = random_segments(rng, rng.uniform(min_s, max_s))
        sig, gci, ivals, f0_at = make_stimulus(fs, segs,
                                               seed=seed * 100003 + i)
        out.append(Utterance(f"utt{i:04d}", sig, fs, gci, ivals, f0_at))
    return out


def write_corpus(corpus: list, wav_dir: str, scp_path: str) -> None:
    """PCM16 wav files plus the scp token list the CLI reads."""
    from ..io.wav import write_wav

    os.makedirs(wav_dir, exist_ok=True)
    for u in corpus:
        write_wav(os.path.join(wav_dir, u.token + ".wav"), u.sig, u.fs)
    with open(scp_path, "w") as f:
        f.write("".join(u.token + "\n" for u in corpus))


def demo_wav(out_dir: str, fs: int = 48000, seed: int = 0,
             dur_s: float = 2.5) -> str:
    """Write one generated utterance as ``<out_dir>/demo.wav``; returns
    its path (the examples' stand-in for a recorded wav)."""
    u = make_corpus(1, fs, seed=seed, min_s=dur_s, max_s=dur_s)[0]
    u.token = "demo"
    write_corpus([u], out_dir, os.path.join(out_dir, "demo.scp"))
    return os.path.join(out_dir, "demo.wav")
