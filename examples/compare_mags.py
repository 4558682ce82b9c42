#!/usr/bin/env python
"""Compare two magnitude feature files (reference:
development/compare_mags.py — a manual, hard-coded-paths plotting script;
here a proper CLI producing difference statistics and optional heatmaps).

Usage:
  python examples/compare_mags.py ref.mag cand.mag --dim 60 [--log]
      [--plot-dir out/]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from magphase_jax.io import read_binfile
from magphase_jax.utils.eval import log_spectral_distortion_feats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref")
    ap.add_argument("cand")
    ap.add_argument("--dim", type=int, default=60)
    ap.add_argument("--log", action="store_true",
                    help="inputs are already log-domain")
    ap.add_argument("--plot-dir", default=None)
    args = ap.parse_args(argv)

    a = np.atleast_2d(read_binfile(args.ref, dim=args.dim))
    b = np.atleast_2d(read_binfile(args.cand, dim=args.dim))
    n = min(len(a), len(b))
    if len(a) != len(b):
        print(f"frame count differs: {len(a)} vs {len(b)}; comparing {n}")
    la_, lb = (a[:n], b[:n]) if args.log else \
        (np.log(np.maximum(a[:n], 1e-10)), np.log(np.maximum(b[:n], 1e-10)))

    d_db = 20.0 / np.log(10.0) * (la_ - lb)
    print(f"frames={n} dim={a.shape[1]}")
    print(f"mean |diff|  : {np.mean(np.abs(d_db)):8.3f} dB")
    print(f"max  |diff|  : {np.max(np.abs(d_db)):8.3f} dB")
    print(f"per-frame RMS: {np.mean(np.sqrt(np.mean(d_db**2, 1))):8.3f} dB")
    print(f"MSD (MCD-style): {log_spectral_distortion_feats(la_, lb):8.3f} dB")

    if args.plot_dir:
        from magphase_jax.utils.plotting import plotm
        os.makedirs(args.plot_dir, exist_ok=True)
        plotm(la_, out_file=os.path.join(args.plot_dir, "ref.png"))
        plotm(lb, out_file=os.path.join(args.plot_dir, "cand.png"))
        plotm(d_db, out_file=os.path.join(args.plot_dir, "diff_db.png"))
        print("plots ->", args.plot_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
