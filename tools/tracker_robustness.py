#!/usr/bin/env python
"""Tracker robustness A/B: NCCF pre-whitening modes under degradation.

Sweeps MAGPHASE_TRACKER_WHITEN modes over the ground-truth stimulus set
(tests/test_tracker_groundtruth.py) x degradation conditions and prints
the worst-case metrics per (mode, condition) — the measurement behind
the two-phase epoch snap (reverb GPE 8.5% -> target <= 4%).

Usage: python tools/tracker_robustness.py [mode ...]
"""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from magphase_jax.epochs import extract_epochs  # noqa: E402
from magphase_jax.utils.tracker_eval import (degrade_stimulus,  # noqa: E402
                                             make_stimulus, tracker_metrics)

FS = 48000
CASES = {
    "steady120": [(0.3, 120, 120)],
    "rise90_180": [(0.4, 90, 180)],
    "fall300_150": [(0.4, 300, 150)],
    "high350": [(0.3, 350, 350)],
    "low60": [(0.4, 60, 60)],
    "low_male_55_85": [(0.5, 55, 85)],
    "mixed": [(0.2, None, None), (0.3, 140, 200), (0.15, None, None),
              (0.3, 220, 110), (0.1, None, None)],
}
CONDS = {
    "clean": {},
    "snr20": dict(snr_db=20),
    "snr10": dict(snr_db=10),
    "reverb200ms": dict(rt60_s=0.2),
    "snr20_reverb": dict(snr_db=20, rt60_s=0.15),
    "snr10_reverb": dict(snr_db=10, rt60_s=0.2),
}


def run_mode(mode: str):
    os.environ["MAGPHASE_TRACKER_WHITEN"] = mode
    worst = {}
    for cond, dkw in CONDS.items():
        agg = dict(gpe=0.0, voi_miss=0.0, voi_fa=0.0, gci_hit=1.0,
                   gci_jitter=0.0)
        for name, segs in CASES.items():
            sig, gci, ivals, f0_at = make_stimulus(FS, segs, seed=1)
            if dkw:
                sig = degrade_stimulus(sig, FS, seed=7, **dkw)
            pm, voi = extract_epochs(sig, FS)
            m = tracker_metrics(pm, voi, gci, ivals, f0_at, len(sig) / FS)
            agg["gpe"] = max(agg["gpe"], m["gpe"])
            agg["voi_miss"] = max(agg["voi_miss"], m["voi_miss"])
            agg["voi_fa"] = max(agg["voi_fa"], m["voi_fa"])
            agg["gci_hit"] = min(agg["gci_hit"], m["gci_hit"])
            agg["gci_jitter"] = max(agg["gci_jitter"], m["gci_jitter"])
        worst[cond] = {k: round(float(v), 4) for k, v in agg.items()}
    return worst


def main(modes):
    out = {}
    for mode in modes:
        out[mode] = run_mode(mode)
        print(f"== {mode}")
        for cond, m in out[mode].items():
            print(f"  {cond:14s} gpe {m['gpe']:.4f}  miss {m['voi_miss']:.4f}"
                  f"  fa {m['voi_fa']:.4f}  hit {m['gci_hit']:.4f}"
                  f"  jit {m['gci_jitter'] * 1e3:.2f} ms", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:] or ["none", "clip20", "clip30", "clip40", "cube"])
