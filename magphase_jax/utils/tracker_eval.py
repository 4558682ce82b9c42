"""Ground-truth evaluation for the epoch tracker (REAPER replacement).

The reference's tracker is an external binary (libaudio.py:450-455) whose
quality was never measured in-repo; ours is a DP tracker whose costs were
tuned on the demo corpus.  This module provides *independent* ground truth:

* ``make_stimulus`` builds pulse-train-excited formant speech with EXACT
  known glottal-closure instants, f0 contours and voicing intervals;
* standard tracker metrics against that truth: gross pitch error (GPE),
  voicing decision errors (false alarm / miss), and GCI identification
  (hit rate within +-0.25 T0 after constant-offset removal, placement
  jitter).

tests/test_tracker_groundtruth.py asserts thresholds on these so a tracker
regression fails CI on data it was NOT tuned on.
"""
from __future__ import annotations

import numpy as np


def _allpole_formants(fs: int, formants=((500.0, 60.0), (1500.0, 90.0),
                                         (2500.0, 120.0))):
    """Cascade of 2-pole resonators (centre Hz, bandwidth Hz) -> (b, a)."""
    a = np.array([1.0])
    for fc, bw in formants:
        r = np.exp(-np.pi * bw / fs)
        theta = 2 * np.pi * fc / fs
        a = np.convolve(a, [1.0, -2 * r * np.cos(theta), r * r])
    return np.array([1.0]), a


def make_stimulus(fs: int, segments, seed: int = 0, noise_db: float = -40.0):
    """Pulse-train-excited formant synthesis with exact known epochs.

    ``segments``: list of (duration_s, f0_start, f0_end) — f0 None marks an
    unvoiced (filtered-noise) segment.  Voiced excitation is an impulse
    train whose impulse positions (the true GCIs) come from integrating
    the instantaneous f0.  Returns
    (sig, true_gci_sec, voiced_intervals, f0_at) where ``f0_at(t)`` gives
    the true f0 for any time inside a voiced interval.
    """
    from scipy import signal as sp_signal
    rng = np.random.RandomState(seed)
    b, a = _allpole_formants(fs)

    total = int(sum(d for d, *_ in segments) * fs)
    exc = np.zeros(total)
    gcis = []
    intervals = []
    seg_bounds = []
    t0 = 0.0
    for (dur, f0s, f0e) in segments:
        t1 = t0 + dur
        seg_bounds.append((t0, t1, f0s, f0e))
        if f0s is not None:
            intervals.append((t0, t1))
            # integrate instantaneous f0 (linear in time) for pulse times
            t = t0
            while t < t1:
                n = int(round(t * fs))
                if n < total:
                    exc[n] = 1.0
                    gcis.append(n / fs)
                frac = (t - t0) / dur
                f0 = f0s + (f0e - f0s) * frac
                t += 1.0 / f0
        else:
            n0, n1 = int(t0 * fs), min(int(t1 * fs), total)
            exc[n0:n1] = rng.randn(n1 - n0) * 0.02
        t0 = t1

    sig = sp_signal.lfilter(b, a, exc)
    sig = sig / np.max(np.abs(sig)) * 0.5
    sig += rng.randn(total) * (10 ** (noise_db / 20.0)) * 0.5

    def f0_at(t):
        t = np.asarray(t, np.float64)
        out = np.zeros_like(t)
        for (s0, s1, f0s, f0e) in seg_bounds:
            if f0s is None:
                continue
            m = (t >= s0) & (t < s1)
            frac = (t[m] - s0) / (s1 - s0)
            out[m] = f0s + (f0e - f0s) * frac
        return out

    return sig, np.asarray(gcis), intervals, f0_at


def degrade_stimulus(sig, fs: int, snr_db: float | None = None,
                     rt60_s: float | None = None, seed: int = 0):
    """Controlled degradations for tracker robustness gates (REAPER's
    operating envelope is wider than clean read speech).

    ``snr_db``: add white Gaussian noise at the given SNR versus the
    signal's own power.  ``rt60_s``: convolve with a synthetic
    exponentially-decaying noise room response (RT60 seconds, direct path
    preserved at unit gain) — the standard mild-reverb model.  Output is
    renormalised to the input's peak so absolute-threshold stages see the
    same scale."""
    rng = np.random.RandomState(seed)
    out = np.asarray(sig, np.float64).copy()
    if rt60_s is not None:
        n_ir = int(rt60_s * fs)
        t = np.arange(n_ir) / fs
        # -60 dB at t = rt60  =>  envelope exp(-6.9 t / rt60)
        ir = rng.randn(n_ir) * np.exp(-6.907755 * t / rt60_s)
        ir[0] = 0.0
        # early/late energy scaled to a modest direct-to-reverb ratio
        ir *= 0.35 / max(np.sqrt(np.sum(ir ** 2)), 1e-12)
        ir[0] = 1.0
        out = np.convolve(out, ir)[:len(out)]
    if snr_db is not None:
        p_sig = float(np.mean(out ** 2))
        p_n = p_sig / (10.0 ** (snr_db / 10.0))
        out = out + rng.randn(len(out)) * np.sqrt(p_n)
    peak = float(np.max(np.abs(out)))
    ref_peak = float(np.max(np.abs(sig)))
    if peak > 0:
        out *= ref_peak / peak
    return out


def _in_intervals(t, intervals, guard: float = 0.02):
    """Mask of times strictly inside intervals, ``guard`` s away from the
    boundaries (transition zones are scored by neither metric, standard
    practice for voicing evaluation)."""
    t = np.asarray(t)
    m = np.zeros(t.shape, bool)
    for (s0, s1) in intervals:
        m |= (t >= s0 + guard) & (t <= s1 - guard)
    return m


def _in_complement(t, intervals, total_dur, guard: float = 0.02):
    comp = []
    prev = 0.0
    for (s0, s1) in sorted(intervals):
        if s0 > prev:
            comp.append((prev, s0))
        prev = s1
    if prev < total_dur:
        comp.append((prev, total_dur))
    return _in_intervals(t, comp, guard)


def tracker_metrics(pm_sec, voi, true_gci, voiced_intervals, f0_at,
                    total_dur, gpe_tol: float = 0.2):
    """Standard tracker scores against exact ground truth.

    Returns dict with:
      gpe        — fraction of voiced-region marks whose local f0 deviates
                   more than ``gpe_tol`` (relative) from the true contour;
      voi_miss   — fraction of voiced-region marks labelled unvoiced;
      voi_fa     — fraction of unvoiced-region marks labelled voiced;
      gci_hit    — fraction of true GCIs with a voiced mark within
                   0.25 T0 after constant-offset removal;
      gci_jitter — std (s) of the mark-to-GCI placement residual.
    """
    pm_sec = np.asarray(pm_sec, np.float64)
    voi = np.asarray(voi).astype(bool)

    in_v = _in_intervals(pm_sec, voiced_intervals)
    in_u = _in_complement(pm_sec, voiced_intervals, total_dur)

    # --- voicing decisions
    voi_miss = float(np.mean(~voi[in_v])) if in_v.any() else 0.0
    voi_fa = float(np.mean(voi[in_u])) if in_u.any() else 0.0

    # --- GPE on marks that are voiced in truly-voiced regions: local f0
    # from consecutive voiced-mark spacing
    est_f0 = np.zeros(len(pm_sec))
    d = np.diff(pm_sec)
    est_f0[1:] = np.where(d > 0, 1.0 / np.maximum(d, 1e-9), 0.0)
    both_v = in_v & voi & np.roll(in_v & voi, 1)
    both_v[0] = False
    true_f = f0_at(pm_sec)
    ok = both_v & (true_f > 0)
    gpe = float(np.mean(
        np.abs(est_f0[ok] - true_f[ok]) > gpe_tol * true_f[ok])) \
        if ok.any() else 1.0

    # --- GCI identification: voiced marks vs true GCIs, constant-offset
    # removed (the placer snaps to waveform troughs, a filter-delayed
    # landmark — a fixed lag is not an error, jitter is)
    marks_v = pm_sec[voi & in_v]
    gci = np.asarray(true_gci)
    gci_mask = _in_intervals(gci, voiced_intervals)
    gci = gci[gci_mask]
    if len(marks_v) and len(gci):
        idx = np.searchsorted(marks_v, gci)
        idx = np.clip(idx, 1, len(marks_v) - 1)
        near = np.where(
            np.abs(marks_v[idx] - gci) < np.abs(marks_v[idx - 1] - gci),
            marks_v[idx], marks_v[idx - 1])
        resid = near - gci
        offset = np.median(resid)
        t0_local = 1.0 / np.maximum(f0_at(gci), 1.0)
        hit = np.abs(resid - offset) < 0.25 * t0_local
        gci_hit = float(np.mean(hit))
        gci_jitter = float(np.std((resid - offset)[hit])) if hit.any() \
            else float("inf")
    else:
        gci_hit, gci_jitter = 0.0, float("inf")

    return dict(gpe=gpe, voi_miss=voi_miss, voi_fa=voi_fa,
                gci_hit=gci_hit, gci_jitter=gci_jitter)
