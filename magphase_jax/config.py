"""Typed configuration for the MagPhase vocoder.

The reference (CSTR-Edinburgh/magphase) scatters its knobs across function
kwargs with sample-rate-keyed defaults:

- ``define_alpha``           -> /root/reference/src/magphase.py:3279-3290
- ``define_fft_len``         -> /root/reference/src/magphase.py:3292-3299
- ``define_crossfade_params``-> /root/reference/src/magphase.py:3301-3317
- unvoiced frame rate 5 ms   -> /root/reference/src/magphase.py:2210-2215
- mag_dim=60 / phase_dim=45  -> /root/reference/src/magphase.py:2490

Here they live in one frozen dataclass so every kernel is statically
parameterised (static shapes / constants under ``jax.jit``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def define_alpha(fs: int) -> float:
    """All-pass mel-warping constant per sample rate (magphase.py:3279-3290)."""
    table = {16000: 0.58, 22050: 0.65, 44100: 0.76, 48000: 0.77}
    if fs not in table:
        raise ValueError(f"Sample rate {fs} not supported yet.")
    return table[fs]


def define_fft_len(fs: int) -> int:
    """Default FFT length per sample rate (magphase.py:3292-3299)."""
    if fs in (22050, 16000):
        return 2048
    if fs == 8000:
        return 1024
    return 4096


def define_crossfade_params(fs: int) -> tuple[float, float]:
    """Voiced periodic/aperiodic crossfade centre/bandwidth in Hz
    (magphase.py:3301-3317)."""
    crsf_bw = 2000.0
    if fs == 48000:
        crsf_cf = 5000.0
    elif fs == 16000:
        crsf_cf = 2500.0
    elif fs == 44100:
        crsf_cf = 4500.0
    else:
        crsf_cf = 3500.0
    return crsf_cf, crsf_bw


@dataclasses.dataclass(frozen=True)
class MagPhaseConfig:
    """Static configuration of one vocoder instance.

    All fields are hashable so a config can be a static argument to jitted
    kernels.
    """

    fs: int = 48000
    fft_len: int = 0                 # 0 -> derive from fs
    alpha: float = 0.0               # 0 -> derive from fs
    crossfade_cf_hz: float = 0.0     # 0 -> derive from fs
    crossfade_bw_hz: float = 2000.0
    mag_dim: int = 60
    phase_dim: int = 45
    unv_frm_rate_ms: float = 5.0     # unvoiced frame rate (magphase.py:2210)
    const_rate_ms: float = 5.0       # constant-frame-rate mode step
    # synthesis knobs (magphase.py:825-997)
    b_voi_ap_win: bool = True        # bartlett^2.5 noise window on voiced frames
    per_phase_type: str = "magphase"  # 'magphase' | 'linear' | 'min_phase'
    hpf_order: int = 4
    hpf_fc_hz: float = 40.0
    crsf_curve_fact: float = 0.5     # sqrt-mask exponent (magphase.py:946)
    # post-filter defaults (magphase.py:2300-2346)
    pf_coef_merlin: float = 1.4

    def __post_init__(self):
        if self.fft_len == 0:
            object.__setattr__(self, "fft_len", define_fft_len(self.fs))
        if self.alpha == 0.0:
            object.__setattr__(self, "alpha", define_alpha(self.fs))
        if self.crossfade_cf_hz == 0.0:
            cf, bw = define_crossfade_params(self.fs)
            object.__setattr__(self, "crossfade_cf_hz", cf)
            object.__setattr__(self, "crossfade_bw_hz", bw)

    @property
    def fft_len_half(self) -> int:
        return self.fft_len // 2 + 1

    @property
    def unv_shift_smpls(self) -> float:
        """Frame shift used for unvoiced frames, in samples."""
        return self.fs * self.unv_frm_rate_ms / 1000.0

    def replace(self, **kw) -> "MagPhaseConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_48K = MagPhaseConfig(fs=48000)
DEFAULT_16K = MagPhaseConfig(fs=16000)
