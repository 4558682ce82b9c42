"""Public op namespace: the kernel-level building blocks of the framework.

Mirrors the reference's ``libaudio`` utility surface (SURVEY.md §2.2) as
jit-able JAX ops over dense (frames, bins) tensors:

  framing   — pitch-synchronous gather-framing / OLA scatter-add
  windows   — closed-form asymmetric window evaluation
  spectral  — hermitian half, rceps/min-phase, crossfade, mel curve, log/db
  melcep    — mel-cepstrum solve + warp/unwarp (SPTK mcep/freqt/c2acr/
              mc2b/b2mc replacements)
  fbank     — filter-bank warp family
  filters   — medfilt, IIR-as-FFT-convolution, scan-based lfilter
  interp    — coefficient extension / linear maps
  misc_dsp  — the remaining libaudio utility surface (smoothing,
              unvoiced-region interp, spectral RMS, masks, ...)
"""
from ..core import (fbank, filters, framing, interp, melcep, misc_dsp,
                    spectral, windows)
from ..core.misc_dsp import (gen_mask_simple, interp_unv_regions,
                             mcep_to_lin_sp_log, mix_by_mask,
                             next_pow_of_two, smooth_by_conv, win_squared)
from ..core.spectral import get_rms
from ..core.framing import (frame_geometry, ola_centered, ola_centered_batch,
                            pitch_sync_frames, pitch_sync_frames_batch,
                            apply_anti_ringing)
from ..core.melcep import (sp_to_mcep, sp_mel_warp, sp_mel_unwarp,
                           mcep_to_sp_cosmat, freqt, c2acr_r0, mc2b, b2mc)
from ..core.spectral import (add_hermitian_half, remove_hermitian_half,
                             build_min_phase_from_mag_spec, build_mel_curve,
                             protected_log, db, rceps, true_envelope,
                             spectral_crossfade)
from ..core.filters import medfilt3, lfilter, sosfilt, butter_highpass_sos

__all__ = [
    "fbank", "filters", "framing", "interp", "melcep", "spectral",
    "windows", "frame_geometry", "ola_centered", "ola_centered_batch",
    "pitch_sync_frames", "pitch_sync_frames_batch", "apply_anti_ringing",
    "sp_to_mcep", "sp_mel_warp", "sp_mel_unwarp", "mcep_to_sp_cosmat",
    "freqt", "c2acr_r0", "mc2b", "b2mc", "add_hermitian_half",
    "remove_hermitian_half", "build_min_phase_from_mag_spec",
    "build_mel_curve", "protected_log", "db", "rceps", "true_envelope",
    "spectral_crossfade", "medfilt3", "lfilter", "sosfilt",
    "butter_highpass_sos", "misc_dsp", "smooth_by_conv",
    "interp_unv_regions", "mcep_to_lin_sp_log", "next_pow_of_two",
    "win_squared", "gen_mask_simple", "mix_by_mask", "get_rms",
]
