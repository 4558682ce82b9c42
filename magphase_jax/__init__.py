"""magphase_jax — a JAX MagPhase-class vocoder framework.

Brand-new JAX/XLA/Pallas implementation of the capabilities of
CSTR-Edinburgh/magphase (see SURVEY.md): pitch-synchronous spectral
analysis (mag/real/imag/lf0 streams), mel-warped compression, post-filters,
and FFT+PSOLA resynthesis — with the reference's external native tools
(REAPER, SPTK) re-implemented as on-device JAX kernels.
"""
import os as _os

# The persistent XLA compile cache: JAX reads JAX_COMPILATION_CACHE_DIR
# itself when it is set; otherwise the cache sits at a fixed directory
# inside the checkout (the path is part of what makes a cache hit, and
# the checkout is the one place this package may write).
# MAGPHASE_NO_COMPILE_CACHE=1 disables it.
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _enable_persistent_compile_cache() -> None:
    if (_os.environ.get("MAGPHASE_NO_COMPILE_CACHE")
            or _os.environ.get("JAX_COMPILATION_CACHE_DIR")):
        return
    import jax
    _os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_persistent_compile_cache()

from .config import (MagPhaseConfig, define_alpha, define_fft_len,
                     define_crossfade_params, DEFAULT_48K, DEFAULT_16K)
from .vocoder import (analysis_lossless, analysis_with_del_comp_from_pm,
                      synthesis_from_lossless, f0_to_shift, shift_to_pm,
                      pm_to_shift)

__version__ = "0.1.0"
