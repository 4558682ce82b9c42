#!/usr/bin/env python
"""Lossless copy-synthesis demo (reference:
demos/demo_copy_synthesis_lossless.py).

Extracts high-resolution MagPhase parameters (mag / real / imag / f0) from a
wave file — epochs via the built-in JAX tracker — and resynthesises it.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from magphase_jax.io import write_audio_file, get_filename, mkdir
from magphase_jax.utils.stimuli import demo_wav
from magphase_jax.vocoder import analysis_lossless, synthesis_from_lossless

if __name__ == "__main__":
    out_dir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        os.path.dirname(__file__), "..", ".smoke", "examples")
    mkdir(out_dir)
    # a wav path argument, or a generated 48 kHz utterance
    wav_file_orig = sys.argv[1] if len(sys.argv) > 1 else demo_wav(out_dir)
    mkdir(out_dir)

    print("Analysing...")
    m_mag, m_real, m_imag, v_f0, fs, v_shift = analysis_lossless(wav_file_orig)

    print("Synthesising...")
    v_syn_sig = synthesis_from_lossless(m_mag, m_real, m_imag, v_f0, fs)

    out = os.path.join(out_dir,
                       get_filename(wav_file_orig) + "_copy_syn_lossless.wav")
    write_audio_file(out, v_syn_sig, fs)
    print("Wrote", out)
