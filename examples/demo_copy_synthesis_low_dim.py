#!/usr/bin/env python
"""Low-dimensional copy-synthesis demo (reference:
demos/demo_copy_synthesis_low_dim.py): mag_dim=100, phase_dim=45,
variable frame rate, no output HPF.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from magphase_jax.io import write_audio_file, get_filename, mkdir
from magphase_jax.utils.stimuli import demo_wav
from magphase_jax.vocoder import analysis_compressed, synthesis_from_compressed

if __name__ == "__main__":
    out_dir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        os.path.dirname(__file__), "..", ".smoke", "examples")
    mkdir(out_dir)
    # a wav path argument, or a generated 48 kHz utterance
    wav_file_orig = sys.argv[1] if len(sys.argv) > 1 else demo_wav(out_dir)
    mag_dim, phase_dim, b_const_rate = 100, 45, False
    mkdir(out_dir)

    print("Analysing...")
    (m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, v_shift, fs,
     fft_len) = analysis_compressed(wav_file_orig, mag_dim=mag_dim,
                                    phase_dim=phase_dim,
                                    b_const_rate=b_const_rate)

    print("Synthesising...")
    v_syn_sig = synthesis_from_compressed(m_mag_mel_log, m_real_mel,
                                          m_imag_mel, v_lf0, fs,
                                          b_const_rate=b_const_rate,
                                          b_out_hpf=False)

    out = os.path.join(
        out_dir, get_filename(wav_file_orig) +
        f"_copy_syn_low_dim_mag_dim_{mag_dim}_ph_dim_{phase_dim}"
        f"_const_rate_{int(b_const_rate)}.wav")
    write_audio_file(out, v_syn_sig, fs)
    print("Wrote", out)
