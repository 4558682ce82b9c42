"""Native C++ corpus-IO runtime vs the pure-Python codecs."""
import os

import numpy as np
import pytest

from magphase_jax.io import native
from magphase_jax.io.wav import read_wav as py_read_wav

DATA = "/root/reference/demos/data_48k/wavs_nat"
TOKS = ["hvd_593", "hvd_594", "hvd_595"]


@pytest.fixture(scope="module")
def lib_ok():
    if not native.build():
        pytest.skip("native toolchain unavailable")
    if not native.available():
        pytest.skip("native library failed to load")
    return True


def test_native_read_wav_matches_python(lib_ok):
    for tok in TOKS:
        path = f"{DATA}/{tok}.wav"
        sig_py, fs_py = py_read_wav(path)
        sig_na, fs_na = native.read_wav(path)
        assert fs_na == fs_py
        assert len(sig_na) == len(sig_py)
        np.testing.assert_allclose(sig_na, sig_py, atol=1e-7)


def test_native_batch_read(lib_ok):
    paths = [f"{DATA}/{t}.wav" for t in TOKS]
    max_len = 1 << 18
    out, lens, fss = native.batch_read_wavs(paths, max_len)
    assert out.shape == (len(paths), max_len)
    for i, p in enumerate(paths):
        sig, fs = py_read_wav(p)
        assert fss[i] == fs and lens[i] == len(sig)
        np.testing.assert_allclose(out[i, :lens[i]], sig, atol=1e-6)
        assert np.all(out[i, lens[i]:] == 0.0)


def test_native_binfile_roundtrip(lib_ok, tmp_path):
    from magphase_jax.io import write_binfile
    m = np.random.RandomState(0).randn(40, 60).astype(np.float32)
    p = str(tmp_path / "x.mag")
    write_binfile(m, p)
    got = native.read_binfile(p, dim=60)
    np.testing.assert_array_equal(got, m)
