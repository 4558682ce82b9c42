"""Legacy type1/type2 synthesis variants."""
import os

import numpy as np
import jax
import pytest

from magphase_jax.io import read_binfile
from magphase_jax.vocoder.variants import (synthesis_from_compressed_type1,
                                           synthesis_from_compressed_type2)

PRED = "/root/reference/demos/data_48k/params_predicted"


@pytest.fixture(scope="module")
def params():
    return (read_binfile(os.path.join(PRED, "hvd_704.mag"), 60),
            read_binfile(os.path.join(PRED, "hvd_704.real"), 45),
            read_binfile(os.path.join(PRED, "hvd_704.imag"), 45),
            read_binfile(os.path.join(PRED, "hvd_704.lf0"), 1))


def test_type1_synthesis(params):
    mag, real, imag, lf0 = params
    v = synthesis_from_compressed_type1(mag, real, imag, lf0, 48000,
                                        key=jax.random.PRNGKey(0))
    assert np.all(np.isfinite(v))
    assert np.std(v) > 1e-4
    # same expected length as the live path
    from magphase_jax.vocoder import framerate
    sh = framerate.f0_to_shift_np(np.exp(lf0), 48000).astype(np.int64)
    pm = np.cumsum(sh)
    assert v.shape[0] == pm[-1] + (pm[-1] - pm[-2]) + 1


def test_type2_synthesis(params):
    mag, real, imag, lf0 = params
    v = synthesis_from_compressed_type2(mag, real, imag, lf0, 48000,
                                        key=jax.random.PRNGKey(0))
    assert np.all(np.isfinite(v))
    assert np.std(v) > 1e-4
