"""Test configuration: the CPU backend with 8 virtual devices, so
sharding tests run without accelerators, set before jax initialises.
A platform named in JAX_PLATFORMS wins: `JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/` runs the `gpu` tests on a card."""
import os

_PLATFORMS = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORMS)
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

@pytest.fixture(scope="session")
def demo_wav():
    """A 2.5 s, 48 kHz speech-like utterance (utils/stimuli.py) on the PCM16
    lattice, standing in for the reference's demo wav
    (demo_copy_synthesis_lossless.py:60)."""
    from magphase_jax.utils.stimuli import make_corpus
    u = make_corpus(1, 48000, seed=593, min_s=2.5, max_s=2.5)[0]
    return np.rint(u.sig * 32768.0) / 32768.0, u.fs


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")


@pytest.fixture(scope="session")
def synthetic_pm():
    """Deterministic pseudo pitch marks with exactly fs-divisor shifts, so
    the f0 <-> shift round trip is float-exact (see tests for rationale)."""
    rng = np.random.RandomState(0)
    shifts = rng.choice([200, 240, 250, 300, 320, 400, 480], size=400)
    pm = np.cumsum(shifts)
    return pm, shifts
