"""Runtime configuration: compile-cache placement, the device-memory
budget, a `--server` client that never starts a JAX backend, and the
explicit matmul precision of the sites that would otherwise run in TF32
on a GPU."""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env_over) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "MAGPHASE_NO_COMPILE_CACHE")}
    env.update(JAX_PLATFORMS="cpu", **env_over)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


_CACHE_DIR = ("import sys; sys.path.insert(0, '.'); import magphase_jax, "
              "jax; print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_in_checkout_without_env():
    import magphase_jax
    got = _run(_CACHE_DIR)
    assert got == os.path.join(REPO, ".jax_cache")
    assert got == magphase_jax.COMPILE_CACHE_DIR


def test_compile_cache_follows_env(tmp_path):
    got = _run(_CACHE_DIR, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert got == str(tmp_path)


def test_frame_budget_without_stats_keeps_cpu_default():
    from magphase_jax.utils import padding
    assert padding.frame_elems_from_stats(None) == padding.MAX_FRAME_ELEMS
    assert padding.frame_elems_from_stats({}) == padding.MAX_FRAME_ELEMS
    # the CPU backend reports no allocator stats
    assert padding.max_frame_elems() == padding.MAX_FRAME_ELEMS == 192 << 20


def test_frame_budget_from_allocator_limit():
    from magphase_jax.utils import padding
    limit = 60 * 10 ** 9
    got = padding.frame_elems_from_stats({"bytes_limit": limit})
    assert got == int(limit * 0.75) // padding.BYTES_PER_ROW_ELEM
    assert got * padding.BYTES_PER_ROW_ELEM <= limit


def test_server_client_initialises_no_backend(tmp_path):
    """`cli <cmd> --server SOCK` forwards argv over the socket and must
    never open a device: the daemon holds the card."""
    code = f"""
import json, os, socket, sys, threading
sys.path.insert(0, '.')
sock = {str(tmp_path / 's.sock')!r}
srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
srv.bind(sock); srv.listen(1)
def answer():
    c, _ = srv.accept()
    c.recv(65536)
    c.sendall(b'{{"rc": 0, "error": null}}\\n'); c.close()
threading.Thread(target=answer, daemon=True).start()
from magphase_jax import cli
rc = cli.main(['generate', '--scp', 'x.scp', '--feats-dir', 'f',
               '--out-dir', 'o', '--server', sock])
from jax._src import xla_bridge
print(rc, xla_bridge.backends_are_initialized())
"""
    assert _run(code) == "0 False"


def _dot_precisions(fn, *args):
    """precision= of every dot_general in fn's jaxpr (sub-jaxprs of scans
    and loops included: the printed jaxpr nests them)."""
    text = str(jax.make_jaxpr(fn)(*args))
    eqns = re.findall(r"dot_general\[(.*?)\n\s*\]", text, re.DOTALL)
    return [re.search(r"precision=(.*)", e).group(1) for e in eqns]


@pytest.mark.parametrize("site", ["filters.lfilter", "misc_dsp.smooth"])
def test_matmul_sites_carry_highest_precision(site):
    """The IIR state-map composition and the smoothing contraction ask
    for HIGHEST, so a GPU never runs them in TF32."""
    from magphase_jax.core import filters, misc_dsp
    if site == "filters.lfilter":
        fn = lambda x: filters.lfilter((0.2, 0.3), (1.0, -0.5, 0.1), x)
        args = (jnp.ones(64, jnp.float32),)
    else:
        fn = lambda x: misc_dsp.smooth_by_conv(x, np.hanning(7))
        args = (jnp.ones((32, 5), jnp.float32),)
    precs = _dot_precisions(fn, *args)
    assert precs, f"{site}: no dot_general traced"
    assert all(p == "(Precision.HIGHEST, Precision.HIGHEST)"
               for p in precs), precs
