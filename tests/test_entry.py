"""Driver entry points stay green (single-chip step + multichip dryrun)."""

import os
import sys

import numpy as np
import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_entry_single_chip():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(np.asarray(out)).all()


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.slow   # a second full dryrun in a fresh subprocess; the
# in-process test above keeps the fast-tier coverage
def test_dryrun_multichip_driver_path():
    """Run the dryrun in a fresh subprocess WITHOUT the conftest env.

    ``dryrun_multichip`` must bootstrap its own virtual CPU mesh in a bare
    process (no JAX_PLATFORMS / XLA_FLAGS in the environment), where JAX
    would otherwise pick the default backend.
    """
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        capture_output=True, text=True, timeout=2400, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout
