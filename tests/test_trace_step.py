"""The trace reduction of scripts/trace_step.py, checked on a CPU trace."""

import glob
import os
import sys

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import trace_step  # noqa: E402


def test_union_merges_overlapping_spans():
    assert trace_step._union_ns([]) == 0
    assert trace_step._union_ns([(20, 30), (0, 10), (5, 15)]) == 25
    assert trace_step._union_ns([(0, 10), (2, 3)]) == 10


def test_reduce_recorded_trace(tmp_path):
    f = jax.jit(lambda x: (jnp.sin(x) * 2).sum())
    x = jnp.ones(1 << 16)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    (path,) = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    assert trace_step.reduce_xplane(path) == {}      # no device planes here
    red = trace_step.reduce_xplane(path, prefix="/host:CPU")
    lines = red["/host:CPU"]
    assert lines
    assert any(ln["busy_ns"] > 0 for ln in lines.values())
    for ln in lines.values():
        assert 0 <= ln["busy_ns"] <= ln["window_ns"]
        assert 0.0 <= ln["idle_share"] <= 1.0
        totals = [t for _, t, _ in ln["top"]]
        assert totals == sorted(totals, reverse=True)
        assert all(n >= 1 for _, _, n in ln["top"])
