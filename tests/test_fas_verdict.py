"""FAS verdict oracle (VERDICT r4 item 2): the committed harness
curves (scripts/fas_verdict2d.py, solved-cell functional) must show the
coarse-grid correction paying — fas arms reach fixed residual drops
faster than pure smoothing and than the production march.

Fast tier: reads the stored curves; regeneration commands in the
harness docstring.
"""

import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _t_to(curve, frac):
    """Seconds to reach frac*peak (measured from the peak), or None."""
    t, r = curve[:, 0], curve[:, 1]
    pk = int(np.argmax(r))
    hit = np.nonzero(r[pk:] <= frac * r[pk])[0]
    return float(t[pk + hit[0]]) if hit.size else None


@pytest.mark.parametrize("wall_h", ["0.02", "0.01"])
def test_fas_beats_smoothing_and_production_march(wall_h):
    path = os.path.join(DATA, f"fas_verdict2d_{wall_h}.npz")
    if not os.path.exists(path):
        pytest.skip("FAS verdict curves not yet generated")
    d = np.load(path)
    for arm in ("smooth", "fas2", "fas3", "rk2_block"):
        assert arm in d, f"missing arm {arm}"
    t_smooth = _t_to(d["smooth"], 0.3)
    t_fas2 = _t_to(d["fas2"], 0.3)
    t_fas3 = _t_to(d["fas3"], 0.3)
    t_rk2 = _t_to(d["rk2_block"], 0.3)
    assert t_fas2 is not None and t_fas3 is not None
    # FAS reaches the 0.3x drop at least 1.5x faster than smoothing and
    # than the production march (measured margins: 2.2-5.0x)
    for t_base in (t_smooth, t_rk2):
        if t_base is not None:
            assert t_fas3 < t_base / 1.5, (t_fas3, t_base)
    # deeper hierarchy does not hurt
    assert t_fas3 <= t_fas2 * 1.2

    def final_ratio(c):
        r = c[:, 1]
        return r[-1] / r[int(np.argmax(r))]

    # budget-end residual: fas3 at least 3x lower than pure smoothing
    assert final_ratio(d["fas3"]) < final_ratio(d["smooth"]) / 3.0
