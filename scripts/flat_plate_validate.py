"""Converge the turbulent flat-plate RANS case on the GPU and commit the Cf
profile as tests/data/flat_plate_cf.npz (asserted against the published
Prandtl / Schultz-Grunow correlations by tests/test_flat_plate.py).

Default config puts the first cell center at y+ ~ 100-200 over the
stations of interest (0.3 < x < 1.0), squarely in the log layer the
wall function assumes.

Usage:  python scripts/flat_plate_validate.py [steps=N] [wall_h=...]
"""

import json
import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases.flat_plate import (  # noqa: E402
    build_flat_plate,
    cf_prandtl,
    cf_schultz_grunow,
    skin_friction_profile,
)

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "flat_plate_cf.npz")

CFG = dict(wall_h=1.25e-3, length=1.25, height=0.5, reynolds=5e6,
           mach=0.2, cfl=0.5)


def main():
    global OUT
    steps = 30000
    for a in sys.argv[1:]:
        k, v = a.split("=")
        if k == "steps":
            steps = int(v)
        elif k == "out":
            OUT = v
        elif k == "closure":
            # closure=mixing_length: the flagged accurate-Cf arm
            # (VERDICT r4 item 6); writes flat_plate_cf_ml.npz unless
            # out= overrides
            CFG[k] = v
            if OUT.endswith("flat_plate_cf.npz"):
                OUT = OUT.replace("flat_plate_cf.npz",
                                  f"flat_plate_cf_{'ml' if v == 'mixing_length' else v}.npz")
        else:
            CFG[k] = float(v)
    t0 = time.time()
    case = build_flat_plate(use_blocks=True, **CFG)
    print(f"cells={case.dom.ncells} build={time.time()-t0:.0f}s", flush=True)
    P, Rt = case.P0, case.Rt0
    chunk = 2000
    t0 = time.time()
    for i in range(steps // chunk):
        P, Rt = case.march(P, Rt, chunk)
        jax.block_until_ready(P)
        x, cf = skin_friction_profile(case, np.asarray(P))
        sel = (x > 0.3) & (x < 1.0)
        rel = cf[sel] / cf_schultz_grunow(case.reynolds * x[sel]) - 1.0
        print(f"step {(i+1)*chunk}: mean_rel={np.abs(rel).mean():.4f} "
              f"max_rel={np.abs(rel).max():.4f} t={time.time()-t0:.0f}s",
              flush=True)
    Pn, Rtn = np.asarray(P), np.asarray(Rt)
    assert np.isfinite(Pn).all() and np.isfinite(Rtn).all()
    x, cf = skin_friction_profile(case, Pn)
    np.savez_compressed(
        OUT, x=x, cf=cf, reynolds=CFG["reynolds"],
        meta=json.dumps(dict(CFG, steps=steps, cells=case.dom.ncells)),
    )
    sel = (x > 0.3) & (x < 1.0)
    for name, corr in (("prandtl", cf_prandtl),
                       ("schultz-grunow", cf_schultz_grunow)):
        rel = cf[sel] / corr(case.reynolds * x[sel]) - 1.0
        print(f"vs {name}: mean |rel| = {np.abs(rel).mean():.4f}, "
              f"max |rel| = {np.abs(rel).max():.4f}", flush=True)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
