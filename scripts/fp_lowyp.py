"""Reproduce + diagnose the low-y+ flat-plate wall-function divergence
(VERDICT r3 item 5, second half). CPU-sized case: Re=6e5 where
wall_h=1e-2 gives first-center y+ ~ 140 (the marching regime) and
wall_h=4e-3 gives y+ ~ 60 (the diverging regime at the committed Re=5e6).

Usage: python scripts/fp_lowyp.py [wall_h=4e-3] [steps=4000] [chunk=200]
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np          # noqa: E402
import jax                  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases.flat_plate import (    # noqa: E402
    build_flat_plate, cf_schultz_grunow, skin_friction_profile)


def main():
    kw = dict(wall_h=4e-3, reynolds=6e5, length=1.25, height=0.5,
              mach=0.2, cfl=0.5)
    steps, chunk = 4000, 200
    for a in sys.argv[1:]:
        k, v = a.split("=")
        if k == "steps":
            steps = int(v)
        elif k == "chunk":
            chunk = int(v)
        else:
            kw[k] = float(v)
    t0 = time.time()
    case = build_flat_plate(**kw)
    print(f"cells={case.dom.ncells} build={time.time()-t0:.0f}s", flush=True)
    P, Rt = case.P0, case.Rt0
    t0 = time.time()
    for i in range(steps // chunk):
        P, Rt = case.march(P, Rt, chunk)
        jax.block_until_ready(P)
        Pn = np.asarray(P)
        if not np.isfinite(Pn).all():
            bad = ~np.isfinite(Pn).any(axis=1)
            print(f"step {(i+1)*chunk}: NON-FINITE ({bad.sum()} cells)",
                  flush=True)
            return 1
        x, cf = skin_friction_profile(case, Pn)
        sel = (x > 0.3) & (x < 1.0)
        rel = cf[sel] / cf_schultz_grunow(kw["reynolds"] * x[sel]) - 1.0
        umax = np.abs(Pn[:, 2:]).max()
        pmin = Pn[:, 0].min()
        print(f"step {(i+1)*chunk}: mean_rel={rel.mean():+.4f} "
              f"|u|max={umax:.1f} pmin={pmin:.0f} Rtmax={np.asarray(Rt).max():.2e} "
              f"t={time.time()-t0:.0f}s", flush=True)
    print("survived", steps, "steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
