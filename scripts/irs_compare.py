"""Wall-clock-to-convergence: explicit RK2 vs RK2 + implicit residual
smoothing, measured against the converged-oracle Cl band (VERDICT #7)."""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822, force_coefficients  # noqa: E402

BAND = (0.815, 0.862)       # coarse oracle limit cycle (rae2822_cp_coarse)


def run(tag, **kw):
    case = build_rae2822(wall_h=2e-2, feature_h=1e-2, **kw)
    P = case.march(case.P0, 2)
    jax.block_until_ready(P)
    P = case.P0
    t0 = time.time()
    entered = None
    for n in range(1000, 14001, 1000):
        P = case.march(P, 1000)
        jax.block_until_ready(P)
        if not np.isfinite(np.asarray(P)).all():
            print(f"{tag}: diverged at {n}", flush=True)
            return
        cl, cd = force_coefficients(case, np.asarray(P))
        t = time.time() - t0
        inside = BAND[0] <= cl <= BAND[1]
        if inside and entered is None:
            entered = (n, t)
        elif not inside:
            entered = None
        print(f"{tag} n={n} t={t:.1f}s Cl={cl:.4f}"
              f"{'  <- in band' if inside else ''}", flush=True)
    print(f"{tag}: settled-in-band from {entered}", flush=True)


if __name__ == "__main__":
    run("rk2 cfl0.7", cfl=0.7)
    run("rk2+irs(0.6) cfl1.4", cfl=1.4, irs_eps=0.6)
