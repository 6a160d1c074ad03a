"""Post-projection-fix solver rematch on the STEADY fine mesh (VERDICT #5).

The round-3 mid-round conclusion ("no implicit/IRS scheme beats explicit
TVD-RK2") was measured BEFORE the projection-epsilon fix, when ghost
normals carried +-25 deg noise — exactly the kind of forcing that defeats
residual smoothing and implicit relaxation. The post-fix fine level
(wall_h=5e-3, bs=8) converges to a genuinely STEADY state (phase mean
|dCp| 6e-5), the friendliest regime for acceleration. Rematch from
freestream: wall-clock to |Cl - Cl*| < tol sustained.

Run on the GPU:  python scripts/fine_solver_compare.py
"""

import json
import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822, force_coefficients  # noqa: E402

CL_STAR = 0.8981          # committed fine-oracle steady lift
TOL = 0.005
CHUNK = 2000
MAX_STEPS = 120000


def run(tag, case, max_steps=MAX_STEPS):
    P = case.march(case.P0, 2)
    jax.block_until_ready(P)
    t0 = time.time()
    n = 0
    t_hit = None
    n_hit = None
    while n < max_steps:
        P = case.march(P, CHUNK)
        jax.block_until_ready(P)
        n += CHUNK
        Pn = np.asarray(P)
        if not np.isfinite(Pn).all():
            print(f"[{tag}] DIVERGED at {n}", flush=True)
            return dict(tag=tag, diverged=True)
        cl, cd = force_coefficients(case, Pn)
        inside = abs(cl - CL_STAR) < TOL
        if inside and t_hit is None:
            t_hit, n_hit = time.time() - t0, n
        elif not inside:
            t_hit = n_hit = None
        if n % 10000 == 0:
            print(f"[{tag}] {n}: Cl={cl:.4f} t={time.time()-t0:.0f}s",
                  flush=True)
        if t_hit is not None and n - n_hit >= 10000:
            # sustained for 10k steps
            print(f"[{tag}] SETTLED: first-hit step={n_hit} "
                  f"t={t_hit:.1f}s (Cl={cl:.4f})", flush=True)
            return dict(tag=tag, settle_steps=n_hit,
                        settle_seconds=round(t_hit, 1),
                        cl=round(float(cl), 4))
    print(f"[{tag}] no settle in {max_steps} (Cl={cl:.4f})", flush=True)
    return dict(tag=tag, settle_steps=None, cl=round(float(cl), 4))


def main():
    base = dict(wall_h=5e-3, feature_h=2.5e-3, block_size=8)
    arms = [
        ("rk2 cfl0.7", dict(cfl=0.7)),
        ("rk2+irs e0.3 cfl1.3", dict(cfl=1.3, irs_eps=0.3)),
        ("rk2+irs e0.6 cfl1.7", dict(cfl=1.7, irs_eps=0.6)),
        ("euler cfl0.4", dict(cfl=0.4, scheme="euler")),
    ]
    which = sys.argv[1:] or None
    out = []
    for tag, kw in arms:
        if which and not any(wq in tag for wq in which):
            continue
        t0 = time.time()
        case = build_rae2822(**base, **kw)
        print(f"[{tag}] build={time.time()-t0:.0f}s "
              f"cells={case.dom.ncells}", flush=True)
        out.append(run(tag, case))
        del case
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
