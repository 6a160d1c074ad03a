"""Workload 5 convergence run (VERDICT r4 item 7): drive the 3D RANS wing
to a measured residual drop (target >= 1 order) with the production
explicit TVD-RK2 march (the scheme the FAS verdict left standing), and
commit a quantitative oracle: converged state + wall Cp + lift
coefficient + residual history -> tests/data/wing3d_oracle.npz, asserted
by tests/test_wing3d_fas.py::test_wing3d_convergence_oracle.

Usage: python scripts/wing3d_converge.py [steps=20000] [chunk=1000]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                  # noqa: E402

from ibx.cases.wing3d_rans_fas import build_wing3d_rans_fas  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "wing3d_oracle.npz")


def wing_forces(wc, S):
    """(Cl, Cd) from wall-sampled pressure (chord=1, span from case)."""
    from ibx.physics.fluid import pressure_coefficient

    surf = wc.dom.surfaces["wall"]
    p_wall = np.asarray(surf(S[:, 0]))
    mach = float(np.hypot(wc.P_inf[2], wc.P_inf[3])
                 / np.sqrt(1.4 * 283.0 * wc.P_inf[1]))
    cp = np.asarray(pressure_coefficient(
        wc.fluid, p_wall, float(wc.P_inf[0]), mach))
    f = -cp[:, None] * surf.normals * surf.areas[:, None]
    F = f.sum(axis=0)
    al = np.arctan2(float(wc.P_inf[3]), float(wc.P_inf[2]))
    area = float(np.abs(surf.normals * surf.areas[:, None]).sum(0)[1]) / 2
    drag = (F[0] * np.cos(al) + F[1] * np.sin(al)) / max(area, 1e-9)
    lift = (-F[0] * np.sin(al) + F[1] * np.cos(al)) / max(area, 1e-9)
    return float(lift), float(drag), cp


def main():
    steps = 20000
    chunk = 1000
    for a in sys.argv[1:]:
        k, v = a.split("=")
        if k == "steps":
            steps = int(v)
        elif k == "chunk":
            chunk = int(v)
    t0 = time.time()
    wc = build_wing3d_rans_fas(1)
    print(f"cells={wc.dom.ncells} build={time.time()-t0:.0f}s", flush=True)

    S = wc.S0_sh
    hist = []
    t0 = time.time()
    l2_0, mx_0 = wc.res_norms(S)
    print(f"step 0: L2(dtR)={float(l2_0):.4e} max={float(mx_0):.4e}",
          flush=True)
    cl0, cd0, _ = wing_forces(wc, wc.collect(S))
    hist.append((0.0, float(l2_0), cl0, cd0, float(mx_0)))
    for i in range(steps // chunk):
        S = wc.march(S, chunk)
        l2, mx = wc.res_norms(S)
        jax.block_until_ready(S)
        Sg = wc.collect(S)
        if not np.isfinite(Sg).all():
            print(f"NON-FINITE at step {(i+1)*chunk}", flush=True)
            break
        cl, cd, _ = wing_forces(wc, Sg)
        hist.append((float((i + 1) * chunk), float(l2), cl, cd,
                     float(mx)))
        print(f"step {(i+1)*chunk}: L2(dtR)={float(l2):.4e} "
              f"max={float(mx):.4e} Cl={cl:.4f} "
              f"Cd={cd:.4f} t={time.time()-t0:.0f}s", flush=True)

    Sg = wc.collect(S)
    cl, cd, cp = wing_forces(wc, Sg)
    hist = np.asarray(hist, np.float64)
    drop = float(hist[:, 1].max() / hist[-1, 1])
    print(f"final: residual drop from peak = {drop:.1f}x "
          f"({hist[:, 1].max():.3e} -> {hist[-1, 1]:.3e})", flush=True)
    np.savez_compressed(
        OUT,
        S=Sg.astype(np.float32), cp=cp.astype(np.float32),
        hist=hist, cl=cl, cd=cd,
        meta=json.dumps(dict(steps=steps, chunk=chunk,
                             cells=int(wc.dom.ncells), drop=drop)),
    )
    print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
    main()
