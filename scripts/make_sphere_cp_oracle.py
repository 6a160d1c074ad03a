"""Generate the converged 3D sphere surface-Cp oracle (VERDICT round-3
item 2: a QUANTITATIVE 3D accuracy anchor).

Low-Mach (M = 0.2) Euler flow over the STL icosphere: the converged
surface Cp is compared against the incompressible potential-flow solution
Cp(theta) = 1 - 9/4 sin^2(theta)  (theta = angle from the +x flow axis),
with a band for compressibility (a few % at M=0.2) + mesh truncation.
Writes tests/data/sphere3d_cp.npz with the surface points, Cp, the
converged STATE (restart file for the drift-regression test), Cd history
(d'Alembert: inviscid pressure drag -> 0), and config metadata.

Run on the GPU (long march); chunked + checkpointed so a killed run resumes.
"""

import json
import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_sphere3d                      # noqa: E402
from ibx.physics.fluid import pressure_coefficient        # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data")

CFG = dict(
    wall_h=float(os.environ.get("IBX_SPHERE_WALL_H", "0.05")),
    block_size=int(os.environ.get("IBX_SPHERE_BS", "8")),
    mach=0.2,
    cfl=0.7,
    surface_h=0.12,
    farfield=4.0,
)
STEPS = int(os.environ.get("IBX_SPHERE_STEPS", "30000"))
CHUNK = 2000


def sphere_cp(case, P):
    surf = case.dom.surfaces["wall"]
    p_wall = np.asarray(surf(P[:, 0]))
    return np.asarray(pressure_coefficient(
        case.fluid, p_wall, float(case.P_inf[0]), case.mach))


def drag_coefficient(case, P):
    """Pressure-drag coefficient on the frontal area pi r^2 (r = 0.5)."""
    surf = case.dom.surfaces["wall"]
    cp = sphere_cp(case, P)
    f = -cp[:, None] * surf.normals * surf.areas[:, None]
    return float(f.sum(axis=0)[0] / (np.pi * 0.25))


def main():
    t0 = time.time()
    case = build_sphere3d(**CFG)
    print(f"cells={case.dom.ncells} blocks(bs={CFG['block_size']}) "
          f"build={time.time() - t0:.0f}s", flush=True)
    P = case.P0
    partial = "/tmp/sphere3d_partial.npz"
    hist = []
    i0 = 0
    if os.path.exists(partial):
        d = np.load(partial)
        P = case.apply_bcs(jax.numpy.asarray(d["P"]))
        i0 = int(d["i"])
        hist = [tuple(r) for r in d["hist"]]
        print(f"resumed partial at chunk {i0}", flush=True)
    t0 = time.time()
    for i in range(i0, STEPS // CHUNK):
        P = case.march(P, CHUNK)
        jax.block_until_ready(P)
        Pn = np.asarray(P)
        cd = drag_coefficient(case, Pn)
        cp = sphere_cp(case, Pn)
        hist.append((cd, float(cp.max()), float(cp.min())))
        print(f"step {(i + 1) * CHUNK}: Cd={cd:+.5f} "
              f"Cp_max={cp.max():.4f} Cp_min={cp.min():.4f}", flush=True)
        if (i + 1) % 5 == 0:
            np.savez(partial, P=Pn, i=i + 1,
                     hist=np.asarray(hist, np.float32))
    Pn = np.asarray(P)
    assert np.isfinite(Pn).all()
    if os.path.exists(partial):
        os.remove(partial)
    cp = sphere_cp(case, Pn)
    surf = case.dom.surfaces["wall"]
    out = os.path.join(OUT, "sphere3d_cp.npz")
    np.savez_compressed(
        out,
        points=surf.points.astype(np.float32),
        cp=cp.astype(np.float32),
        cd=drag_coefficient(case, Pn),
        hist=np.asarray(hist, np.float32),
        P=Pn,
        meta=json.dumps(dict(CFG, steps=STEPS, cells=case.dom.ncells)),
    )
    print(f"wrote {out}  Cd={drag_coefficient(case, Pn):+.5f} "
          f"march={time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
