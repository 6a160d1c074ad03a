"""Trailing-edge breakdown study (VERDICT round-2 item 1).

Marches the RAE2822 case at a breakdown-prone resolution and monitors the
vacuum indicators per chunk: min pressure, fraction of cells pinned at the
p floor, Cl/Cd. Usage:

    python scripts/te_study.py <tag> wall_h=2.5e-3 te_fix_radius=0.02 steps=16000 [cfl=0.7 ...]

Run on the GPU; marches in 2000-step chunks.
"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822, force_coefficients  # noqa: E402


def main():
    tag = sys.argv[1]
    kw = {}
    steps = 16000
    chunk = 1000
    for a in sys.argv[2:]:
        k, v = a.split("=")
        if k == "steps":
            steps = int(v)
        elif k == "chunk":
            chunk = int(v)
        elif k in ("block_size",):
            kw[k] = int(v)
        elif k in ("scheme", "seed_npz"):
            kw[k] = v
        else:
            kw[k] = float(v)
    seed_npz = kw.pop("seed_npz", None)
    seed_kw = {k[5:]: kw.pop(k) for k in list(kw)
               if k.startswith("seed_") and k != "seed_npz"}
    if "block_size" in seed_kw:
        seed_kw["block_size"] = int(seed_kw["block_size"])
    kw.setdefault("feature_h", kw.get("wall_h", 1e-2) / 2)
    t0 = time.time()
    case = build_rae2822(**kw)
    print(f"[{tag}] cells={case.dom.ncells} build={time.time()-t0:.0f}s "
          f"cfg={kw}", flush=True)

    from ibx.geometry import load_surface, merge_points
    from ibx.geometry.inside import points_inside
    from ibx.cases.rae2822 import RAE_DAT
    # the coarse INPUT surface (the refined distance-field stl has ~100x
    # the segments; the winding test cost scales with it)
    stl = merge_points(load_surface(RAE_DAT))
    inside = points_inside(stl, case.dom.centers)
    fluid_mask = ~inside

    P = case.P0
    if seed_npz is not None:
        # grid sequencing: IDW-transfer a saved coarser-level state onto
        # this mesh (impulsive freestream starts at wall_h <= 1e-3 blow up
        # in the startup transient for every wall treatment)
        from ibx.solve.interp_util import idw_interpolator
        from ibx.ops.stencil import apply_stencil
        seed_kw.setdefault("feature_h", seed_kw.get("wall_h", 1e-2) / 2)
        seed_case = build_rae2822(**seed_kw)
        Ps = np.load(seed_npz)["P"]
        st = jax.device_put(idw_interpolator(
            seed_case.dom.centers, case.dom.centers))
        P = case.apply_bcs(apply_stencil(st, jax.numpy.asarray(Ps)))
        del seed_case, st
        # relax off the transfer's wall-crossing discontinuities with the
        # positivity-safe first-order + Einfeldt march (make_cp_oracle.py
        # startup recipe) before the accurate scheme
        P = case.march_robust(P, 2000)
        jax.block_until_ready(P)
        print(f"[{tag}] seeded from {seed_npz} via {seed_kw}", flush=True)
    p_inf = float(case.P_inf[0])
    t0 = time.time()
    for i in range(steps // chunk):
        P = case.march(P, chunk)
        jax.block_until_ready(P)
        Pn = np.asarray(P)
        if not np.isfinite(Pn).all():
            print(f"[{tag}] step {(i+1)*chunk}: NON-FINITE — breakdown",
                  flush=True)
            return
        pf = Pn[fluid_mask, 0]
        pinned = float((pf < 0.02 * p_inf).sum())
        cl, cd = force_coefficients(case, Pn)
        print(f"[{tag}] step {(i+1)*chunk}: Cl={cl:.4f} Cd={cd:.5f} "
              f"minp={pf.min():.1f} pinned={pinned:.0f} "
              f"maxM~{np.abs(Pn[fluid_mask, 2:]).max():.0f} "
              f"t={time.time()-t0:.0f}s", flush=True)
    print(f"[{tag}] survived {steps} steps", flush=True)
    np.savez(f"/tmp/te_state_{tag}.npz", P=np.asarray(P))
    print(f"[{tag}] state saved to /tmp/te_state_{tag}.npz", flush=True)


if __name__ == "__main__":
    main()
