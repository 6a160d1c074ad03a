"""Circulation-budget diagnostic for the fine-mesh lift decay.

Loads saved fine-mesh states and answers: where does the circulation go?
  * Gamma(r): line integral of u around circles of growing radius —
    distinguishes "circulation shed into the wake" (Gamma recovers with r)
    from "circulation destroyed at the wall" (low at all r).
  * wall transpiration: integral of rho u·n over the surface, cumulative
    in x — a non-zero net mass flux through the IB wall is a BC leak.
  * vorticity by region — where the vortical structures live.

CPU-only analysis (no march).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

from ibx.cases import build_rae2822, force_coefficients, wall_cp  # noqa: E402
from ibx.ops import operators as ops  # noqa: E402


def main():
    state_file = sys.argv[1]
    cfg = dict(wall_h=5e-4, feature_h=2.5e-4, block_size=16, cfl=0.6)
    for a in sys.argv[2:]:
        k, v = a.split("=")
        cfg[k] = int(v) if k == "block_size" else float(v)
    cfg.setdefault("feature_h", cfg["wall_h"] / 2)
    case = build_rae2822(**cfg)
    dom = case.dom
    P = np.load(state_file)["P"]
    assert P.shape[0] == dom.ncells, (P.shape, dom.ncells)
    cl, cd = force_coefficients(case, P)
    print(f"state={state_file} Cl={cl:.4f} Cd={cd:.5f}")

    # ---- Cp vs the committed medium oracle (shape diagnosis) ----
    import os
    ref_path = os.path.join("tests", "data", "rae2822_cp_medium.npz")
    if os.path.exists(ref_path):
        ref = np.load(ref_path)
        surf0 = case.dom.surfaces["wall"]
        cp = wall_cp(case, P)
        for side, sel, rsel in (
            ("upper", surf0.points[:, 1] > 0, ref["y"] > 0),
            ("lower", surf0.points[:, 1] <= 0, ref["y"] <= 0),
        ):
            x_c = surf0.points[sel, 0]
            o = np.argsort(x_c)
            x_c, cp_c = x_c[o], cp[sel][o]
            x_r = ref["x"][rsel]
            orr = np.argsort(x_r)
            x_r, cp_r = x_r[orr], ref["cp"][rsel][orr]
            cp_ri = np.interp(x_c, x_r, cp_r)
            d = cp_c - cp_ri
            # shock = steepest adverse dCp/dx on the upper side
            def shock_x(x, v):
                m = (x > 0.3) & (x < 0.9)
                if m.sum() < 4:
                    return float("nan")
                g = np.gradient(v[m], x[m])
                return float(x[m][np.argmax(g)])
            print(f"  Cp[{side}]: mean d={d.mean():+.4f} max|d|="
                  f"{np.abs(d).max():.3f} "
                  f"shock_x case={shock_x(x_c, cp_c):.3f} "
                  f"ref={shock_x(x_r, cp_r):.3f}")
            for lo, hi in [(0, .1), (.1, .3), (.3, .55), (.55, .75),
                           (.75, .95), (.95, 1.01)]:
                m = (x_c >= lo) & (x_c < hi)
                if m.any():
                    print(f"    x[{lo},{hi}): cp_case={cp_c[m].mean():+.3f} "
                          f"cp_ref={cp_ri[m].mean():+.3f}")

    c = np.asarray(dom.centers)
    tree = cKDTree(c)
    V_inf = float(np.sqrt((case.P_inf[2:] ** 2).sum()))

    # ---- Gamma(r) around the quarter-chord ----
    for r in (0.55, 0.8, 1.2, 2.0, 4.0, 8.0):
        M = max(256, int(2 * np.pi * r / 2e-3))
        th = np.linspace(0, 2 * np.pi, M, endpoint=False)
        pts = np.stack([0.5 + r * np.cos(th), r * np.sin(th)], axis=1)
        _, ii = tree.query(pts)
        u = P[ii, 2:4]
        t = np.stack([-np.sin(th), np.cos(th)], axis=1)
        gamma = (u * t).sum(axis=1).mean() * 2 * np.pi * r
        cl_g = -2.0 * gamma / V_inf     # Kutta-Joukowski, unit chord
        print(f"  Gamma(r={r:4.2f}) = {gamma:8.3f}  -> Cl_KJ = {cl_g:.4f}")

    # ---- wall transpiration ----
    surf = dom.surfaces["wall"]
    Pw = np.asarray(surf.at_offset(jnp.asarray(P)))
    n = surf.normals
    rho = Pw[:, 0] / (283.0 * np.maximum(Pw[:, 1], 10.0))
    un = (Pw[:, 2:] * n).sum(axis=1)
    ds = surf.areas
    rho_inf = float(case.P_inf[0]) / (283.0 * float(case.P_inf[1]))
    mdot = rho * un * ds
    print(f"  net transpiration: {mdot.sum():.4e} kg/s/span "
          f"(|scale| {np.abs(mdot).sum():.4e}; freestream rho*V*c = "
          f"{rho_inf * V_inf:.1f})")
    x = surf.points[:, 0]
    for lo, hi in [(0, .2), (.2, .5), (.5, .8), (.8, .95), (.95, 1.01)]:
        m = (x >= lo) & (x < hi)
        up = m & (surf.points[:, 1] > 0)
        dn = m & ~up
        print(f"    x[{lo},{hi}): mdot_up={mdot[up].sum():.3e} "
              f"mdot_dn={mdot[dn].sum():.3e} "
              f"max|un|={np.abs(un[m]).max():5.1f} m/s")

    # ---- vorticity by region ----
    part = dom.partitions[0]
    g = ops.cell_gradient(part, jnp.asarray(P[:, 2:4]))
    omega = np.asarray(g[0][:, 1] - g[1][:, 0])   # dv/dx - du/dy
    w = np.asarray(dom.widths)
    circ_cell = omega * w[:, 0] * w[:, 1]
    from ibx.geometry import DistanceField, load_surface, merge_points
    from ibx.cases.rae2822 import RAE_DAT
    stl = merge_points(load_surface(RAE_DAT))
    d_w = np.asarray(DistanceField(stl)(c))
    regions = {
        "wall<2mm": d_w < 2e-3,
        "wall<10mm": (d_w >= 2e-3) & (d_w < 1e-2),
        "wake x>1, |y|<.3": (c[:, 0] > 1.0) & (c[:, 0] < 6) & (np.abs(c[:, 1]) < 0.3) & (d_w >= 1e-2),
        "elsewhere": (d_w >= 1e-2) & ~((c[:, 0] > 1.0) & (c[:, 0] < 6) & (np.abs(c[:, 1]) < 0.3)),
    }
    for name, m in regions.items():
        print(f"  {name:22s}: sum(omega dA)={circ_cell[m].sum():8.3f} "
              f"sum|omega dA|={np.abs(circ_cell[m]).sum():8.3f} "
              f"max|omega|={np.abs(omega[m]).max():9.1f}")


if __name__ == "__main__":
    main()
