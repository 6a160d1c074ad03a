"""Independent lift anchor: linear-strength vortex panel method on the
committed RAE2822 coordinates (Kuethe & Chow ch. 5 / Katz & Plotkin ch.
11 textbook scheme) + compressibility corrections.

Gives the incompressible inviscid Cl at the case's alpha and the
Prandtl-Glauert / Karman-Tsien corrected estimates at M = 0.73 — an
external sanity anchor for the converged Euler oracles (the transonic
Euler solution with a shock is not exactly PG-correctable, but the
corrected panel value brackets the expected magnitude; AGARD AR-138
Case 9 measured Cl = 0.803 VISCOUS at these conditions, and inviscid
solutions sit above that).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def panel_cl(xy: np.ndarray, alpha_deg: float, n_panels: int = 200) -> float:
    """Lumped-vortex (discrete-vortex thin-airfoil) method on the camber
    line (Katz & Plotkin ch. 11.1.1): vortex at each panel quarter-chord,
    collocation at three-quarter-chord, flow tangency at collocation.
    Thickness is neglected (thin-airfoil theory: Cl is camber+alpha
    driven; RAE2822's 12% thickness adds only a few % through
    second-order effects).

    xy: Selig loop (TE -> upper -> LE -> lower -> TE).
    """
    pts = np.asarray(xy, np.float64)
    ile = int(np.argmin(pts[:, 0]))
    up = pts[: ile + 1][::-1]          # LE -> TE along upper
    lo = pts[ile:]                     # LE -> TE along lower
    xg = np.linspace(pts[:, 0].min(), pts[:, 0].max(), n_panels + 1)
    yu = np.interp(xg, up[:, 0], up[:, 1])
    yl = np.interp(xg, lo[:, 0], lo[:, 1])
    yc = 0.5 * (yu + yl)

    dx = np.diff(xg)
    dyc = np.diff(yc)
    # panel frame: vortex at 1/4 panel, collocation at 3/4 panel
    xv = xg[:-1] + 0.25 * dx
    yv = yc[:-1] + 0.25 * dyc
    xc = xg[:-1] + 0.75 * dx
    ycoll = yc[:-1] + 0.75 * dyc
    slope = dyc / dx
    nx = -slope / np.hypot(1.0, slope)
    ny = 1.0 / np.hypot(1.0, slope)

    # induced velocity at collocation i from unit vortex j (2D point
    # vortex, positive Gamma = clockwise so lift is positive upward)
    rx = xc[:, None] - xv[None, :]
    ry = ycoll[:, None] - yv[None, :]
    r2 = rx ** 2 + ry ** 2
    u = ry / (2 * np.pi * r2)
    w = -rx / (2 * np.pi * r2)
    A = u * nx[:, None] + w * ny[:, None]
    al = np.deg2rad(alpha_deg)
    rhs = -(np.cos(al) * nx + np.sin(al) * ny)
    gam = np.linalg.solve(A, rhs)
    chord = xg[-1] - xg[0]
    return 2.0 * gam.sum() / chord


def main():
    from ibx.cases.rae2822 import RAE_DAT

    xy = np.loadtxt(RAE_DAT)
    alpha = float(sys.argv[1]) if len(sys.argv) > 1 else 2.31
    mach = float(sys.argv[2]) if len(sys.argv) > 2 else 0.73
    cl0 = panel_cl(xy, alpha)
    beta = np.sqrt(1.0 - mach ** 2)
    cl_pg = cl0 / beta
    cl_kt = cl0 / (beta + mach ** 2 / (1 + beta) * cl0 / 2)
    print(f"alpha={alpha} deg  M={mach}")
    print(f"incompressible panel Cl        = {cl0:.4f}")
    print(f"Prandtl-Glauert corrected      = {cl_pg:.4f}")
    print(f"Karman-Tsien corrected         = {cl_kt:.4f}")
    print("AGARD AR-138 Case 9 experiment (viscous, Re 6.5e6): Cl = 0.803")


if __name__ == "__main__":
    main()
