"""Flat-plate Cf-deficit diagnosis (round 5): BOTH closures (simplified
WA and capped mixing-length) drift to Cf ~ -25% vs Schultz-Grunow over
30k steps after passing through ~-5% around 6k.  A converged
zero-pressure-gradient plate must satisfy dtheta/dx = Cf/2, so the
momentum-thickness profile discriminates the mechanisms:

  * theta(x) extrapolating to theta(0) >> 0  -> the INFLOW feeds a
    pre-thickened layer (virtual origin upstream; Cf low at matched x);
  * theta(0) ~ 0 but dtheta/dx > Cf/2        -> excess momentum drain
    in the interior (numerical diffusion / closure);
  * theta consistent with its own Cf         -> self-consistent BL that
    simply sits at a larger effective Re_x.

Marches the case, then reports theta(x), the dtheta/dx vs Cf/2 balance,
the near-inflow velocity profile, and Cf(x).

Usage: python scripts/flat_plate_diag.py [steps=30000] [closure=...]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                   # noqa: E402

from ibx.cases.flat_plate import (                           # noqa: E402
    build_flat_plate, cf_schultz_grunow, skin_friction_profile)

CFG = dict(wall_h=1.25e-3, length=1.25, height=0.5, reynolds=5e6,
           mach=0.2, cfl=0.5)


def theta_profile(case, P, stations):
    """Momentum thickness by area-weighted strip integration on the
    octree (strip half-width 0.02)."""
    c = np.asarray(case.dom.centers)
    w = np.asarray(case.dom.widths)
    u = np.asarray(P)[:, 2]
    U = float(case.P_inf[2])
    out = []
    for xs in stations:
        m = (np.abs(c[:, 0] - xs) < 0.02) & (c[:, 1] < 0.1)
        f = np.clip(u[m] / U, 0.0, 1.2)
        th = float((f * (1.0 - f) * w[m, 0] * w[m, 1]).sum() / 0.04)
        out.append(th)
    return np.asarray(out)


def main():
    steps = 30000
    closure = "wray_agarwal"
    for a in sys.argv[1:]:
        k, v = a.split("=")
        if k == "steps":
            steps = int(v)
        elif k == "closure":
            closure = v
        else:
            CFG[k] = float(v)
    case = build_flat_plate(use_blocks=True, closure=closure, **CFG)
    print(f"cells={case.dom.ncells} closure={closure}", flush=True)
    P, Rt = case.P0, case.Rt0
    stations = np.arange(0.1, 1.05, 0.1)
    for i in range(steps // 2000):
        P, Rt = case.march(P, Rt, 2000)
        jax.block_until_ready(P)
        if (i + 1) % 5 == 0 or i == 0:
            th = theta_profile(case, P, stations)
            x, cf = skin_friction_profile(case, np.asarray(P))
            sel = (x > 0.3) & (x < 1.0)
            rel = cf[sel] / cf_schultz_grunow(
                CFG["reynolds"] * x[sel]) - 1.0
            print(f"step {(i+1)*2000}: rel_mean={rel.mean():+.4f} "
                  f"theta={np.array2string(th, precision=5)}", flush=True)

    th = theta_profile(case, P, stations)
    x, cf = skin_friction_profile(case, np.asarray(P))
    # local momentum balance: dtheta/dx vs Cf/2 at interior stations
    dthdx = np.gradient(th, stations)
    cf_at = np.interp(stations, x, cf)
    # linear virtual-origin fit: theta(x) ~ a (x - x0)^0.8 -> quick report
    print(json.dumps({
        "stations": [round(float(s), 2) for s in stations],
        "theta": [round(float(t), 6) for t in th],
        "dtheta_dx": [round(float(t), 6) for t in dthdx],
        "cf_over_2": [round(float(t) / 2, 6) for t in cf_at],
        "theta_sg": [round(float(0.036 * s
                                 * (CFG["reynolds"] * s) ** -0.2), 6)
                     for s in stations],
    }), flush=True)

    # near-inflow profile: u(y)/U in the first strip
    c = np.asarray(case.dom.centers)
    m = (c[:, 0] < 0.04) & (c[:, 1] < 0.05)
    order = np.argsort(c[m, 1])
    ys = c[m, 1][order]
    us = np.asarray(P)[m, 2][order] / float(case.P_inf[2])
    print(json.dumps({"inflow_y": [round(float(y), 5) for y in ys[:25]],
                      "inflow_u": [round(float(v), 4) for v in us[:25]]}),
          flush=True)


if __name__ == "__main__":
    main()
