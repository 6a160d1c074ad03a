"""Closure-level flat-plate check (VERDICT round-3 item 5): solve the SAME
simplified Wray-Agarwal + log-law wall-function closure as a parabolic
incompressible boundary-layer march in pure numpy, on the same first-cell
height as the ibx RANS case, and compare Cf(x) against Schultz-Grunow and
against the committed ibx profile (tests/data/flat_plate_cf.npz).

If this independent discretization reproduces the ibx result's offset
from the correlation, the offset is a property of the CLOSURE (the
reference's simplified WA, ``src/turbulence.jl:222-241``, + log-law wall
function, ``src/turbulence.jl:27-98``), not of the ibx implementation.

Equations (boundary-layer form):
    u u_x + v u_y = d/dy[(nu + R) u_y]
    u R_x + v R_y = d/dy[(nu + sigma_R R) R_y]
                    + min(C1 R S + C2 R_y S_y R / S, 10 R),   S = |u_y|
    v_y = -u_x
Wall model at the first cell center y1 (same `wall_function`): the wall
diffusive flux is tau_w/rho = u_tau(u1, y1)^2; R's wall value is the wall
units' nu_t.  Cf = 2 u_tau^2 / U^2.

CPU-only; runs in ~a minute.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# numpy reimplementation of ibx.physics.turbulence.wall_function (kept
# dependency-free so this script is a truly independent check)
KAPPA, CVK, AVD = 0.41, 4.9, 19.0


def wall_units(Rey, n_iter=40):
    Rey = np.maximum(np.abs(Rey), 1e-12)
    y_plus = np.sqrt(Rey)
    for _ in range(n_iter):
        u_plus = np.minimum(np.log(np.maximum(y_plus, 1.0)) / KAPPA + CVK,
                            y_plus)
        y_plus = 0.5 * (Rey / u_plus) + 0.5 * y_plus
    u_plus = Rey / y_plus
    mu_plus = KAPPA * y_plus * (1.0 - np.exp(-y_plus / AVD)) ** 2
    return y_plus, u_plus, mu_plus


def march(wall_h=1.25e-3, U=68.06, nu=68.06 / 5e6, H=0.06, L=1.25,
          dx=5e-4, sigma_R=0.72, C1=0.0829):
    C2 = sigma_R + C1 / KAPPA ** 2
    ny = int(round(H / wall_h))
    y = (np.arange(ny) + 0.5) * wall_h
    dy = wall_h

    # start turbulent from the leading edge: log-law guess at x0
    x0 = 5e-3
    Re_x0 = U * x0 / nu
    cf0 = 0.0592 * Re_x0 ** -0.2
    ut0 = U * np.sqrt(cf0 / 2)
    delta0 = 0.37 * x0 * Re_x0 ** -0.2
    yp = y * ut0 / nu
    u = np.minimum(ut0 * (np.log(np.maximum(yp, 1.0)) / KAPPA + CVK), U)
    u[y > delta0] = U
    R = np.minimum(KAPPA * ut0 * y, 0.09 * delta0 * ut0)
    R[y > delta0] = 3.0 * nu

    def tridiag(a, b, c, d):
        n = b.size
        cp = np.empty(n)
        dp = np.empty(n)
        cp[0] = c[0] / b[0]
        dp[0] = d[0] / b[0]
        for i in range(1, n):
            m = b[i] - a[i] * cp[i - 1]
            cp[i] = c[i] / m
            dp[i] = (d[i] - a[i] * dp[i - 1]) / m
        xs = np.empty(n)
        xs[-1] = dp[-1]
        for i in range(n - 2, -1, -1):
            xs[i] = dp[i] - cp[i] * xs[i + 1]
        return xs

    xs_out, cf_out = [], []
    x = x0
    u_prev = u.copy()
    while x < L:
        # wall model from the first cell center
        _, u_plus, mu_plus1 = wall_units(u[0] * y[0] / nu)
        u_tau = u[0] / u_plus
        tau_w = u_tau ** 2
        R_wall = float(mu_plus1 * nu)

        # v from continuity (u_x from the previous step)
        ux = (u - u_prev) / dx if x > x0 else np.zeros_like(u)
        v = -np.cumsum(ux) * dy
        u_prev = u.copy()

        # momentum: implicit y-diffusion, upwind v-advection
        nu_eff = nu + np.maximum(R, 0.0)
        nu_f = 0.5 * (nu_eff[:-1] + nu_eff[1:])       # faces 1..ny-1
        a = np.zeros(ny)
        b = np.zeros(ny)
        c = np.zeros(ny)
        d = np.zeros(ny)
        for j in range(ny):
            lo = nu_f[j - 1] / dy ** 2 if j > 0 else 0.0
            hi = nu_f[j] / dy ** 2 if j < ny - 1 else 0.0
            conv = u[j] / dx
            a[j] = -lo
            c[j] = -hi
            b[j] = conv + lo + hi
            d[j] = conv * u[j]
            vj = v[j]
            if vj > 0 and j > 0:
                b[j] += vj / dy
                a[j] -= vj / dy
            elif vj < 0 and j < ny - 1:
                b[j] -= vj / dy
                c[j] += vj / dy
        # wall flux closes the first cell: +tau_w/dy into the balance
        d[0] -= tau_w / dy
        # top: freestream
        b[-1] = 1.0
        a[-1] = 0.0
        c[-1] = 0.0
        d[-1] = U
        u = tridiag(a, b, c, d)

        # WA transport: implicit diffusion, explicit source
        S = np.abs(np.gradient(u, dy))
        Ry = np.gradient(R, dy)
        Sy = np.gradient(S, dy)
        src = np.minimum(C1 * R * S + C2 * Ry * Sy * R / (S + 1e-12),
                         10.0 * R)
        nuR = nu + sigma_R * np.maximum(R, 0.0)
        nuRf = 0.5 * (nuR[:-1] + nuR[1:])
        for j in range(ny):
            lo = nuRf[j - 1] / dy ** 2 if j > 0 else 0.0
            hi = nuRf[j] / dy ** 2 if j < ny - 1 else 0.0
            conv = max(u[j], 0.1 * U) / dx
            a[j] = -lo
            c[j] = -hi
            b[j] = conv + lo + hi
            d[j] = conv * R[j] + src[j]
            vj = v[j]
            if vj > 0 and j > 0:
                b[j] += vj / dy
                a[j] -= vj / dy
            elif vj < 0 and j < ny - 1:
                b[j] -= vj / dy
                c[j] += vj / dy
        # wall value of R through the wall-model ghost (Dirichlet-ish
        # closure of the first face, matching the ibx wall_fn Rt ghost)
        d[0] += nuRf[0] / dy ** 2 * 0.0  # first face handled by lo=0 above
        b[0] += (nu + sigma_R * max(R[0], 0.0)) / dy ** 2
        d[0] += (nu + sigma_R * max(R[0], 0.0)) / dy ** 2 * R_wall
        b[-1] = 1.0
        a[-1] = 0.0
        c[-1] = 0.0
        d[-1] = 3.0 * nu
        R = np.maximum(tridiag(a, b, c, d), 0.0)

        x += dx
        xs_out.append(x)
        cf_out.append(2.0 * tau_w / U ** 2)

    return np.asarray(xs_out), np.asarray(cf_out)


def main():
    wall_h = float(sys.argv[1]) if len(sys.argv) > 1 else 1.25e-3
    U = 0.2 * float(np.sqrt(1.4 * 283.0 * 288.15))
    nu = U / 5e6
    x, cf = march(wall_h=wall_h, U=U, nu=nu)
    sel = (x > 0.3) & (x < 1.0)
    re_x = 5e6 * x
    sg = 0.370 * np.log10(re_x) ** -2.584
    pr = 0.0592 * re_x ** -0.2
    rel_sg = cf[sel] / sg[sel] - 1.0
    rel_pr = cf[sel] / pr[sel] - 1.0
    print(f"ODE closure march (wall_h={wall_h}, y1+ ~ "
          f"{0.5 * wall_h * U * np.sqrt(0.0017 / 2) / nu:.0f}):")
    print(f"  Cf/SchultzGrunow - 1: mean {rel_sg.mean():+.3f} "
          f"range [{rel_sg.min():+.3f}, {rel_sg.max():+.3f}]")
    print(f"  Cf/Prandtl       - 1: mean {rel_pr.mean():+.3f} "
          f"range [{rel_pr.min():+.3f}, {rel_pr.max():+.3f}]")
    path = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                        "flat_plate_cf.npz")
    if os.path.exists(path):
        d = np.load(path)
        xi, cfi = d["x"], d["cf"]
        ci = np.interp(x[sel], xi, cfi)
        r = ci / cf[sel]
        print(f"  ibx / ODE ratio over stations: mean {r.mean():.3f} "
              f"std {r.std():.3f}")


if __name__ == "__main__":
    main()
