"""Wall-clock-to-convergence comparison of the solver options (VERDICT #7).

Marches the RAE2822 Euler case with each scheme and reports steps /
residual-evaluations / wall-clock to reach a settled lift coefficient
(|Cl - Cl_final| < tol sustained) and the residual drop achieved. Run on
the GPU.
"""

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822, force_coefficients  # noqa: E402

WALL_H = 1e-2
CHUNK = 250
MAX_STEPS = 12000
TOL = 0.01


def run_explicit(case, tag, steps_per=1, max_steps=MAX_STEPS):
    P = case.P0
    P = case.march(P, 2)
    jax.block_until_ready(P)
    hist = []
    t0 = time.time()
    n = 0
    while n < max_steps:
        P = case.march(P, CHUNK)
        jax.block_until_ready(P)
        n += CHUNK
        cl, cd = force_coefficients(case, np.asarray(P))
        hist.append((n, time.time() - t0, cl, cd))
    return hist, np.asarray(P)


def settle_time(hist, tol=TOL):
    cl_final = hist[-1][2]
    t_settle = None
    for n, t, cl, cd in hist:
        if abs(cl - cl_final) > tol:
            t_settle = None
        elif t_settle is None:
            t_settle = (n, t)
    return cl_final, t_settle


def main():
    rows = []

    for tag, kw, evals_per in [
        ("rk2", dict(scheme="rk2"), 2),
        ("rk2-frozen", dict(scheme="rk2", freeze_gradients=True), 2),
        ("fwd-euler cfl0.4", dict(scheme="euler", cfl=0.4), 1),
    ]:
        kw.setdefault("cfl", 0.7)
        case = build_rae2822(wall_h=WALL_H, feature_h=WALL_H / 2,
                             block_size=16, **kw)
        hist, P = run_explicit(case, tag)
        cl_final, st = settle_time(hist)
        rows.append((tag, case.dom.ncells, st, cl_final,
                     st[0] * evals_per if st else None))
        print(f"{tag}: Cl_final={cl_final:.4f} settle={st} "
              f"(evals={st[0]*evals_per if st else '-'})", flush=True)

    # point-implicit
    from ibx.solve.point_implicit_euler import point_implicit_step
    from ibx.topology.blocks import build_block_tables

    case = build_rae2822(wall_h=WALL_H, feature_h=WALL_H / 2, block_size=16)
    bt = build_block_tables(case.dom)
    from ibx.geometry.inside import points_inside
    inside = points_inside(case.dom.mesh.distance_fields["wall"].stl,
                           case.dom.centers)
    active = jnp.asarray((~inside).astype(np.float32))

    for picfl, nk, nh in [(20.0, 8, 4), (50.0, 12, 4)]:
        @jax.jit
        def pstep(P, key):
            return point_implicit_step(
                bt, case.fluid, P, case.apply_bcs, cfl=picfl,
                active=active, n_krylov=nk, n_hutchinson_samples=nh,
                key=key,
            )[0]

        P = case.P0
        key = jax.random.PRNGKey(0)
        P = pstep(P, key)
        jax.block_until_ready(P)
        hist = []
        t0 = time.time()
        n = 0
        bad = False
        while n < 1500:
            for _ in range(25):
                key, k2 = jax.random.split(key)
                P = pstep(P, k2)
            jax.block_until_ready(P)
            n += 25
            if not np.isfinite(np.asarray(P)).all():
                bad = True
                break
            cl, cd = force_coefficients(case, np.asarray(P))
            hist.append((n, time.time() - t0, cl, cd))
        if bad:
            print(f"point-implicit cfl{picfl}: diverged", flush=True)
            continue
        cl_final, st = settle_time(hist)
        # each implicit step: 1 dt eval + (1 + n_hutch + n_krylov*2) RHS-ish
        rows.append((f"point-implicit cfl{picfl}", case.dom.ncells, st,
                     cl_final, None))
        print(f"point-implicit cfl{picfl}: Cl_final={cl_final:.4f} "
              f"settle={st}", flush=True)

    print(json.dumps([
        dict(scheme=r[0], cells=r[1],
             settle_steps=None if r[2] is None else r[2][0],
             settle_seconds=None if r[2] is None else round(r[2][1], 2),
             cl_final=round(r[3], 4))
        for r in rows
    ], indent=1))


if __name__ == "__main__":
    main()
