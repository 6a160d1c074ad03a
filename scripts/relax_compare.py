"""Wall-clock-to-convergence comparison of solver options from a
grid-sequenced near-converged state (VERDICT round-2 item 5).

The implicit/IRS schemes were judged on cold transonic starts in round 2
(where the shock-forming transient favors plain TVD-RK2); production
marches start from a sequenced coarser solution, and THAT relaxation
phase is where stronger smoothers should pay. Usage:

    python scripts/relax_compare.py [schemes...]

Runs on the GPU. Schemes: rk2, euler, rk2_frozen, irs, pi, pi_frozen.
"""


import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822, force_coefficients  # noqa: E402
from ibx.ops import block_ops as bops  # noqa: E402
from ibx.solve.interp_util import idw_interpolator  # noqa: E402
from ibx.ops.stencil import apply_stencil  # noqa: E402

WALL_H = 1e-2       # medium level: converged Cl band known (0.855-0.865)
SEED_H = 2e-2       # coarse seed
STEPS = 6000
CHUNK = 500


def build_seed(case_to):
    seed = build_rae2822(wall_h=SEED_H, feature_h=SEED_H / 2, cfl=0.7)
    Ps = seed.P0
    for _ in range(10):
        Ps = seed.march(Ps, 2000)
    jax.block_until_ready(Ps)
    cl, cd = force_coefficients(seed, np.asarray(Ps))
    print(f"seed (wall_h={SEED_H}) Cl={cl:.4f}", flush=True)
    st = jax.device_put(idw_interpolator(
        seed.dom.centers, case_to.dom.centers))
    P = case_to.apply_bcs(apply_stencil(st, jnp.asarray(Ps)))
    P = case_to.march_robust(P, 500)
    jax.block_until_ready(P)
    return P


def main():
    which = sys.argv[1:] or ["rk2", "euler", "rk2_frozen", "irs",
                             "pi", "pi_frozen"]
    case = build_rae2822(wall_h=WALL_H, feature_h=WALL_H / 2, cfl=0.7)
    g = case.grid
    bt, apply_bcs3, active3 = g["bt"], g["apply_bcs3"], g["active3"]
    fluid = case.fluid
    P_seed = build_seed(case)
    cl0, _ = force_coefficients(case, np.asarray(P_seed))
    print(f"seeded start Cl={cl0:.4f} cells={case.dom.ncells}", flush=True)

    def make_march(stepper):
        @jax.jit
        def march(P, n):
            def body(_, P3):
                return stepper(P3)[0]
            P3 = jax.lax.fori_loop(0, n, body, bops.to_blocks(bt, P))
            return bops.to_flat(bt, P3)
        return march

    def rk2(P3, **kw):
        return bops.rk2_step_grid(bt, fluid, P3, apply_bcs3, cfl=0.7,
                                  active3=active3, **kw)

    def euler1(P3):
        return bops.euler_step_grid(bt, fluid, P3, apply_bcs3, cfl=0.4,
                                    active3=active3)

    schemes = {
        "rk2": make_march(lambda P3: rk2(P3)),
        "euler": make_march(euler1),
        "rk2_frozen": make_march(lambda P3: rk2(P3, freeze_gradients=True)),
        "irs": make_march(lambda P3: bops.rk2_step_grid(
            bt, fluid, P3, apply_bcs3, cfl=1.3, active3=active3,
            irs_eps=0.5)),
    }

    from ibx.solve.point_implicit_euler import point_implicit_step

    active_flat = bops.to_flat(bt, active3[..., None])[:, 0]

    def make_pi(freeze):
        @jax.jit
        def pi_march(P, n):
            def body(_, P):
                P1, _ = point_implicit_step(
                    bt, fluid, P, case.apply_bcs, cfl=20.0,
                    active=active_flat, relax=0.8,
                    freeze_limiter=freeze)
                return P1
            return jax.lax.fori_loop(0, n, body, P)
        return pi_march

    schemes["pi"] = make_pi(False)
    schemes["pi_frozen"] = make_pi(True)
    # implicit steps are ~10x costlier; match wall-clock not step count
    steps_of = {"pi": STEPS // 10, "pi_frozen": STEPS // 10}
    chunk_of = {"pi": CHUNK // 10, "pi_frozen": CHUNK // 10}

    for name in which:
        march = schemes[name]
        P = P_seed
        t0 = time.time()
        n_steps = steps_of.get(name, STEPS)
        ch = chunk_of.get(name, CHUNK)
        rows = []
        for i in range(n_steps // ch):
            P = march(P, ch)
            jax.block_until_ready(P)
            cl, cd = force_coefficients(case, np.asarray(P))
            rows.append((time.time() - t0, (i + 1) * ch, cl, cd))
        ok = all(np.isfinite(np.asarray(P)).all() for _ in [0])
        print(f"[{name}] finite={ok}")
        for t, s, cl, cd in rows:
            print(f"  [{name}] t={t:6.1f}s step={s:5d} Cl={cl:.4f} "
                  f"Cd={cd:.5f}", flush=True)


if __name__ == "__main__":
    main()
