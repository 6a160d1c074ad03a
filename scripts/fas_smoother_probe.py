"""CPU probe: why does the FasEuler fixed-point smoother blow up?

The 2D FAS verdict harness (fas_verdict2d.py) measured the fine-level
fixed point ``Q += dt*R(Q)`` diverging to the physicality-guard ceiling
at BOTH cfl 0.5 and 0.35 on the subsonic M=0.4 RAE2822 case, while the
production marches (single-stage forward Euler included) are stable at
those CFLs.  Hypothesis: the production march re-projects the carried
state onto the guarded physical manifold every stage
(``s2p_guarded`` -> primitives ARE the state), whereas FasEuler carries
raw conserved Q — the guard only filters the residual evaluation, so
any unphysical excursion (impulsive-start transients at the wall)
compounds in Q instead of being clamped.

Arms: ``raw`` (current _f) vs ``proj`` (_f returns S(Q) - Q with
S = p2s(guard(s2p(Q + dt*R))) — identical to dt*R wherever the state is
physical, equal to the production map elsewhere).

Usage: python scripts/fas_smoother_probe.py [wall_h=2e-2] [cfl=0.35]
"""

import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases.rae2822 import RAE_DAT, build_rae2822            # noqa: E402
from ibx.geometry import load_surface, merge_points             # noqa: E402
from ibx.geometry.inside import points_inside                   # noqa: E402
from ibx.physics import apply_flow_bc, flow_bc                  # noqa: E402
from ibx.physics.fluid import (physicality_guard,               # noqa: E402
                               primitive2state, state2primitive)
from ibx.solve.euler import euler_rhs, local_timestep           # noqa: E402
from ibx.solve.fas_euler import FasEuler                        # noqa: E402

WALL_H = float(sys.argv[1]) if len(sys.argv) > 1 else 2e-2
CFL = float(sys.argv[2]) if len(sys.argv) > 2 else 0.35


def main():
    t0 = time.time()
    case = build_rae2822(wall_h=WALL_H, feature_h=WALL_H / 2, mach=0.4,
                         alpha_deg=2.31, cfl=0.7)
    stl = merge_points(load_surface(RAE_DAT))
    fluid = case.fluid
    P_inf = np.asarray(case.P_inf, np.float32)
    far = flow_bc(fluid, P_inf)
    wall = flow_bc(fluid, [float(P_inf[0]), float(P_inf[1]), 0.0],
                   normal_flow=True)

    def make_bcs(d):
        def apply_bcs(P):
            P = d.impose_bc(
                "farfield",
                lambda b, Pi: apply_flow_bc(far, Pi, b.normals), P)
            P = d.impose_bc(
                "wall",
                lambda b, Pi: apply_flow_bc(wall, Pi, b.normals), P)
            return P
        return apply_bcs

    fe = FasEuler(case.dom, fluid, make_bcs, max_levels=2, cfl=CFL,
                  inside_fn=lambda c: points_inside(stl, c))
    print(f"cells={case.dom.ncells} build={time.time()-t0:.0f}s",
          flush=True)

    def f_proj(level, Q):
        d = fe.domains[level]
        part = d.partitions[0]
        P = physicality_guard(state2primitive(fluid, Q))
        P = fe.bcs[level](P)
        R = euler_rhs(part, fluid, P, high_order=fe.high_order)
        dt = local_timestep(part, fluid, P, fe.cfl)
        if fe.active[level] is not None:
            dt = dt * fe.active[level]
        Qn = primitive2state(fluid, physicality_guard(
            state2primitive(fluid, Q + R * dt[:, None])))
        return Qn - Q, jnp.ones_like(Q)

    from ibx.solve.fas import fas

    fe_rk2 = FasEuler(case.dom, fluid, make_bcs, max_levels=2, cfl=0.7,
                      smoother="rk2",
                      inside_fn=lambda c: points_inside(stl, c))

    for name, f in (("raw", fe._f), ("proj", f_proj),
                    ("rk2map", fe_rk2._f)):
        Q = fe.init_state(case.P0)
        smooth = jax.jit(lambda Q, f=f: fas(f, Q, n_iter=25, rtol=1e-6)[0])
        t0 = time.time()
        for k in range(16):
            Q = smooth(Q)
            r, _ = fe._f(0, Q)
            res = float(jnp.sqrt((r.astype(jnp.float32) ** 2).sum()))
            print(f"[{name}] sweep {k+1:2d} (iters {25*(k+1):4d}): "
                  f"res={res:.4g} maxQ={float(jnp.abs(Q).max()):.3g} "
                  f"t={time.time()-t0:.0f}s", flush=True)
            if not np.isfinite(res) or res > 1e12:
                print(f"[{name}] DIVERGED", flush=True)
                break


if __name__ == "__main__":
    main()
