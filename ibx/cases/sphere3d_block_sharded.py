"""Sharded BLOCK fast-path 3D STL-sphere Euler step (multi-device leg of
BASELINE workload 4).

Same numerics as the single-device 3D fast path (`ibx.cases.sphere3d`),
executed as one shard_map over a 1-D device mesh with the per-device
`BlockedBC` fast paths — the 3D counterpart of
`ibx.cases.rae2822_block_sharded`. Parity enforced by
tests/test_block_sharding.py::test_sharded_sphere3d_matches_single_device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..parallel import make_device_mesh
from ..parallel.block_sharding import ShardedBlockDomain
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import (
    physicality_guard,
    primitive2state,
    state2primitive_guarded,
)
from ..ops.block_ops import euler_rhs_grid
from .sphere3d import build_sphere3d


def build_sphere3d_block_sharded(
    n_devices: int,
    *,
    wall_h: float = 0.1,
    cfl: float = 0.7,
    high_order: bool = True,
    case=None,
    **kwargs,
):
    """Returns (sharded_block_domain, jitted step, sharded P0, case).

    ``case`` reuses a prebuilt single-device case (the sharded step
    re-derives its BCs from the case's domain), so the topology is not
    built twice.
    """
    if case is None:
        case = build_sphere3d(
            wall_h=wall_h, cfl=cfl, high_order=high_order, **kwargs,
        )
    mesh = make_device_mesh(n_devices)
    sbd = ShardedBlockDomain(case.dom, mesh,
                             bc_names=["farfield", "wall"])

    fluid = case.fluid
    p_inf, T_inf = float(case.P_inf[0]), float(case.P_inf[1])
    farfield_bc = flow_bc(fluid, case.P_inf)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True)
    bc_fns = {
        "farfield": lambda Pi, nrm: apply_flow_bc(farfield_bc, Pi, nrm),
        "wall": lambda Pi, nrm: apply_flow_bc(wall_bc, Pi, nrm),
    }

    from ..geometry.inside import points_inside

    inside = points_inside(case.dom.mesh.distance_fields["wall"].stl,
                           case.dom.centers)
    active = (~inside).astype(np.float32)[:, None]

    active_sh = sbd.distribute(active, pad_mode="zero")[..., 0]

    def sharded_step(ctx, P_own, active_own):
        def bcs(own):
            # per-device BlockedBC (dense-plane + dedup fast paths)
            return ctx.own(ctx.bbc(ctx.exchange(own), bc_fns,
                                   guard=physicality_guard))

        loc = ctx.exchange(P_own)
        R0, dt3, _ = euler_rhs_grid(ctx.bt, fluid, loc, with_dt=True,
                                    cfl=cfl, high_order=high_order)
        R0 = ctx.own(R0)
        dt3 = ctx.own(dt3)
        dt = jnp.where(active_own > 0, dt3, 0.0)[..., None]
        Q0 = primitive2state(fluid, P_own)
        P1 = bcs(state2primitive_guarded(fluid, Q0 + dt * R0))
        R1 = ctx.own(euler_rhs_grid(ctx.bt, fluid, ctx.exchange(P1),
                                    high_order=high_order))
        P2 = bcs(state2primitive_guarded(fluid,
                                         Q0 + dt * (R0 + R1) / 2))
        resnorm = ctx.pmax(jnp.abs(R0[..., 0] * active_own).max())
        return P2, resnorm

    raw = sbd.shard_fn(sharded_step)
    P0_sh = sbd.distribute(np.asarray(case.P0))

    @jax.jit
    def step(P_sh):
        P2, res = raw(P_sh, active_sh)
        return P2, res[0]

    @jax.jit
    def march(P_sh, n_steps):
        def body(_, P_sh):
            return raw(P_sh, active_sh)[0]
        return jax.lax.fori_loop(0, n_steps, body, P_sh)

    sbd.march = march
    return sbd, step, P0_sh, case
