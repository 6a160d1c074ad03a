"""3D STL-sphere Euler workload (BASELINE.md workload 4).

Octree mesh around a triangulated sphere, ghost-cell immersed boundary,
6-sided farfield, grid-native block fast path — the 3D counterpart of the
RAE2822 flagship (reference capability: 3D STL ingest `src/mesher.jl:124-227`
+ octree `src/mesher.jl:811-862` + the same Domain/operator machinery).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from ..geometry import (
    Stereolitography,
    build_mesh,
    merge_points,
    refine_to_length,
)
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import make_fluid
from ..topology.domain import Domain


def icosphere(radius: float = 0.5, center=(0.0, 0.0, 0.0),
              h: float = 0.35) -> Stereolitography:
    """Icosahedron-subdivision sphere, reprojected to the exact radius."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=np.float32)
    verts /= np.linalg.norm(verts[0])
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    stl = Stereolitography(
        verts * radius + np.asarray(center, np.float32), faces)
    stl = refine_to_length(stl, h * radius)
    c = np.asarray(center, np.float32)
    r = stl.points - c
    stl.points = c + r * (radius / np.linalg.norm(r, axis=1))[:, None]
    return stl


@dataclasses.dataclass
class Sphere3dCase:
    dom: Domain
    fluid: object
    P_inf: np.ndarray
    mach: float
    step: Callable           # jitted (P,) -> (P, resnorm), flat state
    march: Callable          # jitted (P, n_steps) -> P
    P0: jnp.ndarray
    apply_bcs: Callable
    grid: dict = None        # block-path internals (bt, bbc, bc_fns,
    #   active3, apply_bcs3) for building custom steppers


def build_sphere3d(
    *,
    wall_h: float = 0.05,
    farfield: float = 4.0,
    block_size: int = 8,
    mach: float = 0.3,
    cfl: float = 0.7,
    surface_h: float = 0.2,
    high_order: bool = True,
    use_blocks: bool = True,
    verbose: bool = False,
) -> Sphere3dCase:
    stl = merge_points(icosphere(h=surface_h))
    msh = build_mesh(
        [-farfield] * 3, [2 * farfield] * 3,
        ("wall", stl, wall_h),
        block_size=block_size,
    )
    dom = Domain(
        msh,
        verbose=verbose,
        hypercube_families=[(
            "farfield",
            [(0, False), (0, True), (1, False), (1, True),
             (2, False), (2, True)],
        )],
    )

    from ..geometry.inside import points_inside

    inside = points_inside(stl, dom.centers)
    active = jnp.asarray((~inside).astype(np.float32))

    fluid = make_fluid()
    T_inf, p_inf = 288.15, 101325.0
    a = float(np.sqrt(1.4 * 283.0 * T_inf))
    P_inf = np.array([p_inf, T_inf, mach * a, 0.0, 0.0], dtype=np.float32)

    farfield_bc = flow_bc(fluid, P_inf)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True)
    bc_fns = {
        "farfield": lambda Pi, nrm: apply_flow_bc(farfield_bc, Pi, nrm),
        "wall": lambda Pi, nrm: apply_flow_bc(wall_bc, Pi, nrm),
    }
    fb = dom.fused_boundary(["farfield", "wall"])
    from ..physics.fluid import physicality_guard

    def apply_bcs(P):
        return fb(P, bc_fns, guard=physicality_guard)

    if use_blocks:
        from ..ops.block_ops import rk2_step_grid, to_blocks, to_flat
        from ..topology.blocked_bc import build_blocked_bc
        from ..topology.blocks import build_block_tables

        bt = build_block_tables(dom)
        bbc = build_blocked_bc(dom, ["farfield", "wall"])
        active3 = to_blocks(bt, active[:, None])[..., 0]

        def apply_bcs3(P3):
            return bbc(P3, bc_fns, guard=physicality_guard)

        def _grid_step(P3):
            return rk2_step_grid(bt, fluid, P3, apply_bcs3, cfl=cfl,
                                 high_order=high_order, active3=active3)

        def _one_step(P):
            P3, res = _grid_step(to_blocks(bt, P))
            return to_flat(bt, P3), res

        @jax.jit
        def march(P, n_steps):
            def body(_, P3):
                return _grid_step(P3)[0]
            P3 = jax.lax.fori_loop(0, n_steps, body, to_blocks(bt, P))
            return to_flat(bt, P3)
    else:
        from ..solve.euler import rk2_step

        part = dom.partitions[0]

        def _one_step(P):
            return rk2_step(part, fluid, P, apply_bcs, cfl=cfl,
                            high_order=high_order, active=active)

        @jax.jit
        def march(P, n_steps):
            def body(_, P):
                return _one_step(P)[0]
            return jax.lax.fori_loop(0, n_steps, body, P)

    @jax.jit
    def step(P):
        return _one_step(P)

    P0 = np.tile(P_inf, (dom.ncells, 1))
    P0[inside, 2:] = 0.0
    P0 = apply_bcs(jnp.asarray(P0))

    grid = None
    if use_blocks:
        grid = dict(bt=bt, bbc=bbc, bc_fns=bc_fns, active3=active3,
                    apply_bcs3=apply_bcs3)

    return Sphere3dCase(
        dom=dom, fluid=fluid, P_inf=P_inf, mach=mach,
        step=step, march=march, P0=P0, apply_bcs=apply_bcs, grid=grid,
    )
