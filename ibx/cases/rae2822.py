"""RAE2822 transonic airfoil case (the flagship benchmark workload).

Mesh and domain follow the reference's ``test/rae2822.jl`` (Selig ``.dat``
ingest, feature-refined quadtree over a +/-25-chord box, 4-sided farfield
family); the Euler march assembles the README solver recipe. Everything
device-side compiles to a single jitted step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..geometry import DistanceField, build_mesh, feature_regions, load_surface, merge_points
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import make_fluid, primitive2state, speed_of_sound
from ..solve.euler import rk2_step
from ..topology.domain import Domain

RAE_DAT = os.path.join(os.path.dirname(__file__), "data", "rae2822.dat")


@dataclasses.dataclass
class Rae2822Case:
    dom: Domain
    fluid: object
    P_inf: np.ndarray
    mach: float
    alpha: float
    step: Callable          # jitted (P,) -> (P, resnorm)
    march: Callable         # jitted (P, n_steps) -> P   (fori_loop batched)
    P0: jnp.ndarray         # initialized freestream primitives
    apply_bcs: Callable
    march_robust: Optional[Callable] = None   # first-order+Einfeldt march
    #   (fix3 = 1 everywhere): positivity-safe relaxation for rough
    #   startup states, e.g. grid-sequenced transfers
    grid: Optional[dict] = None   # block-path internals (bt, apply_bcs3,
    #   active3, fix3) for building custom steppers on the same domain


def build_rae2822(
    *,
    wall_h: float = 1e-2,
    feature_h: float = 5e-3,
    farfield: float = 25.0,
    block_size: int = 8,
    mach: float = 0.73,
    alpha_deg: float = 2.31,
    cfl: float = 0.8,
    n_partitions: int = 1,
    high_order: bool = True,
    use_blocks: bool = True,
    scheme: str = "rk2",
    freeze_gradients: bool = False,
    irs_eps: float = 0.0,
    te_fix_radius: float = 0.0,
    wall_fix_cells: float = 0.0,
    mirror_wall: bool = False,
    fluid_ghost_ratio: float = None,
    reflect_solid_images: bool = False,
    ghost_layer_ratio: float = 1.5,
    cutcell: bool = False,
) -> Rae2822Case:
    # cut-cell wall (flagged deviation; `ibx.geometry.cutcell`): the wall
    # enters through aperture-weighted fluxes + an explicit wall pressure
    # flux on the true wall geometry. Every fluid cell is SOLVED (no
    # eta-overwritten fluid ghost rows — the fine-mesh circulation-bleed
    # mechanism, BASELINE.md round 3); in-solid ghosts keep sane values via
    # reflected images + mirrored normal velocity.
    if cutcell:
        if not use_blocks or n_partitions != 1:
            raise ValueError("cutcell=True requires the block fast path")
        fluid_ghost_ratio = 0.0
        reflect_solid_images = True
        mirror_wall = True

    stl = merge_points(load_surface(RAE_DAT))
    features = DistanceField(feature_regions(stl, radius=0.05))

    msh = build_mesh(
        [-farfield, -farfield], [2 * farfield, 2 * farfield],
        ("wall", stl, wall_h),
        refinement_regions=[(features, feature_h)],
        block_size=block_size,
    )

    from ..geometry.inside import points_inside
    from ..geometry.octree import get_cells

    _centers, _widths, _ = get_cells(msh)
    inside = points_inside(stl, _centers)

    # cut-cell solved set: every cell with fluid fraction above the floor
    # is marched, INCLUDING center-in-solid cut cells (freezing them would
    # rebuild the staircase wall one row lower; tests/test_cutcell.py)
    _ALPHA_FLOOR = 0.05
    cc_alpha = None
    solve_in = None
    if cutcell:
        from ..geometry.cutcell import fluid_fractions_2d

        cc_alpha = fluid_fractions_2d(
            stl, msh.distance_fields["wall"], _centers, _widths, inside)
        solve_in = inside & (cc_alpha > _ALPHA_FLOOR)

    dom = Domain(
        msh,
        n_partitions=n_partitions,
        hypercube_families=[
            ("farfield", [(0, False), (0, True), (1, False), (1, True)]),
        ],
        fluid_ghost_ratio=fluid_ghost_ratio,
        reflect_solid_images=reflect_solid_images,
        ghost_layer_ratio=ghost_layer_ratio,
        solve_inside_cells=solve_in,
    )

    # freeze cells strictly inside the airfoil (their free evolution — the
    # reference's behavior — diverges at fine resolution and pollutes
    # image-point stencils through the interior ghost band). Under the
    # cut-cell flag, in-solid cells above the fluid-fraction floor are
    # solved instead.
    solved_mask = ~inside if solve_in is None else (~inside | solve_in)
    active = jnp.asarray(solved_mask.astype(np.float32))

    fluid = make_fluid()
    T_inf = 288.15
    p_inf = 101325.0
    a = float(np.sqrt(1.4 * 283.0 * T_inf))
    V = mach * a
    al = np.deg2rad(alpha_deg)
    P_inf = np.array(
        [p_inf, T_inf, V * np.cos(al), V * np.sin(al)], dtype=np.float32
    )

    farfield_bc = flow_bc(fluid, P_inf)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True)

    # mirror_wall (flagged deviation from the reference's eta-blend,
    # src/ImmersedBoundary.jl:1220-1245): reflect the ghost normal velocity
    # (-eta*u_n(image) instead of +eta*u_n(image)). The reference blend
    # makes the wall effectively porous under near-wall vortical flow —
    # the fine-mesh circulation-bleed mechanism (BASELINE.md round 3).
    # Mirroring is gated off where the solid is thinner than ~2 local cell
    # widths along the inward normal (TE sliver: reflecting BOTH surfaces
    # into the wake destabilizes the startup transient).
    _mirror = ("wall",) if mirror_wall else ()

    def _mirror_gate(ghost_ids, normals_g):
        gc = dom.centers[ghost_ids]
        depth = 2.0 * dom.widths[ghost_ids].max(axis=1)
        probe = gc - normals_g * depth[:, None]
        return points_inside(stl, probe).astype(np.float32)

    _mv_seq = False
    if mirror_wall and n_partitions == 1:
        _hb = dom._host_boundaries["wall"]
        _mv_seq = jnp.asarray(_mirror_gate(_hb.ghosts, _hb.normals))

    def apply_bcs_seq(P):
        P = dom.impose_bc(
            "farfield", lambda b, Pi: apply_flow_bc(farfield_bc, Pi, b.normals), P
        )
        P = dom.impose_bc(
            "wall", lambda b, Pi: apply_flow_bc(wall_bc, Pi, b.normals), P,
            mirror_velocity=_mv_seq,
        )
        return P

    if n_partitions == 1:
        # fused BC path: both families through ONE image-interpolation gather
        # and ONE sorted ghost scatter. Families' ghost sets are disjoint
        # (outer box vs wall).
        fb = dom.fused_boundary(["farfield", "wall"])
        bc_fns = {
            "farfield": lambda Pi, nrm: apply_flow_bc(farfield_bc, Pi, nrm),
            "wall": lambda Pi, nrm: apply_flow_bc(wall_bc, Pi, nrm),
        }

        from ..physics.fluid import physicality_guard

        _fb_scale = None
        if mirror_wall:
            _fb_scale = jnp.asarray(_mirror_gate(
                np.asarray(fb.ghost), np.asarray(fb.normals)))

        def apply_bcs(P):
            return fb(P, bc_fns, guard=physicality_guard, mirror=_mirror,
                      mirror_scale=_fb_scale)
    else:
        apply_bcs = apply_bcs_seq

    part = dom.partitions[0]

    if use_blocks and n_partitions == 1:
        # dense block-structured fast path (numerics identical to the
        # generic gather path; see tests/test_block_ops.py). The march
        # state stays a [B, bs, bs, C] block grid end to end (no flat<->block
        # relayouts inside the loop) and ghost BCs go through the run-window
        # BlockedBC.
        from ..ops.block_ops import (
            euler_step_grid, rk2_step_grid, to_blocks, to_flat,
        )
        from ..topology.blocked_bc import build_blocked_bc
        from ..topology.blocks import build_block_tables

        bt = build_block_tables(dom)
        bbc = build_blocked_bc(dom, ["farfield", "wall"])

        from ..physics.fluid import physicality_guard

        _bbc_scale = None
        if mirror_wall:
            _bbc_scale = jnp.asarray(_mirror_gate(
                np.asarray(bbc.ghosts), np.asarray(bbc.normals)))

        def apply_bcs3(P3):
            return bbc(P3, bc_fns, guard=physicality_guard, mirror=_mirror,
                       mirror_scale=_bbc_scale)

        active3 = to_blocks(bt, active[:, None])[..., 0]
        stepper = euler_step_grid if scheme == "euler" else rk2_step_grid

        # trailing-edge robustness blend (VERDICT round-2 item 1): a
        # resolved sharp TE expands to vacuum under the reference's
        # one-sided HLL speeds; within te_fix_radius of the TE the scheme
        # blends to first-order upwind with Einfeldt wave speeds
        # (full fix inside r, tapering to reference numerics at 2 r)
        fix3 = None
        fix_f = np.zeros(dom.ncells, np.float32)
        if te_fix_radius > 0.0:
            te = stl.points[int(np.argmax(stl.points[:, 0]))]
            d_te = np.sqrt(((dom.centers - te[None, :]) ** 2).sum(1))
            fix_f = np.clip((2.0 * te_fix_radius - d_te) / te_fix_radius,
                            0.0, 1.0).astype(np.float32)
        if wall_fix_cells > 0.0:
            # wall-band robustness blend: first-order + Einfeldt within
            # ~wall_fix_cells cell widths of the surface (h-consistent:
            # the band shrinks with refinement, so the formal accuracy of
            # the scheme away from the wall is untouched). Targets the
            # spurious slip-layer vortex shedding the ghost-cell wall BC
            # develops at fine resolution (traveling low-pressure blisters
            # 2-3 cells off the wall; see BASELINE.md round-3 notes).
            band = wall_fix_cells * wall_h
            d_w = np.asarray(DistanceField(stl)(dom.centers), np.float64)
            fw = np.clip((2.0 * band - d_w) / band, 0.0, 1.0)
            fix_f = np.maximum(fix_f, fw.astype(np.float32))
        if fix_f.any():
            fix3 = to_blocks(bt, jnp.asarray(fix_f)[:, None])

        cut3 = None
        if cutcell:
            from ..geometry.cutcell import cut_metrics_2d

            cm = cut_metrics_2d(
                stl, msh.distance_fields["wall"], dom.centers, dom.widths,
                solved_mask, dom.face_dim, dom.face_owner,
                dom.face_neighbor, alpha=cc_alpha,
                alpha_floor=_ALPHA_FLOOR,
            )
            cut3 = dict(
                owner=tuple(jnp.asarray(o) for o in cm["owner"]),
                neighbor=tuple(jnp.asarray(n) for n in cm["neighbor"]),
                wr=tuple(jnp.asarray(w) for w in cm["wr"]),
                wl=tuple(jnp.asarray(w) for w in cm["wl"]),
                wall_cells=jnp.asarray(cm["wall_cells"]),
                wall_coef=jnp.asarray(cm["wall_coef"]),
                xw_rel=jnp.asarray(cm["xw_rel"]),
                inv_alpha3=to_blocks(
                    bt, jnp.asarray(cm["inv_alpha"])[:, None]),
                alpha3=to_blocks(bt, jnp.asarray(cm["alpha"])[:, None])[..., 0],
            )

        def _grid_step(P3):
            kw = {}
            if scheme != "euler":
                kw["freeze_gradients"] = freeze_gradients
                kw["irs_eps"] = irs_eps
            return stepper(bt, fluid, P3, apply_bcs3, cfl=cfl,
                           high_order=high_order, active3=active3,
                           fix3=fix3, cut3=cut3, **kw)

        def _one_step(P):
            P3, res = _grid_step(to_blocks(bt, P))
            return to_flat(bt, P3), res

        @jax.jit
        def march(P, n_steps):
            def body(_, P3):
                return _grid_step(P3)[0]
            P3 = jax.lax.fori_loop(0, n_steps, body, to_blocks(bt, P))
            return to_flat(bt, P3)

        fix_ones3 = jnp.ones(active3.shape + (1,), jnp.float32)

        @jax.jit
        def march_robust(P, n_steps):
            def body(_, P3):
                return rk2_step_grid(bt, fluid, P3, apply_bcs3, cfl=cfl,
                                     high_order=high_order, active3=active3,
                                     fix3=fix_ones3, cut3=cut3)[0]
            P3 = jax.lax.fori_loop(0, n_steps, body, to_blocks(bt, P))
            return to_flat(bt, P3)
    else:
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
    P0[~solved_mask, 2:] = 0.0      # stagnant solid interior (frozen)
    P0 = apply_bcs(jnp.asarray(P0))

    blocks_on = use_blocks and n_partitions == 1
    return Rae2822Case(
        dom=dom, fluid=fluid, P_inf=P_inf, mach=mach, alpha=alpha_deg,
        step=step, march=march, P0=P0, apply_bcs=apply_bcs,
        march_robust=march_robust if blocks_on else None,
        grid=(dict(bt=bt, apply_bcs3=apply_bcs3, active3=active3,
                   fix3=fix3, cut3=cut3 if cutcell else None)
              if blocks_on else None),
    )


def wall_cp(case: Rae2822Case, P) -> np.ndarray:
    """Pressure coefficient sampled at the wall surface points."""
    from ..physics.fluid import pressure_coefficient

    surf = case.dom.surfaces["wall"]
    p_wall = np.asarray(surf(P[:, 0]))
    return np.asarray(
        pressure_coefficient(case.fluid, p_wall, float(case.P_inf[0]),
                             case.mach)
    )


def force_coefficients(case: Rae2822Case, P):
    """(Cl, Cd) from the wall-sampled pressure (chord = 1)."""
    from ..topology.domain import surface_integral

    surf = case.dom.surfaces["wall"]
    cp = wall_cp(case, P)
    # outward (into-fluid) unit normals scaled by panel areas
    f = -cp[:, None] * surf.normals * surf.areas[:, None]
    F = f.sum(axis=0)
    al = np.deg2rad(case.alpha)
    drag = F[0] * np.cos(al) + F[1] * np.sin(al)
    lift = -F[0] * np.sin(al) + F[1] * np.cos(al)
    return float(lift), float(drag)
