"""Compare blocked-BC vs generic-BC writes at the runaway-cell ghosts (CPU).

Builds the cut-cell case, then for the ghost cells around the known bad
location prints BOTH paths' static tables (normal, eta, stencil, mirror
gate) and the values each path writes for the saved blow-up state.

    python scripts/cc_diag3.py wall_h=5e-4 block_size=8 feature_h=2.5e-4
"""

import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases.rae2822 import build_rae2822  # noqa: E402


def main():
    kw = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = int(v) if k == "block_size" else float(v)
    kw.setdefault("feature_h", kw.get("wall_h", 1e-2) / 2)
    kw.setdefault("cutcell", 1.0)
    t0 = time.time()
    case = build_rae2822(**kw)
    dom = case.dom
    print(f"cells={dom.ncells} build={time.time()-t0:.0f}s", flush=True)

    centers = np.asarray(dom.centers)
    x0, y0 = 0.39844513, -0.0585556
    j = int(np.argmin(((centers - [x0, y0]) ** 2).sum(1)))
    h = np.asarray(dom.widths)[j, 0]
    watch = np.nonzero((np.abs(centers - centers[j]) < 3.0 * h).all(1))[0]
    wset = set(watch.tolist())

    # ---- generic host boundary tables
    hb = dom._host_boundaries["wall"]
    gmap = {int(g): k for k, g in enumerate(hb.ghosts)}
    # ---- blocked bc tables
    from ibx.topology.blocked_bc import build_blocked_bc
    bbc = build_blocked_bc(dom, ["farfield", "wall"])
    bghost = np.asarray(bbc.ghosts)
    bmap = {int(g): k for k, g in enumerate(bghost)}
    bnrm = np.asarray(bbc.normals)
    beta = np.asarray(bbc.eta)[:, 0]
    g2u = np.asarray(bbc.g2u)

    print(f"bbc: G={bghost.size} n_patch={bbc.n_patch} n_fb={bbc.n_fb}")
    fb_w = np.asarray(bbc.fb_w) if bbc.n_fb else None
    fb_cell = (np.asarray(bbc.fb_cell).reshape(fb_w.shape)
               if bbc.n_fb else None)

    from ibx.cases.rae2822 import build_rae2822 as _  # noqa
    # mirror gate used by the case builder (recompute the same way)
    from ibx.geometry import load_surface, merge_points
    from ibx.geometry.inside import points_inside
    from ibx.cases.rae2822 import RAE_DAT
    stl = merge_points(load_surface(RAE_DAT))
    gc = centers[bghost]
    depth = 2.0 * np.asarray(dom.widths)[bghost].max(axis=1)
    probe = gc - bnrm * depth[:, None]
    gate = points_inside(stl, probe).astype(np.float32)

    for c in sorted(wset):
        kb = bmap.get(c)
        if kb is None:
            continue
        kg = gmap.get(c)
        line = f"ghost {c}: bbc n=({bnrm[kb,0]:+.3f},{bnrm[kb,1]:+.3f}) " \
               f"eta={beta[kb]:.3f} gate={gate[kb]:.0f} fam={np.asarray(bbc.family)[kb]}"
        if kg is not None:
            line += (f" | hb n=({hb.normals[kg,0]:+.3f},{hb.normals[kg,1]:+.3f})"
                     f" eta={hb.ghost_distances[kg]/hb.image_distances[kg]:.3f}")
        u = g2u[kb]
        print(line, flush=True)
        # fallback stencil row for this unique id (if in fallback range)
        n_up = int(bbc.n_patch)
        if fb_cell is not None and u >= n_up:
            r = u - n_up
            live = np.abs(fb_w[r]) > 1e-12
            print(f"    stencil(fb u={u}): cells={fb_cell[r][live]} "
                  f"w={fb_w[r][live]}", flush=True)

    # ---- apply both paths to the saved state and diff at the watch cells
    d = np.load("/tmp/cc_diag_state.npz")
    P = jax.numpy.asarray(d["P"])
    Pb = np.asarray(case.apply_bcs(P))

    # generic path (sequential impose_bc with the same flags)
    from ibx.physics.bc import apply_flow_bc, flow_bc
    from ibx.physics.fluid import make_fluid
    fluid = make_fluid()
    P_inf = case.P_inf
    farfield_bc = flow_bc(fluid, P_inf)
    wall_bc = flow_bc(fluid, [float(P_inf[0]), float(P_inf[1]), 0.0],
                      normal_flow=True)
    _hb = dom._host_boundaries["wall"]
    gc2 = centers[_hb.ghosts]
    depth2 = 2.0 * np.asarray(dom.widths)[_hb.ghosts].max(axis=1)
    probe2 = gc2 - _hb.normals * depth2[:, None]
    mv = jax.numpy.asarray(points_inside(stl, probe2).astype(np.float32))

    Pg = dom.impose_bc("farfield",
                       lambda b, Pi: apply_flow_bc(farfield_bc, Pi, b.normals),
                       P)
    Pg = dom.impose_bc("wall",
                       lambda b, Pi: apply_flow_bc(wall_bc, Pi, b.normals),
                       Pg, mirror_velocity=mv)
    Pg = np.asarray(Pg)

    print("\nstate writes (saved blow-up state):")
    for c in sorted(wset):
        if bmap.get(c) is None:
            continue
        print(f"  {c}: blocked p={Pb[c,0]:9.1f} u=({Pb[c,2]:7.1f},{Pb[c,3]:7.1f})"
              f" | generic p={Pg[c,0]:9.1f} u=({Pg[c,2]:7.1f},{Pg[c,3]:7.1f})",
              flush=True)

    # global max discrepancy over all ghosts
    gall = bghost
    dmax = np.abs(Pb[gall] - Pg[gall]).max(axis=0)
    print(f"\nmax |blocked - generic| over all {gall.size} ghosts: {dmax}")
    bad = np.argsort(-np.abs(Pb[gall] - Pg[gall]).max(axis=1))[:10]
    for k in bad:
        c = gall[k]
        print(f"  ghost {c} x={centers[c]} d={np.abs(Pb[c]-Pg[c]).max():.3e}")


if __name__ == "__main__":
    main()
