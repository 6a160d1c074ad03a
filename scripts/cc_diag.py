"""Localize the cut-cell fine-mesh (wall_h<=1e-3) blow-up.

Builds the RAE2822 cut-cell case, seeds from a coarser saved state,
marches in short chunks, and at the first sign of trouble (pressure-floor
pinning) reports WHERE the pinned cells are and how they relate to the
cut tables (alpha, wall_coef, apertures, 2:1 cut faces, TE distance).

    python scripts/cc_diag.py wall_h=5e-4 chunk=100 steps=2000 \
        seed_npz=/tmp/te_state_cc_5.npz seed_wall_h=5e-3 ...
"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822, force_coefficients  # noqa: E402


def main():
    kw = {}
    steps, chunk = 2000, 100
    for a in sys.argv[1:]:
        k, v = a.split("=")
        if k in ("steps", "chunk"):
            (steps, chunk) = (int(v), chunk) if k == "steps" else (steps, int(v))
        elif k in ("block_size",):
            kw[k] = int(v)
        elif k in ("seed_npz",):
            kw[k] = v
        else:
            kw[k] = float(v)
    seed_npz = kw.pop("seed_npz", None)
    seed_kw = {k[5:]: kw.pop(k) for k in list(kw) if k.startswith("seed_")}
    if "block_size" in seed_kw:
        seed_kw["block_size"] = int(seed_kw["block_size"])
    kw.setdefault("feature_h", kw.get("wall_h", 1e-2) / 2)
    kw.setdefault("cutcell", 1.0)
    t0 = time.time()
    case = build_rae2822(**kw)
    dom = case.dom
    print(f"cells={dom.ncells} build={time.time()-t0:.0f}s cfg={kw}",
          flush=True)

    # ---- static cut-table report ---------------------------------------
    from ibx.ops.block_ops import to_flat
    cut = case.grid["cut3"]
    bt = case.grid["bt"]
    al = np.asarray(to_flat(bt, cut["alpha3"][..., None]))[:, 0]
    wc = np.asarray(cut["wall_cells"])
    wcoef = np.asarray(cut["wall_coef"])
    centers = np.asarray(dom.centers)
    widths = np.asarray(dom.widths)
    solved_cut = al < 1.0
    print(f"cut cells (alpha<1): {int(solved_cut.sum())}, "
          f"min alpha={al.min():.4f}, wall_cells={wc.size}", flush=True)
    wnorm = np.sqrt((wcoef ** 2).sum(1)) * widths[wc, 0]  # |S|/V * h ~ O(1)
    print(f"|wall_coef|*h: max={wnorm.max():.3f} "
          f"p99={np.percentile(wnorm, 99):.3f}", flush=True)
    for d in range(dom.nd):
        wr = np.asarray(cut["wr"][d]); wl = np.asarray(cut["wl"][d])
        print(f"dim {d}: cut faces={wr.size}, "
              f"max wr={wr.max() if wr.size else 0:.3f} "
              f"max wl={wl.max() if wl.size else 0:.3f}", flush=True)

    P = case.P0
    if seed_npz is not None:
        from ibx.solve.interp_util import idw_interpolator
        from ibx.ops.stencil import apply_stencil
        seed_kw.setdefault("feature_h", seed_kw.get("wall_h", 1e-2) / 2)
        sc = build_rae2822(**seed_kw)
        Ps = np.load(seed_npz)["P"]
        st = jax.device_put(idw_interpolator(sc.dom.centers, dom.centers))
        P = case.apply_bcs(apply_stencil(st, jax.numpy.asarray(Ps)))
        del sc, st
        print("seeded (NO robust startup — watching the raw transient)",
              flush=True)

    p_inf = float(case.P_inf[0])
    t0 = time.time()
    for i in range(steps // chunk):
        P = case.march(P, chunk)
        jax.block_until_ready(P)
        Pn = np.asarray(P)
        bad = ~np.isfinite(Pn).any(axis=1) | (Pn[:, 0] < 0.02 * p_inf)
        nb = int(bad.sum())
        cl, cd = force_coefficients(case, Pn)
        print(f"step {(i+1)*chunk}: Cl={cl:.4f} bad={nb} "
              f"minp={np.nanmin(Pn[:, 0]):.1f} t={time.time()-t0:.0f}s",
              flush=True)
        if nb:
            idx = np.nonzero(bad)[0]
            x = centers[idx]
            h = widths[idx, 0]
            in_cut = np.isin(idx, np.nonzero(solved_cut)[0])
            in_wc = np.isin(idx, wc)
            # distance to TE (1, ~0) of the unit-chord RAE2822
            dte = np.sqrt(((x - np.array([1.0, 0.0])[None]) ** 2).sum(1))
            print(f"  bad cells: n={nb}  cut={int(in_cut.sum())} "
                  f"wall={int(in_wc.sum())}", flush=True)
            print(f"  x range {x[:, 0].min():.4f}..{x[:, 0].max():.4f}  "
                  f"y range {x[:, 1].min():.4f}..{x[:, 1].max():.4f}",
                  flush=True)
            print(f"  h: {h.min():.2e}..{h.max():.2e}  "
                  f"min dist to TE: {dte.min():.4f}", flush=True)
            alb = al[idx[in_cut]] if in_cut.any() else np.array([1.0])
            print(f"  alpha of bad cut cells: {alb.min():.3f}.."
                  f"{alb.max():.3f}", flush=True)
            # first few, fully
            for j in idx[:8]:
                print(f"    cell {j}: x={centers[j]} h={widths[j, 0]:.1e} "
                      f"alpha={al[j]:.3f} p={Pn[j, 0]:.1f}", flush=True)
            np.savez("/tmp/cc_diag_state.npz", P=Pn, bad=idx)
            print("  state dumped to /tmp/cc_diag_state.npz", flush=True)
            return
    print("no blow-up within the budget", flush=True)
    np.savez("/tmp/cc_diag_state.npz", P=np.asarray(P))


if __name__ == "__main__":
    main()
