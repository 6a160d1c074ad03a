"""Zoom on the deterministic cut-cell fine-mesh runaway cell (CPU, offline).

Builds the case on the CPU platform, finds the cell nearest the known bad
location, dumps its static classification (solved / frozen / ghost family /
eta / stencil weights / alpha / incident cut faces and apertures), then
marches in small chunks printing the state of the cell and its neighbors
until it pins.

    python scripts/cc_diag2.py wall_h=5e-4 block_size=8 x=0.39844513 y=-0.0585556
"""

import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822  # noqa: E402


def main():
    kw = {}
    steps, chunk = 200, 10
    x0, y0 = 0.39844513, -0.0585556
    for a in sys.argv[1:]:
        k, v = a.split("=")
        if k in ("steps", "chunk"):
            (steps, chunk) = (int(v), chunk) if k == "steps" else (steps, int(v))
        elif k == "x":
            x0 = float(v)
        elif k == "y":
            y0 = float(v)
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
    print(f"cells={dom.ncells} build={time.time()-t0:.0f}s cfg={kw}", flush=True)

    centers = np.asarray(dom.centers)
    widths = np.asarray(dom.widths)
    j = int(np.argmin(((centers - [x0, y0]) ** 2).sum(1)))
    h = widths[j, 0]
    print(f"target cell {j}: x={centers[j]} h={h:.3e}", flush=True)

    # static classification
    from ibx.ops.block_ops import to_flat
    bt = case.grid["bt"]
    cut = case.grid["cut3"]
    act = np.asarray(to_flat(bt, case.grid["active3"][..., None]))[:, 0]
    al = np.asarray(to_flat(bt, cut["alpha3"][..., None]))[:, 0]
    wc = np.asarray(cut["wall_cells"])
    wcoef = np.asarray(cut["wall_coef"])
    wmap = {int(c): wcoef[i] for i, c in enumerate(wc)}

    # neighborhood: cells within 3h
    r = 3.0 * h
    nb = np.nonzero((np.abs(centers - centers[j]) < r).all(axis=1))[0]
    nbs = set(nb.tolist())
    print(f"neighborhood: {nb.size} cells", flush=True)

    for name, blocks in dom.boundaries.items():
        b = blocks[0]
        g = np.asarray(b.ghost)
        eta = np.asarray(b.eta).reshape(-1)
        w = np.asarray(b.interp.w)
        idx = np.asarray(b.interp.idx)
        for c in nb:
            for k in np.nonzero(g == c)[0]:
                live = np.abs(w[k]) > 1e-12
                print(f"  cell {c} GHOST[{name}] eta={eta[k]:.3f} "
                      f"sum_w={w[k].sum():.3f} sum|w|={np.abs(w[k]).sum():.3f} "
                      f"img_cells={idx[k][live]} w={w[k][live]}", flush=True)

    for c in sorted(nbs, key=lambda c: (centers[c][1], centers[c][0])):
        tag = []
        if not act[c]:
            tag.append("FROZEN")
        if al[c] < 1.0:
            tag.append(f"alpha={al[c]:.4f}")
        if c in wmap:
            tag.append(f"wall_coef*h=({wmap[c][0]*h:+.3f},{wmap[c][1]*h:+.3f})")
        off = (centers[c] - centers[j]) / h
        print(f"  cell {c}: off=({off[0]:+.1f},{off[1]:+.1f})h "
              f"h={widths[c,0]:.2e} {' '.join(tag)}", flush=True)

    # incident cut faces (flux-removal table rows touching the neighborhood)
    for d in range(2):
        o = np.asarray(cut["owner"][d])
        n = np.asarray(cut["neighbor"][d])
        wr = np.asarray(cut["wr"][d])
        wl = np.asarray(cut["wl"][d])
        for k in range(o.size):
            if int(o[k]) in nbs or int(n[k]) in nbs:
                print(f"  cutface dim={d} o={o[k]} n={n[k]} "
                      f"wr={wr[k]:.4f} wl={wl[k]:.4f}", flush=True)

    # face connectivity around j
    fo = np.asarray(dom.face_owner)
    fn = np.asarray(dom.face_neighbor)
    fd = np.asarray(dom.face_dim)
    inc = np.nonzero((fo == j) | (fn == j))[0]
    for k in inc:
        print(f"  face {k} dim={fd[k]} o={fo[k]} n={fn[k]}", flush=True)

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
        print("seeded", flush=True)

    watch = nb[np.argsort(((centers[nb] - centers[j]) ** 2).sum(1))][:9]
    for i in range(steps // chunk):
        P = case.march(P, chunk)
        Pn = np.asarray(P)
        print(f"step {(i+1)*chunk}:", flush=True)
        for c in watch:
            print(f"  {c}: p={Pn[c,0]:9.1f} T={Pn[c,1]:6.1f} "
                  f"u=({Pn[c,2]:8.1f},{Pn[c,3]:8.1f})", flush=True)
        if Pn[j, 0] < 0.05 * float(case.P_inf[0]):
            print("pinned.", flush=True)
            break


if __name__ == "__main__":
    main()
