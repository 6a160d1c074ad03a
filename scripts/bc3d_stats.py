"""Print the BlockedBC table composition for the sphere3d bench case.

Sizing data for the grid-native (row-gather) BC path design: how many
ghosts/unique stencils remain on the general path after the dense-plane
farfield split, how their stencil points decompose into (block, z, y)
x-rows, and how big the touched-block band is.

Run CPU-side:  python scripts/bc3d_stats.py [wall_h=0.03] [block_size=16]
"""

import os
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    kw = dict(wall_h=0.03, cfl=0.5, block_size=16)
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = int(v) if k == "block_size" else float(v)

    from ibx.cases import build_sphere3d

    t0 = time.time()
    case = build_sphere3d(**kw)
    dom = case.dom
    print(f"cells={dom.ncells} build={time.time() - t0:.0f}s", flush=True)

    from ibx.topology.blocked_bc import build_blocked_bc

    bbc = build_blocked_bc(dom, ["farfield", "wall"])
    bs = int(bbc.bs)
    G = int(bbc.ghosts.shape[0])
    print(f"G(general path)={G} n_patch={bbc.n_patch} n_fb={bbc.n_fb} "
          f"fb_width={bbc.fb_width} fb_rows={int(bbc.fb_cell.shape[0])}")
    fam = np.asarray(bbc.family)
    for i, name in enumerate(bbc.names):
        print(f"  family {name}: {int((fam == i).sum())} ghosts")
    print(f"dense groups={len(bbc.dense_spec)} "
          f"dense_cells={sum(float(np.asarray(m).sum()) for m in bbc.dense_mask)}")

    # per-ghost raw tables (pre-dedup view): reconstruct from host boundaries
    fb_cell = np.asarray(bbc.fb_cell).reshape(bbc.n_fb, bbc.fb_width)
    fb_w = np.asarray(bbc.fb_w)
    # drop zero-weight padded points before row decomposition
    rows = fb_cell // bs
    live = np.abs(fb_w) > 0
    nrows = np.zeros(bbc.n_fb, np.int64)
    n_live = live.sum(axis=1)
    for i in range(bbc.n_fb):
        nrows[i] = np.unique(rows[i][live[i]]).size
    hist = np.bincount(nrows, minlength=9)
    print("distinct (b,z,y) x-rows per unique fb stencil:",
          dict(enumerate(hist.tolist())))
    print(f"live points per stencil: mean={n_live.mean():.2f} "
          f"hist={np.bincount(n_live, minlength=9).tolist()}")
    total_rows_padded4 = int(np.sum(np.maximum(nrows, 1).clip(max=4)
                                    + (nrows > 4) * (nrows - 4)))
    print(f"sum distinct rows={int(nrows.sum())} "
          f"(vs flat rows={bbc.n_fb * bbc.fb_width}); "
          f"two-tier(R4/R8) padded rows="
          f"{int((nrows <= 4).sum() * 4 + (nrows > 4).sum() * 8)}")

    # global unique rows + wall-band block count
    urows = np.unique(rows[live])
    ublocks = np.unique(urows // (bs * bs))
    print(f"global unique x-rows touched={urows.size} "
          f"blocks touched={ublocks.size} "
          f"compact band bytes={ublocks.size * bs**3 * 5 * 4 / 1e6:.1f} MB")

    # ghost tiles (write-back side)
    print(f"tiles E={int(bbc.tile_gid.shape[0])} "
          f"T={int(bbc.tile_row.shape[1])} "
          f"ovf={int(bbc.ovf_src.shape[0])}")

    # why do leftover hypercube-family ghosts miss the dense-plane path?
    hb = dom._host_boundaries["farfield"]
    bs_ = bs
    npb = bs_ ** dom.nd
    n_f = hb.normals
    d_ax = np.abs(n_f).argmax(1)
    ar = np.arange(n_f.shape[0])
    unit = np.abs(np.abs(n_f[ar, d_ax]) - 1.0) < 1e-6
    w_f = hb.interp_w
    k2 = (np.abs(w_f[:, 2:]).max(1) == 0.0) if w_f.shape[1] > 2 \
        else np.ones(ar.size, bool)
    g_f = hb.ghosts
    blk_f = g_f // npb
    strides = np.array([bs_ ** k for k in range(dom.nd)], np.int64)
    coords = np.stack([(g_f % npb // strides[k]) % bs_
                       for k in range(dom.nd)], 1)
    i0, i1 = hb.interp_idx[:, 0], hb.interp_idx[:, 1]
    same_blk = (i0 // npb == blk_f) & (i1 // npb == blk_f)
    side = n_f[ar, d_ax] < 0
    cd = coords[ar, d_ax]
    layer = np.where(side, bs_ - 1 - cd, cd)
    print("farfield non-unit normals:", int((~unit).sum()),
          " k>2 stencil:", int((~k2).sum()),
          " cross-block stencil:", int((~same_blk).sum()),
          " layer>=bs/2:", int((layer >= bs_ // 2).sum()))
    ok = unit & k2 & same_blk & (layer < bs_ // 2)
    print("template-stage candidates:", int(ok.sum()), "of", ar.size)
    # distinct (p0,p1,w0) templates among candidates per (d, side)
    c0 = np.stack([(i0 % npb // strides[k]) % bs_ for k in range(dom.nd)], 1)
    p0 = c0[ar, d_ax]
    c1 = np.stack([(i1 % npb // strides[k]) % bs_ for k in range(dom.nd)], 1)
    p1 = c1[ar, d_ax]
    key = (p0.astype(np.int64) * npb + p1) * (1 << 32) \
        + np.ascontiguousarray(w_f[:, 0], np.float32).view(np.uint32)
    for d in range(dom.nd):
        for s in (False, True):
            m = ok & (d_ax == d) & (side == s)
            if not m.sum():
                continue
            vals, cnts = np.unique(key[m], return_counts=True)
            top = np.sort(cnts)[::-1][:6]
            print(f"  face d={d} side={int(s)}: n={int(m.sum())} "
                  f"templates={vals.size} top_counts={top.tolist()}")


if __name__ == "__main__":
    main()
