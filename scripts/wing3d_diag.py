"""Diagnose the wing3d residual plateau (workload 5): where does the
flat L2(dt*R) live?  Loads the committed 20k-step state, evaluates the
per-cell pseudo-time update, and reports per-channel norms plus the
spatial location of the dominant cells (tip caps / TE / wall band /
farfield) and a wall-distance histogram.

Usage: python scripts/wing3d_diag.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from ibx.cases.wing3d_rans_fas import build_wing3d_rans_fas  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                    "wing3d_oracle.npz")


def main():
    d = np.load(DATA)
    S = d["S"]
    wc = build_wing3d_rans_fas(1)
    print(f"cells={wc.dom.ncells}", flush=True)
    assert S.shape[0] == wc.dom.ncells

    S_sh = wc.sbd.distribute(S)
    r_sh = wc.res_field(S_sh)
    jax.block_until_ready(r_sh)
    # collect: [P, chunk, bs,bs,bs, C] -> [N, C]
    r = np.asarray(r_sh)
    C = r.shape[-1]
    r = r.reshape(-1, C)[: wc.dom.ncells]

    # drop vs the freestream init, SOLVED-cell functional
    r0 = np.asarray(wc.res_field(wc.S0_sh)).reshape(-1, C)[: wc.dom.ncells]
    l2_0 = float(np.sqrt((r0.astype(np.float64) ** 2).sum()))
    l2_s = float(np.sqrt((r.astype(np.float64) ** 2).sum()))
    print(json.dumps({"L2_solved_init": l2_0, "L2_solved_20k": l2_s,
                      "drop": l2_0 / max(l2_s, 1e-30)}), flush=True)

    ch_l2 = np.sqrt((r.astype(np.float64) ** 2).sum(axis=0))
    print(json.dumps({"per_channel_L2": [float(x) for x in ch_l2],
                      "channels": ["rho", "E", "rhou", "rhov", "rhow",
                                   "Rt"]}), flush=True)

    mag = np.abs(r).max(axis=1)
    c = np.asarray(wc.dom.centers)
    w = np.asarray(wc.dom.widths)
    stl = wc.dom.mesh.distance_fields["wall"].stl
    span_lo, span_hi = stl.points[:, 2].min(), stl.points[:, 2].max()
    order = np.argsort(-mag)[:30]
    print("top-30 cells by |dtR|:")
    for i in order:
        print(f"  {mag[i]:.3e} at ({c[i,0]:+.3f}, {c[i,1]:+.3f}, "
              f"{c[i,2]:+.3f}) h={w[i,0]:.3f}", flush=True)

    from ibx.geometry import DistanceField
    df = wc.dom.mesh.distance_fields["wall"]
    dwall = np.asarray(df(c))
    qs = [0, 0.12, 0.3, 0.6, 1.2, 2.5, 100.0]
    tot = float((mag.astype(np.float64) ** 2).sum())
    rows = {}
    for lo, hi in zip(qs[:-1], qs[1:]):
        m = (dwall >= lo) & (dwall < hi)
        rows[f"d[{lo},{hi})"] = round(
            float((mag[m].astype(np.float64) ** 2).sum()) / tot, 4)
    # tip bands: within 1.5 wall_h of either span end plane of the wing,
    # and near the surface
    near = dwall < 0.35
    tip = near & ((np.abs(c[:, 2] - span_lo) < 0.12)
                  | (np.abs(c[:, 2] - span_hi) < 0.12))
    te = near & (c[:, 0] > 0.9) & (np.abs(c[:, 1]) < 0.2)
    rows["tip_band"] = round(
        float((mag[tip].astype(np.float64) ** 2).sum()) / tot, 4)
    rows["te_band"] = round(
        float((mag[te].astype(np.float64) ** 2).sum()) / tot, 4)
    print(json.dumps({"energy_fractions": rows}), flush=True)


if __name__ == "__main__":
    main()
