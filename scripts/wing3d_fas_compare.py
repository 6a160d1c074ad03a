"""Workload-5 FAS-vs-RK2 comparison with the solved-cell functional
(round 5): does the 2-level V-cycle (sharded fine smoothing, replicated
coarse correction) accelerate the 3D RANS wing's convergence?

Arms from the same freestream start:
  rk2:  N plain sharded RK2 steps
  fas:  the same march with a V-cycle every `every` steps (each cycle =
        pre-smooth + coarse tau-corrected relaxation + correction +
        post-smooth)

Reports L2(dt*R over solved cells) vs steps and vs wall-clock (wall
clock noted: host may be loaded; the per-step/per-cycle counts are the
controlled variables).

Usage: python scripts/wing3d_fas_compare.py [steps=6000] [every=200]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                  # noqa: E402

from ibx.cases.wing3d_rans_fas import build_wing3d_rans_fas  # noqa: E402

WALL_H = 0.08   # workload-5 default


def main():
    steps = 6000
    every = 200
    arms = ("rk2", "fas")
    global WALL_H
    for a in sys.argv[1:]:
        k, v = a.split("=")
        if k == "steps":
            steps = int(v)
        elif k == "every":
            every = int(v)
        elif k == "arms":
            arms = tuple(v.split(","))
        elif k == "wall_h":
            WALL_H = float(v)
    t0 = time.time()
    wc = build_wing3d_rans_fas(1, wall_h=WALL_H)
    print(f"cells={wc.dom.ncells} build={time.time()-t0:.0f}s", flush=True)

    chunk = min(every, 500)

    def run(name, use_fas):
        S = wc.S0_sh
        t0 = time.time()
        curve = []
        done = 0
        while done < steps:
            S = wc.march(S, chunk)
            done += chunk
            if use_fas and done % every == 0:
                S, _ = wc.fas_cycle(S)
            l2, _ = wc.res_norms(S)
            jax.block_until_ready(S)
            curve.append((done, float(l2), time.time() - t0))
        print(json.dumps({"arm": name,
                          "curve": [[c[0], round(c[1], 2), round(c[2], 1)]
                                    for c in curve[::4]] + [list(map(
                                        lambda x: round(x, 2), curve[-1]))]}),
              flush=True)
        return curve

    out = {}
    if "rk2" in arms:
        c = run("rk2", False)
        out["final_L2_rk2"] = c[-1][1]
        out["wall_rk2_s"] = round(c[-1][2], 1)
    if "fas" in arms:
        c = run("fas", True)
        out["final_L2_fas"] = c[-1][1]
        out["wall_fas_s"] = round(c[-1][2], 1)
    if "final_L2_rk2" in out and "final_L2_fas" in out:
        out["ratio"] = round(
            out["final_L2_rk2"] / max(out["final_L2_fas"], 1e-30), 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
