"""Run BASELINE workload 5 (3D RANS wing + FAS) on the real chip.

Single-device mesh (multi-chip hardware unavailable; the same code path
is parity-tested on the 8-device virtual mesh). Marches in chunks,
interleaving FAS V-cycles, and reports residuals/timing.

Usage: python scripts/wing3d_run.py [wall_h] [steps] [cycles_every]
"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases.wing3d_rans_fas import build_wing3d_rans_fas  # noqa: E402

WALL_H = float(sys.argv[1]) if len(sys.argv) > 1 else 0.04
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
CYC_EVERY = int(sys.argv[3]) if len(sys.argv) > 3 else 200


def main():
    t0 = time.time()
    case = build_wing3d_rans_fas(1, wall_h=WALL_H, span=1.0, farfield=8.0,
                                 block_size=8)
    n = case.dom.ncells
    print(f"cells={n} build={time.time()-t0:.0f}s", flush=True)
    S = case.S0_sh
    t0 = time.time()
    done = 0
    while done < STEPS:
        S = case.march(S, CYC_EVERY)
        jax.block_until_ready(S)
        done += CYC_EVERY
        S, res = case.fas_cycle(S)
        jax.block_until_ready(S)
        Sn = case.collect(S)
        ok = bool(np.isfinite(Sn).all())
        print(f"step {done} (+1 V-cycle): res={float(res):.3e} finite={ok} "
              f"minp={Sn[:, 0].min():.0f} maxRt={Sn[:, 5].max():.2e} "
              f"t={time.time()-t0:.0f}s", flush=True)
        assert ok
    dt = (time.time() - t0) / done
    print(f"workload-5 march: {dt*1e3:.2f} ms/step+cycles amortized "
          f"({n/dt/1e6:.1f}M cell-updates/s incl. FAS overhead)", flush=True)


if __name__ == "__main__":
    main()
