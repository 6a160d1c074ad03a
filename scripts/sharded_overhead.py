"""Measure the sharded block path's overhead on ONE real chip (VERDICT
round-2 item 9): the 1-device-mesh shard_map march vs the unsharded grid
march on the identical flagship case. Gives the x8 pod extrapolation at
least one measured factor (halo bookkeeping + shard_map dispatch cost;
the ppermute itself is a self-copy at 1 device).

Usage: python scripts/sharded_overhead.py [wall_h] [steps] [overlap]
"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822  # noqa: E402
from ibx.cases.rae2822_block_sharded import build_rae2822_block_sharded  # noqa: E402

WALL_H = float(sys.argv[1]) if len(sys.argv) > 1 else 5e-4
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 300
OVERLAP = len(sys.argv) > 3 and sys.argv[3] not in ("0", "false")


def timed_march(march, P, steps):
    P = march(P, 2)
    jax.block_until_ready(P)
    t0 = time.time()
    P = march(P, steps)
    jax.block_until_ready(P)
    return (time.time() - t0) / steps, P


def main():
    t0 = time.time()
    case = build_rae2822(wall_h=WALL_H, feature_h=WALL_H / 2, cfl=0.5,
                         block_size=16)
    n = case.dom.ncells
    print(f"cells={n} build={time.time()-t0:.0f}s", flush=True)

    dt_single, P = timed_march(case.march, case.P0, STEPS)
    print(f"unsharded: {dt_single*1e3:.3f} ms/step "
          f"({n/dt_single/1e6:.1f}M cell-updates/s)", flush=True)

    sbd, step, P0_sh, _ = build_rae2822_block_sharded(
        1, cfl=0.5, overlap=OVERLAP, case=case)
    dt_sh, P_sh = timed_march(sbd.march, P0_sh, STEPS)
    print(f"sharded(1-device mesh, overlap={OVERLAP}): "
          f"{dt_sh*1e3:.3f} ms/step ({n/dt_sh/1e6:.1f}M cell-updates/s)",
          flush=True)
    print(f"overhead: {(dt_sh/dt_single - 1.0)*100:.1f}%", flush=True)
    assert np.isfinite(np.asarray(P)).all()


if __name__ == "__main__":
    main()
