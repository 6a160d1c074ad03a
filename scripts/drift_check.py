"""Drift check: restart each committed RAE2822 oracle level from its
stored converged state, march one full limit-cycle window, and report the
cycle-averaged wall-Cp reproduction error (the same assertion as
tests/test_rae2822_regression.py::test_rae2822_cp_drift_from_converged,
runnable on the real chip for the levels too big for the CPU tier —
VERDICT r3 item 4).

Usage: python scripts/drift_check.py [tags...]   (default: xfine flagship)
"""

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases import build_rae2822, wall_cp          # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data")


def check(tag):
    ref = np.load(os.path.join(DATA, f"rae2822_cp_{tag}.npz"))
    meta = json.loads(str(ref["meta"]))
    t0 = time.time()
    case = build_rae2822(wall_h=meta["wall_h"], feature_h=meta["feature_h"],
                         cfl=meta.get("cfl", 0.7),
                         block_size=meta.get("block_size") or 8)
    print(f"[{tag}] cells={case.dom.ncells} build={time.time()-t0:.0f}s",
          flush=True)
    stride = int(meta.get("phase_stride", 500))
    n_phase = ref["cp_phases"].shape[0]
    P = case.apply_bcs(jnp.asarray(ref["P"]))
    cps = []
    t0 = time.time()
    for _ in range(n_phase):
        P = case.march(P, stride)
        jax.block_until_ready(P)
        cps.append(wall_cp(case, np.asarray(P)))
    d = np.abs(np.stack(cps).mean(axis=0) - ref["cp_phases"].mean(axis=0))
    print(f"[{tag}] drift over {n_phase}x{stride} steps "
          f"({time.time()-t0:.0f}s): mean |dCp| = {d.mean():.2e}, "
          f"max = {d.max():.2e}", flush=True)
    return d.mean(), d.max()


# Steady levels take the <1e-3 band outright; levels with a residual
# shock cycle (medium, flagship) take the cycling band (same split as
# tests/test_rae2822_regression.py). Measured (round 4): fine
# 5.9e-5 / xfine 2.9e-5 / flagship 3.7e-3.
BAND = {"coarse": 5e-3, "medium": 5e-3, "flagship": 5e-3}


def main():
    tags = sys.argv[1:] or ["xfine", "flagship"]
    results = {t: check(t) for t in tags}
    failed = [t for t, (m, _) in results.items()
              if m >= BAND.get(t, 1e-3)]
    print("RESULTS", json.dumps({t: dict(mean=float(m), max=float(x))
                                 for t, (m, x) in results.items()}))
    if failed:
        print(f"FAILED (mean over band): {failed}")
        return 1
    print("OK: all levels reproduce within their cycle-mean |dCp| bands")
    return 0


if __name__ == "__main__":
    sys.exit(main())
