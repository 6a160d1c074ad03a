"""FAS diagnosis (round 5, VERDICT r4 item 2): WHY does the coarse-grid
correction not pay on these workloads?

Three quantitative probes on the subsonic RAE2822 harness case (the same
configuration as scripts/fas_verdict2d.py):

1. **Smoothing factor vs frequency** of the production rk2-map fixed
   point: perturb a warm state with (a) white per-cell noise (high-
   frequency-rich) and (b) a smooth domain-scale mode (low-frequency),
   and measure the per-iteration damping of each perturbation under the
   smoother, g = (||d_n|| / ||d_0||)^(1/n) with d_k = S^k(Q+d) - S^k(Q).
   Multigrid pays only if g_high << g_low (the smoother kills what the
   coarse grid cannot represent); g_high ~ g_low means the map is not a
   *smoother* in the multigrid sense — it is a wave-propagation relaxation
   whose convergence is transit-limited, and the coarse correction
   addresses the same error components the fine level already handles.

2. **Coarse-transfer content**: ||coarsen(d)|| / ||d|| for both modes —
   how much of each error class the coarse level can even see (IDW
   restriction, `solve/mgrid.py`).

3. **Cycle cost ratio**: wall-clock of one 2-level `cycle()` vs one
   `smooth_only()` at equal n_iter — the break-even factor a perfect
   coarse correction would have to beat.

CPU-friendly (small case); prints one JSON line per probe.
Usage: python scripts/fas_diagnosis.py [wall_h=2e-2] [warm_steps=2000]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os                                                   # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

# fas_verdict2d parses sys.argv at import time; shield it
_argv, sys.argv = sys.argv, sys.argv[:1]
import fas_verdict2d as fv                                  # noqa: E402
from fas_verdict2d import build_case, build_fe              # noqa: E402
sys.argv = _argv


def norm(d):
    return float(jnp.sqrt((d.astype(jnp.float32) ** 2).sum()))


def main():
    wall_h = float(sys.argv[1].split("=")[-1]) if len(sys.argv) > 1 else 2e-2
    warm_steps = (int(sys.argv[2].split("=")[-1])
                  if len(sys.argv) > 2 else 2000)
    fv.WALL_H = wall_h

    case = build_case()
    fe = build_fe(case, 2)
    print(f"cells={case.dom.ncells}", flush=True)

    # warm state: production march into the nonlinear regime
    Pw = case.march(case.P0, warm_steps)
    jax.block_until_ready(Pw)
    Qw = fe.init_state(Pw)

    smooth = jax.jit(lambda Q: fe.smooth_only(Q, n_iter=1, rtol=0.0)[0])
    cycle = jax.jit(lambda Q: fe.cycle(Q, n_iter=25, rtol=1e-9)[0])
    smooth25 = jax.jit(lambda Q: fe.smooth_only(Q, n_iter=25, rtol=0.0)[0])

    # ---- probe 1: per-mode damping --------------------------------------
    c = np.asarray(case.dom.centers)
    scale = np.abs(np.asarray(Qw)).mean(axis=0) + 1e-30
    rng = np.random.default_rng(0)
    eps = 1e-4

    modes = {
        "high_white": rng.standard_normal(np.asarray(Qw).shape),
        "low_smooth": (np.sin(np.pi * (c[:, 0] - c[:, 0].min())
                              / (np.ptp(c[:, 0]) + 1e-30))
                       * np.sin(np.pi * (c[:, 1] - c[:, 1].min())
                                / (np.ptp(c[:, 1]) + 1e-30)))[:, None]
        * np.ones((1, np.asarray(Qw).shape[1])),
    }
    n_it = 10
    base = [Qw]
    for _ in range(n_it):
        base.append(smooth(base[-1]))
    jax.block_until_ready(base[-1])

    out = {"probe": "damping", "n_iter": n_it, "eps": eps}
    for name, m in modes.items():
        d0 = jnp.asarray(eps * m * scale[None, :], jnp.float32)
        Q = Qw + d0
        n0 = norm(d0)
        traj = []
        for k in range(n_it):
            Q = smooth(Q)
            traj.append(norm(Q - base[k + 1]) / n0)
        g = traj[-1] ** (1.0 / n_it)
        out[f"g_{name}"] = round(g, 4)
        out[f"decay_{name}"] = [round(t, 4) for t in traj]
    print(json.dumps(out), flush=True)

    # ---- probe 2: coarse-transfer content -------------------------------
    coarsen = fe.coarseners[0]
    out2 = {"probe": "coarse_transfer"}
    for name, m in modes.items():
        d0 = jnp.asarray(m * scale[None, :], jnp.float32)
        out2[f"restrict_ratio_{name}"] = round(
            norm(coarsen(d0)) / (norm(d0) + 1e-30), 4)
    print(json.dumps(out2), flush=True)

    # ---- probe 3: cycle cost ratio --------------------------------------
    Q = cycle(Qw)
    jax.block_until_ready(Q)
    Q = smooth25(Qw)
    jax.block_until_ready(Q)
    t0 = time.time()
    for _ in range(5):
        Q = cycle(Qw)
    jax.block_until_ready(Q)
    t_cyc = (time.time() - t0) / 5
    t0 = time.time()
    for _ in range(5):
        Q = smooth25(Qw)
    jax.block_until_ready(Q)
    t_sm = (time.time() - t0) / 5
    print(json.dumps({"probe": "cost", "t_cycle_s": round(t_cyc, 4),
                      "t_smooth25_s": round(t_sm, 4),
                      "ratio": round(t_cyc / t_sm, 3)}), flush=True)


if __name__ == "__main__":
    main()
