"""Benchmark: Euler pseudo-time march throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}; value is
cell-updates/s of the case's jitted fori_loop march, timed to
block_until_ready after a compiling warm-up call. Fails (non-zero exit, no
result) without a GPU, and raises on any failed phase.

IBX_BENCH_CASE=rae2822 (default: 2D flagship, BASELINE workload 2, plus the
same case on the 1-device sharded runtime and the 3D sphere) or sphere3d
(workload 4 alone). IBX_BENCH_WALL_H / IBX_BENCH_STEPS /
IBX_BENCH_BLOCK_SIZE size the workload.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

import jax


def _march_rate(march, P, n_cells: int, steps: int):
    """(cell-updates/s, march seconds, final state) of ``march(P, steps)``
    after a 2-step compiling warm-up."""
    P = jax.block_until_ready(march(P, 2))
    t0 = time.perf_counter()
    P = jax.block_until_ready(march(P, steps))
    elapsed = time.perf_counter() - t0
    return n_cells * steps / elapsed, elapsed, P


def _check_finite(P, what: str):
    if not bool(np.isfinite(np.asarray(P)).all()):
        raise FloatingPointError(f"non-finite {what} state")


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (platform {dev.platform!r})", file=sys.stderr)
        sys.exit(2)
    from ibx.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()),
              "nvidia_smi": smi.strip().replace("\n", " | ")}

    which = os.environ.get("IBX_BENCH_CASE", "rae2822")
    steps = int(os.environ.get("IBX_BENCH_STEPS", "300"))
    block_size = int(os.environ.get("IBX_BENCH_BLOCK_SIZE", "16"))

    t0 = time.perf_counter()
    if which == "sphere3d":
        from ibx.cases import build_sphere3d

        wall_h = float(os.environ.get("IBX_BENCH_WALL_H", "0.03"))
        case = build_sphere3d(wall_h=wall_h, cfl=0.5, block_size=block_size)
    else:
        from ibx.cases import build_rae2822

        wall_h = float(os.environ.get("IBX_BENCH_WALL_H", "5e-4"))
        case = build_rae2822(wall_h=wall_h, feature_h=wall_h / 2, cfl=0.5,
                             block_size=block_size)
    build_s = time.perf_counter() - t0
    n = case.dom.ncells
    cups, elapsed, P = _march_rate(case.march, case.P0, n, steps)
    _check_finite(P, which)
    tag = ""

    if which == "rae2822":
        # the same case on the 1-device-mesh shard_map runtime (halo
        # exchange and interior/frontier overlap included)
        from ibx.cases.rae2822_block_sharded import (
            build_rae2822_block_sharded)

        sbd, _, P0_sh, _ = build_rae2822_block_sharded(
            1, cfl=0.5, case=case, overlap=True)
        sh_cups, sh_el, Ps = _march_rate(sbd.march, P0_sh, n, steps)
        _check_finite(sbd.collect(Ps), "sharded 2D")
        tag += (f", sharded_1dev={sh_cups / 1e6:.1f}M"
                f" ({(sh_el / elapsed - 1) * 100:+.1f}%)")

        # the 3D sphere at its benchmark size (5.3M cells, bs=16)
        from ibx.cases import build_sphere3d

        t0 = time.perf_counter()
        c3 = build_sphere3d(wall_h=0.03, cfl=0.5, block_size=16)
        b3 = time.perf_counter() - t0
        cups3, _, P3 = _march_rate(c3.march, c3.P0, c3.dom.ncells, steps)
        _check_finite(P3, "3D")
        tag += (f", sphere3d={cups3 / 1e6:.1f}M"
                f" (cells={c3.dom.ncells}, bs=16, build={b3:.0f}s)")

    print(json.dumps({
        "metric": f"{which}_euler_cell_updates_per_sec",
        "value": cups,
        "unit": (f"cell-updates/s (cells={n}, steps={steps}, "
                 f"march={elapsed:.3f}s, build={build_s:.1f}s{tag})"),
        "device": device,
    }))


if __name__ == "__main__":
    main()
