"""Smoke run of ibx's main path on one NVIDIA GPU.

    python chip_smoke.py            # phases (a)-(c) on one GPU
    python chip_smoke.py --multi    # phase (d) only, on four GPUs

(a) device: a GPU is required (no CPU fallback); prints its kind, the
    device count and ``nvidia-smi``'s name and power limit.
(b) 2D RAE2822 Euler flagship (881,152 cells) and (c) 3D sphere (5,308,416
    cells), each built by its ``build_*`` case at the benchmark size and
    marched with ``case.march``; one RK2 step of the block fast path
    (``case.step``) is then compared with the plain generic gather path
    (`ibx.solve.euler.rk2_step` on ``dom.partitions[0]``) from the marched
    state.
(d) ``--multi``: a ppermute/psum check over four devices, then the
    block-sharded runtime on them against the single-device ``case.step``,
    for both cases. Each compile and device step runs under a watchdog
    that dumps the stacks and exits if it hangs.

Each phase prints one line; the last line is one JSON object naming the
device. Exits non-zero if any phase fails or no GPU is found.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
import jax.numpy as jnp

from ibx.utils.compile_cache import enable_compile_cache

# state parity, max over cells of |out - ref| / max|ref| per channel. Both
# sides are float32 on the device with different summation orders; 1e-4 is
# the level the sharded parity tests hold on the shocked flagship.
STEP_TOL = 1e-4
PRECISION = "float32 state; device-side products at Precision.HIGHEST"

FLAGSHIP_2D = dict(wall_h=5e-4, feature_h=2.5e-4, cfl=0.5, block_size=16)
SPHERE_3D = dict(wall_h=0.03, cfl=0.5, block_size=16)


_T0 = time.perf_counter()


def progress(msg: str) -> None:
    """Stage marker on stderr, so a run cut by its time limit shows where
    it stood."""
    print(f"[{time.perf_counter() - _T0:8.1f} s] {msg}", file=sys.stderr,
          flush=True)


def scaled_err(out, ref) -> float:
    """Max error scaled by each channel's max |ref|."""
    out, ref = np.asarray(out), np.asarray(ref)
    scale = np.abs(ref).max(axis=0)
    scale = np.where(scale > 0, scale, 1.0)
    return float((np.abs(out - ref) / scale).max())


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _active_flat(case):
    from ibx.ops.block_ops import to_flat

    g = case.grid
    return to_flat(g["bt"], g["active3"][..., None])[:, 0]


def run_case(build, kw: dict, steps: int, tol: float = STEP_TOL) -> dict:
    """Build, compile and march one case; compare one block-path RK2 step
    with the generic gather path from the marched state."""
    from ibx.solve.euler import rk2_step

    t0 = time.perf_counter()
    case = build(**kw)
    build_s = time.perf_counter() - t0
    progress(f"built {case.dom.ncells} cells")

    t0 = time.perf_counter()
    march = case.march.lower(case.P0, steps).compile()
    compile_s = time.perf_counter() - t0
    progress("march compiled")
    t0 = time.perf_counter()
    P = jax.block_until_ready(march(case.P0, steps))
    march_s = time.perf_counter() - t0
    progress("marched")
    finite = bool(np.isfinite(np.asarray(P)).all())
    peak_march = peak_bytes()

    ref_step = jax.jit(lambda P, part, active: rk2_step(
        part, case.fluid, P, case.apply_bcs, cfl=kw["cfl"],
        active=active)[0])
    out = np.asarray(case.step(P)[0])
    ref = np.asarray(ref_step(P, case.dom.partitions[0], _active_flat(case)))
    err = scaled_err(out, ref)
    ok = finite and bool(np.isfinite(out).all()) and err <= tol
    return dict(
        ok=ok, cells=int(case.dom.ncells), steps=steps,
        build_s=build_s, compile_s=compile_s, march_s=march_s,
        cell_updates_per_s=case.dom.ncells * steps / march_s,
        finite=finite, peak_bytes_march=peak_march,
        peak_bytes=peak_bytes(), step_err=err, tol=tol,
        precision=PRECISION,
    )


def phase_2d(steps: int = 300, **overrides) -> dict:
    from ibx.cases import build_rae2822

    return run_case(build_rae2822, {**FLAGSHIP_2D, **overrides}, steps)


def phase_3d(steps: int = 300, **overrides) -> dict:
    from ibx.cases import build_sphere3d

    return run_case(build_sphere3d, {**SPHERE_3D, **overrides}, steps)


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Dump every thread's stack and exit non-zero if ``what`` outlasts
    ``seconds``: a collective that never returns would otherwise hold the
    cards until the caller's time limit. Not reentrant."""
    progress(f"{what} (watchdog {seconds:.0f} s)")
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def collective_check(mesh) -> dict:
    """One ring ppermute and one psum over ``mesh``, against numpy."""
    from jax.sharding import PartitionSpec

    n = int(mesh.devices.size)
    ring = [(i, (i + 1) % n) for i in range(n)]
    f = jax.jit(jax.shard_map(
        lambda a: jax.lax.ppermute(a, "p", ring) + jax.lax.psum(a, "p"),
        mesh=mesh, in_specs=PartitionSpec("p"),
        out_specs=PartitionSpec("p")))
    x = np.arange(n * 8, dtype=np.float32).reshape(n, 8)
    with watchdog(120, "collective check"):
        out = np.asarray(f(x))
    err = float(np.abs(out - (np.roll(x, 1, axis=0) + x.sum(0))).max())
    return dict(ok=err == 0.0, devices=n, err=err)


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _sharded_vs_single(sbd, step, case, dev_steps: int, cmp_steps: int,
                       tol: float, pool) -> dict:
    # the sharded step compiles on a worker while case.step compiles and
    # develops the state on this thread (case.march is not compiled here)
    P_sh = sbd.distribute(np.asarray(case.P0))
    compiled = pool.submit(_timed, lambda: step.lower(P_sh).compile())
    P, single_s = _timed(lambda: np.asarray(_develop(case, dev_steps)))
    progress("single-device steps done")
    with watchdog(900, "sharded step compile"):
        step_c, compile_s = compiled.result()
    P_sh, P_ref = sbd.distribute(P), jnp.asarray(P)
    step_s = []
    for _ in range(cmp_steps):
        t0 = time.perf_counter()
        with watchdog(120, f"sharded step {len(step_s) + 1}"):
            P_sh, _ = jax.block_until_ready(step_c(P_sh))
        step_s.append(time.perf_counter() - t0)
        P_ref, _ = case.step(P_ref)
    out, ref = sbd.collect(P_sh), np.asarray(P_ref)
    err = scaled_err(out, ref)
    devs = list(sbd.mesh.devices.flat)
    return dict(ok=bool(np.isfinite(out).all()) and err <= tol,
                cells=int(case.dom.ncells), devices=len(devs),
                step_err=err, tol=tol, dev_steps=dev_steps,
                cmp_steps=cmp_steps, single_dev_s=single_s,
                sharded_compile_s=compile_s, sharded_step_s=step_s,
                peak_bytes_per_device=[
                    (d.memory_stats() or {}).get("peak_bytes_in_use")
                    for d in devs],
                precision=PRECISION)


def _develop(case, steps: int):
    P = case.P0
    for _ in range(steps):
        P, _ = case.step(P)
    return P


def phase_multi(n_devices: int = 4, dev_steps: int = 300, cmp_steps: int = 3,
                kw2d: dict = None, kw3d: dict = None):
    """Collective check, then the block-sharded runtime on ``n_devices``
    vs single-device case.step for both cases; yields (name, result) as
    each finishes."""
    from ibx.cases import build_rae2822, build_sphere3d
    from ibx.cases.rae2822_block_sharded import build_rae2822_block_sharded
    from ibx.cases.sphere3d_block_sharded import build_sphere3d_block_sharded
    from ibx.parallel import make_device_mesh

    kw2d = FLAGSHIP_2D if kw2d is None else kw2d
    kw3d = SPHERE_3D if kw3d is None else kw3d
    yield "multi_collectives", collective_check(make_device_mesh(n_devices))
    case2d, build2d_s = _timed(build_rae2822, **kw2d)
    progress(f"multi_2d: built {case2d.dom.ncells} cells")
    with ThreadPoolExecutor(2) as pool:
        # the 3D host build runs while the 2D case compiles and steps
        fut3d = pool.submit(_timed, build_sphere3d, **kw3d)
        for name, build_sh, kw, built in (
                ("multi_2d", build_rae2822_block_sharded, kw2d,
                 lambda: (case2d, build2d_s)),
                ("multi_3d", build_sphere3d_block_sharded, kw3d,
                 fut3d.result)):
            case, build_s = built()
            (sbd, step, _, _), sharded_build_s = _timed(
                build_sh, n_devices, cfl=kw["cfl"], case=case)
            progress(f"{name}: sharded domain of {case.dom.ncells} cells "
                     "built")
            res = _sharded_vs_single(sbd, step, case, dev_steps, cmp_steps,
                                     STEP_TOL, pool)
            yield name, dict(res, build_s=build_s,
                             sharded_build_s=sharded_build_s)


def contract_line(devs) -> str:
    """The last line: one JSON object naming the device as JAX reports
    it."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def _emit(name: str, res: dict) -> bool:
    print(f"{name}: " + json.dumps(res), flush=True)
    return bool(res.get("ok"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device sharded phase")
    ap.add_argument("--steps", type=int, default=300,
                    help="march steps per case (default 300)")
    args = ap.parse_args(argv)
    n_need = 4 if args.multi else 1

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devs) < n_need:
        print(f"chip_smoke: need {n_need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"device: kind={devs[0].device_kind!r} count={len(devs)} "
          f"compile_cache={enable_compile_cache()}", flush=True)
    print("nvidia-smi: " + smi.strip().replace("\n", " | "), flush=True)

    ok = True
    if args.multi:
        for name, res in phase_multi(n_need, dev_steps=args.steps):
            ok &= _emit(name, res)
    else:
        ok &= _emit("rae2822_2d", phase_2d(args.steps))
        ok &= _emit("sphere3d", phase_3d(args.steps))
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(contract_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
