"""Trace a few march steps of one case on the GPU and reduce the trace with
`jax.profiler.ProfileData` (JAX only): device time per op on each device
line, and the line's busy and idle share over the traced window.

    python scripts/trace_step.py --case sphere3d --steps 10

The raw trace goes to ``--trace-dir`` (gitignored ``.traces``); the reduced
per-op table to ``--out`` as JSON.
"""

import argparse
import glob
import json
import os
import sys
from collections import defaultdict

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _union_ns(spans) -> int:
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_xplane(path: str, top: int = 25, prefix: str = "/device:") -> dict:
    """{plane: {line: {busy_ns, window_ns, idle_share, top ops}}} over the
    planes whose name starts with ``prefix`` (the devices by default).
    Each op entry is [name, total ns, count]."""
    pd = jax.profiler.ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith(prefix):
            continue
        lines = {}
        for line in plane.lines:
            spans, tot, cnt = [], defaultdict(int), defaultdict(int)
            for ev in line.events:
                s, d = int(ev.start_ns), int(ev.duration_ns)
                spans.append((s, s + d))
                tot[ev.name] += d
                cnt[ev.name] += 1
            if not spans:
                continue
            window = max(e for _, e in spans) - min(s for s, _ in spans)
            busy = _union_ns(spans)
            lines[line.name] = dict(
                busy_ns=busy, window_ns=window,
                idle_share=1.0 - busy / window if window else 0.0,
                top=[[k, tot[k], cnt[k]] for k in
                     sorted(tot, key=tot.get, reverse=True)[:top]])
        out[plane.name] = lines
    return out


def trace_march(march, P, steps: int, trace_dir: str) -> dict:
    """Trace ``march(P, steps)`` (already compiled) and reduce the newest
    xplane under ``trace_dir``."""
    with jax.profiler.trace(trace_dir):
        P = jax.block_until_ready(march(P, steps))
    xs = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True), key=os.path.getmtime)
    return reduce_xplane(xs[-1]) if xs else {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=("rae2822", "sphere3d"),
                    default="rae2822")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace-dir", default=".traces")
    ap.add_argument("--out", default=None,
                    help="reduced JSON (default <trace-dir>/trace_<case>.json)")
    args = ap.parse_args()
    out = args.out or os.path.join(args.trace_dir, f"trace_{args.case}.json")

    if args.case == "sphere3d":
        from ibx.cases import build_sphere3d
        case = build_sphere3d(wall_h=0.03, cfl=0.5, block_size=16)
    else:
        from ibx.cases import build_rae2822
        case = build_rae2822(wall_h=5e-4, feature_h=2.5e-4, cfl=0.5,
                             block_size=16)
    # the march (fori_loop) is what users run; compile it first so the
    # traced window holds device work only
    march = case.march.lower(case.P0, args.steps).compile()
    P = jax.block_until_ready(march(case.P0, args.steps))
    red = trace_march(march, P, args.steps, args.trace_dir)
    print("finite:", bool(np.isfinite(np.asarray(P)).all()))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(red, f, indent=1)
    for plane, lines in red.items():
        for name, ln in lines.items():
            print(f"{plane} | {name}: busy {ln['busy_ns'] / 1e6:.3f} ms of "
                  f"{ln['window_ns'] / 1e6:.3f} ms, idle "
                  f"{ln['idle_share']:.3f}")
            for op, ns, n in ln["top"][:10]:
                print(f"    {ns / 1e6:10.3f} ms  x{n:<5d} {op[:100]}")


if __name__ == "__main__":
    main()
