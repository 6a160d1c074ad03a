"""Evidence that the interior/frontier split decouples the halo exchange
from the bulk of the RHS (VERDICT round-2 item 3).

Traces the sharded block step on an 8-device virtual CPU mesh with and
without the overlap split and runs an exact taint analysis on the jaxpr:
an op is "tainted" if any input transitively depends on a ppermute. With
the monolithic step every RHS op is tainted (the halo concat feeds the
whole grid); with the split the interior pass — the bulk of the FLOPs —
is independent, so XLA's latency-hiding scheduler is free to run it
while the collective is in flight.
"""

import os
import sys

import numpy as np

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ibx.cases.rae2822_block_sharded import build_rae2822_block_sharded  # noqa: E402


def walk(jaxpr, tainted, stats):
    """Iterate eqns, propagating taint from ppermute outputs; descend into
    sub-jaxprs (shard_map/pjit bodies) with taint shared by object id."""
    for eqn in jaxpr.eqns:
        sub = [v for v in eqn.params.values()
               if hasattr(v, "jaxpr") or hasattr(v, "eqns")]
        inputs_tainted = any(
            (not hasattr(v, "val")) and (id(v) in tainted)
            for v in eqn.invars
        )
        is_permute = "ppermute" in str(eqn.primitive)
        out_taint = inputs_tainted or is_permute
        for v in sub:
            inner = v.jaxpr if hasattr(v, "jaxpr") else v
            # map outer taint onto inner invars positionally
            for outer, innerv in zip(eqn.invars, inner.invars):
                if (not hasattr(outer, "val")) and id(outer) in tainted:
                    tainted.add(id(innerv))
            walk(inner, tainted, stats)
            for outer, innerv in zip(eqn.outvars, inner.outvars):
                if (not hasattr(innerv, "val")) and id(innerv) in tainted:
                    tainted.add(id(outer))
        if not sub:
            size = sum(
                int(np.prod(v.aval.shape)) for v in eqn.outvars
                if hasattr(v.aval, "shape") and v.aval.shape
            )
            if size >= 4096:
                stats["heavy"] += size
                if out_taint:
                    stats["heavy_tainted"] += size
            if out_taint:
                for v in eqn.outvars:
                    tainted.add(id(v))


def analyze(overlap: bool):
    from ibx.ops.block_ops import euler_rhs_grid

    # flagship-shaped mesh: interior must dominate (at toy sizes nearly
    # every block is halo-adjacent and the split frees little)
    sbd, step, P0_sh, case = build_rae2822_block_sharded(
        8, wall_h=1e-2, feature_h=5e-3, overlap=overlap)
    fluid = case.fluid
    print(f"  blocks/device: {sbd.chunk}, local grid: {sbd.B_loc}, "
          f"frontier subgrid: {getattr(sbd, 'B_sub_loc', 0)}")

    # ONE RHS evaluation (the repeated unit of the march): taint relative
    # to ITS OWN exchange is what decides whether the collective can hide
    # behind compute
    def one_rhs(ctx, own):
        loc = ctx.exchange(own)
        if getattr(ctx, "bt_own", None) is None:
            return ctx.own(euler_rhs_grid(ctx.bt, fluid, loc))
        R_int = euler_rhs_grid(ctx.bt_own, fluid, ctx.with_dump(own))
        R_fr = euler_rhs_grid(ctx.bt_sub, fluid, ctx.subgrid(loc))
        return ctx.merge(R_int, R_fr)

    f = sbd.shard_fn(one_rhs)
    jaxpr = jax.make_jaxpr(lambda P: f(P))(P0_sh)
    stats = {"heavy": 0, "heavy_tainted": 0}
    walk(jaxpr.jaxpr, set(), stats)
    frac = stats["heavy_tainted"] / max(1, stats["heavy"])
    print(f"overlap={overlap}: {100 * frac:.0f}% of heavy-op output "
          f"volume depends on the halo ppermutes")
    return frac


if __name__ == "__main__":
    f0 = analyze(False)
    f1 = analyze(True)
    assert f0 > 0.85, f"monolithic step unexpectedly untainted ({f0:.2f})"
    assert f1 < 0.5, (
        f"overlap split freed too little compute ({f0:.2f} -> {f1:.2f})")
    print("OK: interior compute is schedulable during the exchange")
