"""Multi-device execution: the partition axis IS the device mesh axis.

The reference parallelizes by running closures over partitions with OS
threads, refreshing halos implicitly through shared host memory
(``src/ImmersedBoundary.jl:820-864``). Here each partition lives in one
device's HBM; a residual evaluation is one ``shard_map`` over a 1-D device
mesh in which

  1. each device slices the cells its ring-offset-``o`` neighbor needs out
     of its owned block (static per-offset ``send_idx_pp`` tables),
  2. one ``lax.ppermute`` per ACTIVE ring offset moves each send buffer to
     its neighbor over ICI (contiguous partitions are spatially coherent,
     so only a few offsets carry traffic — exchanged volume is bounded by
     skirt size, not by an all_gather of everything),
  3. each device gathers its skirt rows out of the received buffers
     (static ``skirt_src`` table) and concatenates them after its owned rows,
  4. the user kernel runs on the domain-shaped local block,
  5. owned rows (the first ``n_own``) are kept; skirt results are discarded.

All tables are padded to identical shapes across partitions, so the whole
step compiles once and runs with zero host round-trips per iteration.
Global reductions (CFL minima, norms, integrals) ride ``lax.pmin/psum``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

from ..ops.operators import Partition
from ..ops.stencil import Stencil
from ..topology.domain import Boundary, Domain


def _pad_rows(a: np.ndarray, n: int, fill=0):
    """Pad axis 0 of ``a`` to length n."""
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _pad_cols(a: np.ndarray, k: int):
    if a.shape[1] == k:
        return a
    pad = np.zeros((a.shape[0], k - a.shape[1]) + a.shape[2:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=1)


@dataclasses.dataclass
class ShardedDomain:
    """Stacked, device-sharded form of a multi-partition Domain."""

    dom: Domain
    mesh: Mesh

    def __post_init__(self):
        dom = self.dom
        P = dom.n_partitions
        assert self.mesh.devices.size == P, (
            f"mesh has {self.mesh.devices.size} devices, domain has {P} "
            "partitions"
        )
        self.n_partitions = P
        self.n_own = dom.n_own
        self.ncells = dom.ncells
        nd = dom.nd
        self.nd = nd

        n_dom_max = max(p.n_dom for p in dom.partitions)
        self.n_dom = n_dom_max

        # ---- halo tables -------------------------------------------------
        # Neighbor ppermute exchange (SURVEY §2.2/§5): per ordered pair
        # (q -> p), the owned rows of q that p's skirt needs; pairs are
        # grouped by ring offset o = (p - q) mod P so each active offset
        # becomes ONE `lax.ppermute` of a fixed-shape send buffer.  With
        # contiguous spatially-coherent partitions only a handful of
        # offsets carry traffic, so the exchanged volume is bounded by the
        # skirt size — unlike the old all_gather of every send buffer
        # (reference shares halos through host memory,
        # ``src/ImmersedBoundary.jl:836-842``; there is no comm layer to
        # mirror, so this is the ICI-native design).
        pair_rows: Dict[tuple, np.ndarray] = {}
        for p in range(P):
            skirt = np.asarray(dom.part_domain[p][dom.partitions[p].n_own:])
            qs = skirt // self.n_own
            for q in np.unique(qs):
                sel = skirt[qs == q] - int(q) * self.n_own
                pair_rows[(int(q), p)] = np.unique(sel)

        offsets = sorted({(p - q) % P for (q, p) in pair_rows})
        # A skirt row is by construction owned by a DIFFERENT partition, so
        # offset 0 can never carry traffic; its appearance would mean the
        # skirt tables are broken (ADVICE r4).
        assert 0 not in offsets, "skirt table maps a row to its own partition"
        send_idx_pp: List[np.ndarray] = []
        base: List[int] = []
        pos_maps: List[List[dict]] = []
        slot0 = 0
        for o in offsets:
            rows = [pair_rows.get((q, (q + o) % P), np.empty(0, np.int64))
                    for q in range(P)]
            S_o = max(1, max(r.size for r in rows))
            idx_o = np.zeros((P, S_o), dtype=np.int32)
            pos_o = []
            for q, r in enumerate(rows):
                idx_o[q, : r.size] = r
                pos_o.append({int(l): i for i, l in enumerate(r)})
            send_idx_pp.append(idx_o)
            pos_maps.append(pos_o)
            base.append(slot0)
            slot0 += S_o
        self._offsets = tuple(offsets)

        skirt_src = np.zeros((P, n_dom_max - self.n_own), dtype=np.int32)
        off_slot = {o: i for i, o in enumerate(offsets)}
        for p in range(P):
            skirt = dom.part_domain[p][dom.partitions[p].n_own:]
            for j, g in enumerate(skirt):
                q = int(g) // self.n_own
                l = int(g) - q * self.n_own
                i = off_slot[(p - q) % P]
                skirt_src[p, j] = base[i] + pos_maps[i][q][l]

        # ---- stacked partition tables -------------------------------------
        def stack(getter, pad_fill=0):
            rows = [np.asarray(getter(p)) for p in dom.partitions]
            n = max(r.shape[0] for r in rows)
            return np.stack([_pad_rows(r, n, pad_fill) for r in rows])

        centers = stack(lambda p: p.centers)
        spacing = stack(lambda p: p.spacing, pad_fill=1.0)
        own_mask = stack(lambda p: p.own_mask)

        face_owner, face_neighbor = [], []
        acc_l_idx, acc_l_w, acc_r_idx, acc_r_w = [], [], [], []
        for d in range(nd):
            F_max = max(1, max(p.face_owner[d].shape[0] for p in dom.partitions))
            fo = np.stack([
                _pad_rows(np.asarray(p.face_owner[d]), F_max)
                for p in dom.partitions
            ])
            fn = np.stack([
                _pad_rows(np.asarray(p.face_neighbor[d]), F_max)
                for p in dom.partitions
            ])
            face_owner.append(fo)
            face_neighbor.append(fn)

            K_l = max(np.asarray(p.acc_left[d].idx).shape[1]
                      for p in dom.partitions)
            K_r = max(np.asarray(p.acc_right[d].idx).shape[1]
                      for p in dom.partitions)
            acc_l_idx.append(np.stack([
                _pad_rows(_pad_cols(np.asarray(p.acc_left[d].idx), K_l),
                          n_dom_max)
                for p in dom.partitions
            ]))
            acc_l_w.append(np.stack([
                _pad_rows(_pad_cols(np.asarray(p.acc_left[d].w), K_l),
                          n_dom_max)
                for p in dom.partitions
            ]))
            acc_r_idx.append(np.stack([
                _pad_rows(_pad_cols(np.asarray(p.acc_right[d].idx), K_r),
                          n_dom_max)
                for p in dom.partitions
            ]))
            acc_r_w.append(np.stack([
                _pad_rows(_pad_cols(np.asarray(p.acc_right[d].w), K_r),
                          n_dom_max)
                for p in dom.partitions
            ]))

        # ---- stacked boundary tables --------------------------------------
        self._boundary_tables: Dict[str, dict] = {}
        for name, blocks in dom.boundaries.items():
            G_max = max(1, max(b.n_ghost for b in blocks))
            K = max(np.asarray(b.interp.idx).shape[1] for b in blocks)

            def pad_block(b: Boundary):
                G = b.n_ghost
                ghost = _pad_rows(np.asarray(b.ghost), G_max,
                                  fill=n_dom_max)  # OOB -> dropped scatter
                return dict(
                    ghost=ghost,
                    normals=_pad_rows(np.asarray(b.normals), G_max),
                    projections=_pad_rows(np.asarray(b.projections), G_max),
                    image_distances=_pad_rows(
                        np.asarray(b.image_distances), G_max, 1.0),
                    ghost_distances=_pad_rows(
                        np.asarray(b.ghost_distances), G_max),
                    eta=_pad_rows(np.asarray(b.eta), G_max),
                    interp_idx=_pad_rows(
                        _pad_cols(np.asarray(b.interp.idx), K), G_max),
                    interp_w=_pad_rows(
                        _pad_cols(np.asarray(b.interp.w), K), G_max),
                    valid=_pad_rows(np.asarray(b.valid), G_max),
                )

            padded = [pad_block(b) for b in blocks]
            self._boundary_tables[name] = {
                k: np.stack([pb[k] for pb in padded]) for k in padded[0]
            }

        tables = dict(
            centers=centers, spacing=spacing, own_mask=own_mask,
            send_idx_pp=tuple(send_idx_pp), skirt_src=skirt_src,
            face_owner=tuple(face_owner), face_neighbor=tuple(face_neighbor),
            acc_l_idx=tuple(acc_l_idx), acc_l_w=tuple(acc_l_w),
            acc_r_idx=tuple(acc_r_idx), acc_r_w=tuple(acc_r_w),
            boundaries=self._boundary_tables,
        )
        sharding = jax.sharding.NamedSharding(self.mesh, PartitionSpec("p"))
        self.tables = jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), sharding), tables
        )
        self._spec = jax.tree_util.tree_map(
            lambda _: PartitionSpec("p"), tables
        )

    # ---- state layout -----------------------------------------------------

    def distribute(self, a):
        """Global [N, ...] -> sharded [P, n_own, ...]."""
        a = np.asarray(a)
        pad = self.n_partitions * self.n_own - self.ncells
        if pad:
            a = np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
            )
        a = a.reshape((self.n_partitions, self.n_own) + a.shape[1:])
        sharding = jax.sharding.NamedSharding(self.mesh, PartitionSpec("p"))
        return jax.device_put(jnp.asarray(a), sharding)

    def collect(self, a):
        """Sharded [P, n_own, ...] -> global numpy [N, ...]."""
        a = np.asarray(a)
        a = a.reshape((-1,) + a.shape[2:])
        return a[: self.ncells]

    # ---- in-shard helpers ---------------------------------------------------

    def _local_partition(self, t) -> Partition:
        """Assemble a Partition pytree from one device's table slices
        (called inside shard_map, where leading axis is 1)."""
        nd = self.nd

        def mk_stencil(idx, w):
            return Stencil(idx=idx, w=w, n_output=idx.shape[0],
                           width=idx.shape[1])

        return Partition(
            centers=t["centers"][0],
            spacing=t["spacing"][0],
            face_owner=tuple(t["face_owner"][d][0] for d in range(nd)),
            face_neighbor=tuple(t["face_neighbor"][d][0] for d in range(nd)),
            acc_left=tuple(
                mk_stencil(t["acc_l_idx"][d][0], t["acc_l_w"][d][0])
                for d in range(nd)
            ),
            acc_right=tuple(
                mk_stencil(t["acc_r_idx"][d][0], t["acc_r_w"][d][0])
                for d in range(nd)
            ),
            own_mask=t["own_mask"][0],
            n_own=self.n_own,
            n_dom=self.n_dom,
            nd=nd,
        )

    def _local_boundary(self, t, name) -> Boundary:
        bt = t["boundaries"][name]
        idx = bt["interp_idx"][0]
        return Boundary(
            ghost=bt["ghost"][0],
            projections=bt["projections"][0],
            normals=bt["normals"][0],
            image_distances=bt["image_distances"][0],
            ghost_distances=bt["ghost_distances"][0],
            eta=bt["eta"][0],
            interp=Stencil(idx=idx, w=bt["interp_w"][0],
                           n_output=idx.shape[0], width=idx.shape[1]),
            valid=bt["valid"][0],
            n_ghost=idx.shape[0],
        )

    def _refresh(self, t, u_own):
        """Halo exchange: owned block [n_own, ...] -> domain block
        [n_dom, ...].  One ``lax.ppermute`` per active ring offset; the
        received buffers are concatenated and re-indexed into skirt order
        by the static ``skirt_src`` table."""
        P = self.n_partitions
        bufs = []
        for i, o in enumerate(self._offsets):
            send = jnp.take(u_own, t["send_idx_pp"][i][0], axis=0)
            if P == 1:  # self-copy: ppermute over a 1-ring is the identity
                bufs.append(send)
                continue
            perm = [(q, (q + o) % P) for q in range(P)]
            bufs.append(jax.lax.ppermute(send, "p", perm))
        if not bufs:
            return jnp.concatenate(
                [u_own, jnp.zeros((0,) + u_own.shape[1:], u_own.dtype)],
                axis=0)
        allbuf = bufs[0] if len(bufs) == 1 else jnp.concatenate(bufs, axis=0)
        skirt = jnp.take(allbuf, t["skirt_src"][0], axis=0)
        return jnp.concatenate([u_own, skirt], axis=0)

    # ---- execution ----------------------------------------------------------

    def shard_fn(self, f):
        """Wrap ``f(ctx, *domain_arrays) -> domain arrays or (arrays, aux)``
        into a jitted sharded function over owned blocks.

        ctx exposes: ``part`` (Partition), ``boundary(name)``, ``refresh(a)``
        (re-exchange halos mid-kernel, e.g. between BC families), ``pmin``,
        ``pmax``, ``psum`` collectives.
        Returns a function taking/returning sharded [P, n_own, ...] arrays.
        """
        sdom = self

        def kernel(t, *u_shards):
            part = sdom._local_partition(t)

            class Ctx:
                pass

            ctx = Ctx()
            ctx.part = part
            ctx.boundary = lambda name: sdom._local_boundary(t, name)
            ctx.refresh = lambda a: sdom._refresh(
                t, jax.lax.slice_in_dim(a, 0, sdom.n_own, axis=0)
            )
            ctx.pmin = lambda x: jax.lax.pmin(x, "p")
            ctx.pmax = lambda x: jax.lax.pmax(x, "p")
            ctx.psum = lambda x: jax.lax.psum(x, "p")
            ctx.own_mask = part.own_mask

            dargs = [sdom._refresh(t, u[0]) for u in u_shards]
            res = f(ctx, *dargs)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            return tuple(
                jax.lax.slice_in_dim(r, 0, sdom.n_own, axis=0)[None]
                for r in res
            )

        cache = {}

        def call(*u_shards):
            n = len(u_shards)
            if n not in cache:
                specs_in = (self._spec,) + tuple(
                    PartitionSpec("p") for _ in range(n)
                )
                cache[n] = jax.shard_map(
                    kernel, mesh=self.mesh, check_vma=False,
                    in_specs=specs_in,
                    out_specs=PartitionSpec("p"),
                )
            return cache[n](self.tables, *u_shards)

        return call


def make_device_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the first ``n_devices`` local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ("p",))


def sharded_impose_bc(ctx, bdry: Boundary, fn, *dargs, **kwargs):
    """Ghost-cell BC on domain-local arrays inside a sharded kernel.

    Equivalent of Domain.impose_bc for the shard_map path; padded ghost rows
    carry out-of-range indices and are dropped by the scatter.
    """
    iargs = [bdry.interp(a) for a in dargs]
    res = fn(bdry, *iargs, **kwargs)
    if not isinstance(res, (tuple, list)):
        res = (res,)
    outs = []
    for a, ia, ba in zip(dargs, iargs, res):
        eta = bdry.eta.reshape(bdry.eta.shape + (1,) * (ia.ndim - 1))
        gv = eta * ia + (1.0 - eta) * ba
        outs.append(a.at[bdry.ghost].set(
            gv, mode="drop", unique_indices=True, indices_are_sorted=True
        ))
    return outs[0] if len(outs) == 1 else tuple(outs)
