"""Sharded BLOCK fast path: spatial decomposition by octree block.

The single-device fast path (`ibx.ops.block_ops`) runs ~30x faster than the
generic gather operators; this module shards it over a 1-D device mesh so
multi-chip runs keep the dense throughput (VERDICT round-1 item 3; the
reference's only parallel strategy is partition-with-skirts over threads,
``src/ImmersedBoundary.jl:820-864``).

Design:
  * blocks are assigned to devices in contiguous block-major chunks (the
    cell ordering is an octree space-filling order, so chunks are spatially
    coherent);
  * each device's halo = face-adjacent blocks of its own chunk plus the
    blocks holding BC image stencils of its own ghosts — whole blocks, so
    the per-device `BlockTables` compile sees complete face sets for every
    own block and the dense/2:1 classification matches the global one;
  * halo exchange = one static-neighbor `lax.ppermute` per distinct
    partition offset (NOT an all_gather: traffic is only what each neighbor
    pair needs, the pod-scalable shape);
  * each device runs `euler_rhs_grid` on [own + halo + dump] blocks and
    keeps its own rows; halo-block results are garbage (their far
    neighbors are absent) and are discarded;
  * ghost BCs run per device on own-block ghosts in the local flat index
    space (stencils live in own + halo by construction).

Padding invariants: pad own slots replicate finite state and carry
``active = 0``; pad halo slots receive real (unreferenced) data; the dump
block (last slot) absorbs inert padded 2:1-interface table entries.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

from ..topology.blocks import BlockTables, build_block_tables_raw
from ..topology.domain import Domain


def _pad_rows(a: np.ndarray, n: int, fill=0):
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


class ShardedBlockDomain:
    """Stacked per-device block tables + halo machinery.

    ``overlap=True`` additionally compiles an interior/frontier split of
    the RHS (VERDICT round-2 item 3): the interior pass runs on own blocks
    only and carries NO data dependence on the halo ppermute, so XLA's
    latency-hiding scheduler can overlap the collective with the bulk of
    the FLOPs; the frontier pass re-evaluates the (small) halo-adjacent
    block set on a compact subgrid once the exchange lands.
    """

    def __init__(self, dom: Domain, mesh: Mesh, *, overlap: bool = False,
                 bc_names: Sequence[str] = None, dense_families=None):
        """``bc_names``: build per-device `BlockedBC` tables for these
        families (the round-4 BC fast paths — dense-plane templates,
        stencil dedup, phase-view placement, union write-back — under the
        sharded march; VERDICT r4 item 1).  The kernel then exposes
        ``ctx.bbc``; the per-ghost gather ``ctx.bc``
        remains for callbacks BlockedBC cannot host (wall-model BCs)."""
        assert dom.n_partitions == 1, "build from a single-partition Domain"
        msh = dom.mesh
        self.dom = dom
        self.mesh = mesh
        P = int(mesh.devices.size)
        self.P = P
        bs = int(msh.block_size)
        nd = msh.ndim
        npb = bs ** nd
        B = msh.n_blocks
        self.bs, self.nd, self.npb, self.B = bs, nd, npb, B
        chunk = -(-B // P)
        self.chunk = chunk

        fo = dom.face_owner.astype(np.int64)
        fn = dom.face_neighbor.astype(np.int64)
        fdim = dom.face_dim

        owner = lambda b: np.minimum(b // chunk, P - 1)  # noqa: E731

        # ---- halo sets --------------------------------------------------
        # The RHS stencil at an own cell reaches 2 cells deep across the
        # face graph (pass B's face_B consumes the JST sensor nu3 and
        # gradients du3 AT the neighbor cell, which pass A computes from
        # that cell's own face neighbors — round-2 advisor finding: one
        # block ring gave 7.5e-4 sharded-vs-single error from a shocked
        # state). The EXACT halo is therefore the cell-level 2-ring
        # closure: its blocks = the face-neighbor blocks plus the corner
        # blocks the 2-hop lateral paths touch. A block-level second ring
        # (adj(adj(own))) is a 2-4x overestimate — it tripled both the
        # exchange volume and the redundant halo compute.
        N = B * npb
        interior = (fo >= 0) & (fn >= 0)
        eo = fo[interior]
        en = fn[interior]
        need: List[set] = [set() for _ in range(P)]
        for p in range(P):
            lo, hi = p * chunk, min((p + 1) * chunk, B)
            m = np.zeros(N, bool)
            m[lo * npb: hi * npb] = True
            for _ in range(2):
                add_n = en[m[eo]]
                add_o = eo[m[en]]
                m[add_n] = True
                m[add_o] = True
            need[p].update(np.unique(
                np.nonzero(m)[0] // npb).tolist())
        for hb in dom._host_boundaries.values():
            gdev = owner(hb.ghosts // npb)
            sblk = hb.interp_idx // npb
            for p in range(P):
                sel = sblk[gdev == p]
                need[p].update(sel.reshape(-1).tolist())
        halo = []
        for p in range(P):
            lo, hi = p * chunk, min((p + 1) * chunk, B)
            halo.append(sorted(b for b in need[p] if not (lo <= b < hi)))

        # ---- ppermute offsets + send tables ------------------------------
        offs = sorted({
            int((int(owner(np.int64(b))) - p) % P)
            for p in range(P) for b in halo[p]
        })
        self.offs = offs
        # o = (owner - receiver) mod P: receiver p's offset-o halo comes
        # FROM device (p + o) % P; send[o][p] = what p sends to (p - o) % P
        send: Dict[int, List[np.ndarray]] = {}
        S = {}
        for o in offs:
            send[o] = []
            for p in range(P):
                q = (p - o) % P
                lo, hi = p * chunk, min((p + 1) * chunk, B)
                blocks = np.asarray(
                    [b for b in halo[q] if lo <= b < hi], np.int64)
                send[o].append(blocks)
            S[o] = max(1, max(s.size for s in send[o]))
        self.S = S
        B_loc = chunk + sum(S[o] for o in offs) + 1
        self.B_loc = B_loc
        self.n_loc = B_loc * npb

        # ---- local block maps -------------------------------------------
        l2g = np.full((P, B_loc), -1, np.int64)
        send_idx = {o: np.zeros((P, S[o]), np.int32) for o in offs}
        for p in range(P):
            lo, hi = p * chunk, min((p + 1) * chunk, B)
            l2g[p, : hi - lo] = np.arange(lo, hi)
            base = chunk
            for o in offs:
                src = (p + o) % P
                blocks = send[o][src]
                l2g[p, base: base + blocks.size] = blocks
                send_idx[o][src, : blocks.size] = (
                    blocks - src * chunk).astype(np.int32)
                base += S[o]

        self._l2g = l2g

        # ---- per-device topology compile ---------------------------------
        widths = dom.widths
        centers = dom.centers
        bts: List[BlockTables] = []
        bc_local = []
        g2l_list: List[np.ndarray] = []
        for p in range(P):
            g2l = np.full(B, -1, np.int64)
            real = l2g[p] >= 0
            g2l[l2g[p][real]] = np.nonzero(real)[0]
            g2l_list.append(g2l.copy())

            fob = np.where(fo >= 0, g2l[np.maximum(fo // npb, 0)], -2)
            fnb = np.where(fn >= 0, g2l[np.maximum(fn // npb, 0)], -2)
            keep = ((fo < 0) | (fob >= 0)) & ((fn < 0) | (fnb >= 0)) \
                & ~((fo < 0) & (fn < 0))
            lfo = np.where(fo[keep] >= 0,
                           fob[keep] * npb + fo[keep] % npb, -1)
            lfn = np.where(fn[keep] >= 0,
                           fnb[keep] * npb + fn[keep] % npb, -1)

            w_loc = np.ones((B_loc * npb, nd), np.float32)
            c_loc = np.zeros((B_loc * npb, nd), np.float32)
            src = l2g[p][real]
            dst = np.nonzero(real)[0]
            cells_src = (src[:, None] * npb
                         + np.arange(npb)[None, :]).reshape(-1)
            cells_dst = (dst[:, None] * npb
                         + np.arange(npb)[None, :]).reshape(-1)
            w_loc[cells_dst] = widths[cells_src]
            c_loc[cells_dst] = centers[cells_src]
            borig = np.zeros((B_loc, nd), np.float64)
            bwid = np.full((B_loc, nd), float(bs), np.float64)
            borig[dst] = msh.block_origins[src]
            bwid[dst] = msh.block_widths[src]

            bts.append(build_block_tables_raw(
                nd=nd, bs=bs, B=B_loc,
                fdim=fdim[keep], fo=lfo, fn=lfn,
                widths=w_loc, centers=c_loc,
                block_origins=borig, block_widths=bwid,
            ))

            # BC tables: own ghosts, fused families, local flat ids.
            # Overlapping ghosts (families whose ghost bands intersect,
            # e.g. hypercube corners or a wall band reaching the farfield
            # band on small boxes): the LAST listed family wins, matching
            # the sequential impose_bc semantics (and BlockedBC).
            claimed = {}
            for i, (name, hb) in enumerate(dom._host_boundaries.items()):
                for g in hb.ghosts:
                    claimed[int(g)] = i
            gl, il, wl, el, nl, fl, dl = [], [], [], [], [], [], []
            for i, (name, hb) in enumerate(dom._host_boundaries.items()):
                keep = np.array(
                    [claimed[int(g)] == i for g in hb.ghosts], bool)
                sel = (owner(hb.ghosts // npb) == p) & keep
                if not sel.any():
                    continue
                g = hb.ghosts[sel]
                gi = hb.interp_idx[sel]
                assert (g2l[g // npb] >= 0).all()
                assert (g2l[gi // npb] >= 0).all(), \
                    "BC stencil escaped the halo block set"
                gl.append(g2l[g // npb] * npb + g % npb)
                il.append(g2l[gi // npb] * npb + gi % npb)
                wl.append(hb.interp_w[sel])
                el.append(hb.ghost_distances[sel] / hb.image_distances[sel])
                nl.append(hb.normals[sel])
                fl.append(np.full(int(sel.sum()), i, np.int32))
                dl.append(hb.image_distances[sel])
            if gl:
                K = max(a.shape[1] for a in il)

                def padk(a, rep):
                    if a.shape[1] == K:
                        return a
                    fill = a[:, :1] if rep else np.zeros_like(a[:, :1])
                    return np.concatenate(
                        [a] + [fill] * (K - a.shape[1]), axis=1)

                g = np.concatenate(gl)
                order = np.argsort(g)
                assert (g[order][np.nonzero(np.diff(g[order]) == 0)]
                        .size == 0)
                bc_local.append(dict(
                    ghost=g[order].astype(np.int64),
                    idx=np.concatenate(
                        [padk(a, True) for a in il])[order].astype(np.int32),
                    w=np.concatenate(
                        [padk(a, False) for a in wl])[order]
                    .astype(np.float32),
                    eta=np.concatenate(el)[order].astype(np.float32),
                    normals=np.concatenate(nl)[order].astype(np.float32),
                    family=np.concatenate(fl)[order],
                    imd=np.concatenate(dl)[order].astype(np.float32),
                ))
            else:
                bc_local.append(dict(
                    ghost=np.zeros(0, np.int64),
                    idx=np.zeros((0, 1), np.int32),
                    w=np.zeros((0, 1), np.float32),
                    eta=np.zeros(0, np.float32),
                    normals=np.zeros((0, nd), np.float32),
                    family=np.zeros(0, np.int32),
                    imd=np.zeros(0, np.float32),
                ))
            assert (bc_local[-1]["ghost"] < chunk * npb).all(), \
                "own ghosts must live in own blocks"

        # ---- stack + pad across devices ----------------------------------
        self._stacked_bt = self._stack_block_tables(bts)
        G_max = max(1, max(b["ghost"].size for b in bc_local))
        K_max = max(b["idx"].shape[1] for b in bc_local)

        def pad_bc(b):
            n = b["ghost"].size
            idx = b["idx"]
            if idx.shape[1] < K_max:
                idx = np.concatenate(
                    [idx] + [idx[:, :1] if n else
                             np.zeros((n, 1), np.int32)]
                    * (K_max - idx.shape[1]), axis=1)
            w = b["w"]
            if w.shape[1] < K_max:
                w = np.concatenate(
                    [w, np.zeros((n, K_max - w.shape[1]), np.float32)],
                    axis=1)
            return dict(
                ghost=_pad_rows(b["ghost"], G_max,
                                fill=self.n_loc),     # OOB -> dropped
                idx=_pad_rows(idx, G_max),
                w=_pad_rows(w, G_max),
                eta=_pad_rows(b["eta"], G_max),
                normals=_pad_rows(b["normals"], G_max),
                family=_pad_rows(b["family"], G_max),
                imd=_pad_rows(b["imd"], G_max, fill=1.0),  # avoid /0 in BCs
            )

        bc_stacked = {
            k: np.stack([pad_bc(b)[k] for b in bc_local])
            for k in pad_bc(bc_local[0])
        }

        tables = dict(
            bt=self._stacked_bt,
            bc=bc_stacked,
            send_idx={o: send_idx[o] for o in offs},
        )

        # ---- per-device BlockedBC fast path ------------------------------
        self._bbc_meta = None
        if bc_names is not None:
            from ..topology.blocked_bc import build_blocked_bc_stacked

            own_of_block = np.minimum(np.arange(B) // chunk, P - 1)
            tables["bbc"], self._bbc_meta = build_blocked_bc_stacked(
                dom, bc_names, own_of_block, g2l_list, B_loc,
                dense_families=dense_families,
            )

        # ---- interior/frontier overlap split -----------------------------
        self.overlap = bool(overlap) and P > 1
        if self.overlap:
            def build_subset(glob_blocks: np.ndarray, B_sub: int):
                """BlockTables over an arbitrary global-block subset mapped
                to rows 0..n-1 (pad rows inert, dump row last)."""
                n_real = glob_blocks.size
                g2s = np.full(B, -1, np.int64)
                g2s[glob_blocks] = np.arange(n_real)
                fob = np.where(fo >= 0, g2s[np.maximum(fo // npb, 0)], -2)
                fnb = np.where(fn >= 0, g2s[np.maximum(fn // npb, 0)], -2)
                keep = ((fo < 0) | (fob >= 0)) & ((fn < 0) | (fnb >= 0)) \
                    & ~((fo < 0) & (fn < 0))
                lfo = np.where(fo[keep] >= 0,
                               fob[keep] * npb + fo[keep] % npb, -1)
                lfn = np.where(fn[keep] >= 0,
                               fnb[keep] * npb + fn[keep] % npb, -1)
                w_loc = np.ones((B_sub * npb, nd), np.float32)
                c_loc = np.zeros((B_sub * npb, nd), np.float32)
                src_c = (glob_blocks[:, None] * npb
                         + np.arange(npb)[None, :]).reshape(-1)
                dst_c = np.arange(n_real * npb)
                w_loc[dst_c] = widths[src_c]
                c_loc[dst_c] = centers[src_c]
                borig = np.zeros((B_sub, nd), np.float64)
                bwid = np.full((B_sub, nd), float(bs), np.float64)
                borig[:n_real] = msh.block_origins[glob_blocks]
                bwid[:n_real] = msh.block_widths[glob_blocks]
                return build_block_tables_raw(
                    nd=nd, bs=bs, B=B_sub,
                    fdim=fdim[keep], fo=lfo, fn=lfn,
                    widths=w_loc, centers=c_loc,
                    block_origins=borig, block_widths=bwid,
                ), g2s

            def expand2_blocks(seed_cells_mask):
                m = seed_cells_mask.copy()
                for _ in range(2):
                    add_n = en[m[eo]]
                    add_o = eo[m[en]]
                    m[add_n] = True
                    m[add_o] = True
                return set(np.unique(np.nonzero(m)[0] // npb).tolist())

            bts_own, bts_sub = [], []
            S_list, F_list = [], []
            for p in range(P):
                lo, hi = p * chunk, min((p + 1) * chunk, B)
                O = set(range(lo, hi))
                H = set(halo[p])
                # frontier = own blocks whose (2-cell-deep) RHS stencil
                # leaves the own cell range
                m = np.ones(N, bool)
                m[lo * npb: hi * npb] = False
                F = expand2_blocks(m) & O
                # subgrid = 2-cell-deep support of the frontier blocks,
                # restricted to locally present blocks
                m = np.zeros(N, bool)
                for b in F:
                    m[b * npb: (b + 1) * npb] = True
                S = np.asarray(
                    sorted(expand2_blocks(m) & (O | H)), np.int64)
                F_list.append(F)
                S_list.append(S)
            S_max = max(1, max(s.size for s in S_list))
            self.B_own_loc = chunk + 1
            self.B_sub_loc = S_max + 1
            sub_src = np.full((P, S_max + 1), B_loc - 1, np.int32)
            fr_idx = np.full((P, chunk), S_max, np.int32)
            fr_mask = np.zeros((P, chunk), np.float32)
            for p in range(P):
                lo, hi = p * chunk, min((p + 1) * chunk, B)
                own_blocks = np.arange(lo, hi, dtype=np.int64)
                bt_o, _ = build_subset(own_blocks, chunk + 1)
                bts_own.append(bt_o)
                S = S_list[p]
                bt_s, g2s = build_subset(S, S_max + 1)
                bts_sub.append(bt_s)
                # local-grid rows feeding the subgrid (own and halo alike)
                g2l = np.full(B, -1, np.int64)
                real = l2g[p] >= 0
                g2l[l2g[p][real]] = np.nonzero(real)[0]
                assert (g2l[S] >= 0).all(), "subgrid escaped the local grid"
                sub_src[p, : S.size] = g2l[S]
                for b in F_list[p]:
                    fr_idx[p, b - lo] = g2s[b]
                    fr_mask[p, b - lo] = 1.0
            tables["bt_own"] = self._stack_block_tables(bts_own, chunk + 1)
            tables["bt_sub"] = self._stack_block_tables(bts_sub, S_max + 1)
            tables["sub_src"] = sub_src
            tables["fr_idx"] = fr_idx
            tables["fr_mask"] = fr_mask
        sharding = jax.sharding.NamedSharding(self.mesh, PartitionSpec("p"))
        self.tables = jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), sharding), tables
        )
        self._spec = jax.tree_util.tree_map(
            lambda _: PartitionSpec("p"), tables
        )

    # -- per-device table stacking ----------------------------------------

    def _stack_block_tables(self, bts: List[BlockTables], B_loc: int = None):
        P, nd = self.P, self.nd
        if B_loc is None:
            B_loc = self.B_loc
        dump = B_loc - 1

        def stack2(get, pad_fill=0, pad_to=None):
            """Stack a per-(d, s) list leaf with row padding."""
            out = []
            for d in range(nd):
                row = []
                for s in range(2):
                    arrs = [np.asarray(get(bt, d, s)) for bt in bts]
                    n = max(a.shape[0] for a in arrs)
                    row.append(np.stack(
                        [_pad_rows(a, n, pad_fill) for a in arrs]))
                out.append(tuple(row))
            return tuple(out)

        # ifc_inv must be rebuilt for the padded row counts (real rows keep
        # their positions; pad rows are unreferenced; dummy = padded total)
        ifc_inv = []
        for d in range(nd):
            row = []
            for s in range(2):
                n_fs = max(np.asarray(bt.fs_block[d][s]).shape[0]
                           for bt in bts)
                n_cs = max(np.asarray(bt.cs_block[d][s]).shape[0]
                           for bt in bts)
                invs = []
                for bt in bts:
                    inv = np.full(B_loc, n_fs + n_cs, np.int32)
                    fsb = np.asarray(bt.fs_block[d][s])
                    csb = np.asarray(bt.cs_block[d][s])
                    inv[fsb] = np.arange(fsb.size, dtype=np.int32)
                    inv[csb] = n_fs + np.arange(csb.size, dtype=np.int32)
                    invs.append(inv)
                row.append(np.stack(invs))
            ifc_inv.append(tuple(row))

        return dict(
            nbr=stack2(lambda bt, d, s: bt.nbr[d][s]),
            bnd=stack2(lambda bt, d, s: bt.bnd[d][s]),
            edge_valid=stack2(lambda bt, d, s: bt.edge_valid[d][s]),
            h=np.stack([np.asarray(bt.h) for bt in bts]),
            fs_block=stack2(lambda bt, d, s: bt.fs_block[d][s],
                            pad_fill=dump),
            fs_coarse=stack2(lambda bt, d, s: bt.fs_coarse[d][s],
                             pad_fill=dump),
            fs_off=stack2(lambda bt, d, s: bt.fs_off[d][s]),
            cs_block=stack2(lambda bt, d, s: bt.cs_block[d][s],
                            pad_fill=dump),
            cs_fine=stack2(lambda bt, d, s: bt.cs_fine[d][s],
                           pad_fill=dump),
            ifc_inv=tuple(ifc_inv),
            sp_owner=stack2(lambda bt, d, s: bt.sp_owner[d] if s == 0
                            else np.zeros(0, np.int32)),
            sp_neighbor=stack2(lambda bt, d, s: bt.sp_neighbor[d] if s == 0
                               else np.zeros(0, np.int32)),
            sp_wr=stack2(lambda bt, d, s: bt.sp_wr[d] if s == 0
                         else np.zeros(0, np.float32)),
            sp_wl=stack2(lambda bt, d, s: bt.sp_wl[d] if s == 0
                         else np.zeros(0, np.float32)),
            spacing_flat=np.stack(
                [np.asarray(bt.spacing_flat) for bt in bts]),
        )

    def _local_bt(self, t, key: str = "bt",
                  n_blocks: int = None) -> BlockTables:
        nd = self.nd
        bt = t[key]
        if n_blocks is None:
            n_blocks = self.B_loc

        def g2(key, d, s):
            return bt[key][d][s][0]

        return BlockTables(
            nbr=tuple(tuple(g2("nbr", d, s) for s in range(2))
                      for d in range(nd)),
            bnd=tuple(tuple(g2("bnd", d, s) for s in range(2))
                      for d in range(nd)),
            edge_valid=tuple(tuple(g2("edge_valid", d, s) for s in range(2))
                             for d in range(nd)),
            h=bt["h"][0],
            fs_block=tuple(tuple(g2("fs_block", d, s) for s in range(2))
                           for d in range(nd)),
            fs_coarse=tuple(tuple(g2("fs_coarse", d, s) for s in range(2))
                            for d in range(nd)),
            fs_off=tuple(tuple(g2("fs_off", d, s) for s in range(2))
                         for d in range(nd)),
            fs_inv=tuple(tuple(g2("ifc_inv", d, s) for s in range(2))
                         for d in range(nd)),
            cs_block=tuple(tuple(g2("cs_block", d, s) for s in range(2))
                           for d in range(nd)),
            cs_fine=tuple(tuple(g2("cs_fine", d, s) for s in range(2))
                          for d in range(nd)),
            cs_inv=tuple(tuple(g2("ifc_inv", d, s) for s in range(2))
                         for d in range(nd)),
            ifc_inv=tuple(tuple(g2("ifc_inv", d, s) for s in range(2))
                          for d in range(nd)),
            sp_owner=tuple(bt["sp_owner"][d][0][0] for d in range(nd)),
            sp_neighbor=tuple(bt["sp_neighbor"][d][0][0] for d in range(nd)),
            sp_wr=tuple(bt["sp_wr"][d][0][0] for d in range(nd)),
            sp_wl=tuple(bt["sp_wl"][d][0][0] for d in range(nd)),
            spacing_flat=bt["spacing_flat"][0],
            n_blocks=n_blocks,
            block_size=self.bs,
            nd=self.nd,
            n_cells=n_blocks * self.npb,
        )

    # -- state layout ------------------------------------------------------

    def distribute(self, a, pad_mode: str = "edge"):
        """Global flat [N, ...] -> sharded own grids [P, chunk, bs.., ...].

        ``pad_mode``: 'edge' replicates block 0 into pad slots (finite flow
        state); 'zero' for masks.
        """
        a = np.asarray(a)
        grids = a.reshape((self.B,) + (self.bs,) * self.nd + a.shape[1:])
        padn = self.P * self.chunk - self.B
        if padn:
            fill = (np.repeat(grids[:1], padn, axis=0) if pad_mode == "edge"
                    else np.zeros((padn,) + grids.shape[1:], grids.dtype))
            grids = np.concatenate([grids, fill], axis=0)
        grids = grids.reshape((self.P, self.chunk) + grids.shape[1:])
        sharding = jax.sharding.NamedSharding(self.mesh, PartitionSpec("p"))
        return jax.device_put(jnp.asarray(grids), sharding)

    def collect(self, a):
        """Sharded [P, chunk, bs.., ...] -> global flat numpy [N, ...]."""
        a = np.asarray(a)
        a = a.reshape((self.P * self.chunk * self.npb,) + a.shape[2 + self.nd:])
        return a[: self.B * self.npb]

    def distribute_local(self, a, fill=0.0):
        """Global flat [N, ...] -> sharded LOCAL grids [P, B_loc, bs.., ...]
        with halo slots filled from their true global blocks (pad/dump
        slots get ``fill``). For static per-cell fields consumed inside the
        RHS (e.g. the TE fix blend) — no per-step exchange needed."""
        a = np.asarray(a)
        grids = a.reshape((self.B,) + (self.bs,) * self.nd + a.shape[1:])
        out = np.full((self.P, self.B_loc) + grids.shape[1:], fill,
                      grids.dtype)
        for p in range(self.P):
            real = self._l2g[p] >= 0
            out[p][real] = grids[self._l2g[p][real]]
        sharding = jax.sharding.NamedSharding(self.mesh, PartitionSpec("p"))
        return jax.device_put(jnp.asarray(out), sharding)

    # -- execution ---------------------------------------------------------

    def shard_fn(self, f, replicated=None):
        """Wrap ``f(ctx, *own_grids) -> own grids (or (grids, aux))`` into a
        jitted sharded function.

        ctx: ``bt`` (local BlockTables over [chunk + halo + dump] blocks),
        ``exchange(own_grid) -> local_grid`` (neighbor ppermute halos),
        ``own(local) -> own slice``, ``bc(local_grid, fns) -> local_grid``
        (own-block ghost update), ``pmax/pmin/psum``, ``all_gather``.

        ``replicated``: optional pytree of device arrays passed into the
        kernel REPLICATED (PartitionSpec()) as ``ctx.rep`` — e.g. multigrid
        transfer stencils and coarse-level tables for the sharded-fine /
        replicated-coarse FAS composition.
        """
        sbd = self
        if replicated is None:
            replicated = {}

        def kernel(t, rep, *shards):
            class Ctx:
                pass

            ctx = Ctx()
            ctx.bt = sbd._local_bt(t)

            def exchange(own):
                segs = [own]
                for o in sbd.offs:
                    sendbuf = jnp.take(own, t["send_idx"][o][0], axis=0)
                    # device q sends to (q - o): receiver p hears from p + o
                    perm = [(q, (q - o) % sbd.P) for q in range(sbd.P)]
                    segs.append(jax.lax.ppermute(sendbuf, "p", perm))
                segs.append(own[:1])        # dump block (finite, inert)
                return jnp.concatenate(segs, axis=0)

            def bc(local, fns, guard=None):
                import inspect

                C = local.shape[-1]
                bcT = t["bc"]
                flat = local.reshape(sbd.n_loc, C)
                idx = bcT["idx"][0]
                Pi = (jnp.take(flat, idx.reshape(-1), axis=0)
                      .reshape(idx.shape + (C,))
                      * bcT["w"][0][..., None]).sum(axis=1)
                r = None
                for i, name in enumerate(fns):
                    fn = fns[name]
                    # wall-model BCs take a third arg: the per-ghost image
                    # distances (wall_function y); plain BCs take two
                    if len(inspect.signature(fn).parameters) >= 3:
                        ri = fn(Pi, bcT["normals"][0], bcT["imd"][0])
                    else:
                        ri = fn(Pi, bcT["normals"][0])
                    sel = (bcT["family"][0] == i)[:, None]
                    r = ri if r is None else jnp.where(sel, ri, r)
                eta = bcT["eta"][0][:, None]
                g = eta * Pi + (1.0 - eta) * r
                if guard is not None:
                    g = guard(g)
                flat = flat.at[bcT["ghost"][0]].set(
                    g, mode="drop", unique_indices=True,
                    indices_are_sorted=True,
                )
                return flat.reshape(local.shape)

            ctx.exchange = exchange
            ctx.bc = bc

            if sbd._bbc_meta is not None:
                from ..topology.blocked_bc import local_blocked_bc

                bbc = local_blocked_bc(
                    jax.tree_util.tree_map(lambda a: a[0], t["bbc"]),
                    sbd._bbc_meta,
                )
                ctx.bbc = (lambda local, fns, guard=None:
                           bbc(local, fns, guard=guard))
            ctx.own = lambda loc: jax.lax.slice_in_dim(
                loc, 0, sbd.chunk, axis=0)
            ctx.pmin = lambda x: jax.lax.pmin(x, "p")
            ctx.pmax = lambda x: jax.lax.pmax(x, "p")
            ctx.psum = lambda x: jax.lax.psum(x, "p")
            ctx.rep = rep

            def all_gather_flat(own):
                """Own grids [chunk, bs.., C] -> replicated global flat
                [n_cells, C] (pad rows trimmed)."""
                g = jax.lax.all_gather(own, "p", axis=0, tiled=True)
                flat = g.reshape((sbd.P * sbd.chunk * sbd.npb,)
                                 + g.shape[1 + sbd.nd:])
                return jax.lax.slice_in_dim(
                    flat, 0, sbd.B * sbd.npb, axis=0)

            ctx.all_gather_flat = all_gather_flat

            def own_flat(flat):
                """Replicated global flat [n_cells, ...] -> own grids
                [chunk, bs.., ...] of this device (pad rows zero)."""
                pad = sbd.P * sbd.chunk * sbd.npb - sbd.B * sbd.npb
                if pad:
                    z = jnp.zeros((pad,) + flat.shape[1:], flat.dtype)
                    flat = jnp.concatenate([flat, z], axis=0)
                grids = flat.reshape(
                    (sbd.P, sbd.chunk) + (sbd.bs,) * sbd.nd
                    + flat.shape[1:])
                pidx = jax.lax.axis_index("p")
                return jax.lax.dynamic_index_in_dim(
                    grids, pidx, axis=0, keepdims=False)

            ctx.own_flat = own_flat

            if sbd.overlap:
                # interior pass tables (own blocks + dump; no halo rows,
                # hence no data dependence on the ppermute) and frontier
                # subgrid tables (halo-adjacent own blocks + 2-ring
                # support, compacted)
                ctx.bt_own = sbd._local_bt(t, "bt_own", sbd.B_own_loc)
                ctx.bt_sub = sbd._local_bt(t, "bt_sub", sbd.B_sub_loc)
                ctx.with_dump = lambda own: jnp.concatenate(
                    [own, own[:1]], axis=0)
                ctx.subgrid = lambda loc: jnp.take(
                    loc, t["sub_src"][0], axis=0)

                def merge(R_int, R_fr):
                    """Interior results overwritten at frontier blocks."""
                    Ri = jax.lax.slice_in_dim(R_int, 0, sbd.chunk, axis=0)
                    placed = jnp.take(R_fr, t["fr_idx"][0], axis=0)
                    m = t["fr_mask"][0].reshape(
                        (sbd.chunk,) + (1,) * (Ri.ndim - 1))
                    return jnp.where(m > 0, placed, Ri)

                ctx.merge = merge

            res = f(ctx, *(u[0] for u in shards))
            if not isinstance(res, (tuple, list)):
                res = (res,)
            return tuple(r[None] for r in res)

        cache = {}
        rep_spec = jax.tree_util.tree_map(
            lambda _: PartitionSpec(), replicated)

        def call(*shards):
            n = len(shards)
            if n not in cache:
                specs_in = (self._spec, rep_spec) + tuple(
                    PartitionSpec("p") for _ in range(n))
                cache[n] = jax.shard_map(
                    kernel, mesh=self.mesh, check_vma=False,
                    in_specs=specs_in, out_specs=PartitionSpec("p"),
                )
            return cache[n](self.tables, replicated, *shards)

        return call
