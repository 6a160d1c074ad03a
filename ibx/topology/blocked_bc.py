"""Block-structured ghost-cell BC imposition (the block fast path).

The eta-blended ghost update (reference ``src/ImmersedBoundary.jl:1159-1247``)
costs two row-indexed memory ops per application:

  * image-point interpolation: a [G, K]-stencil gather (K*G narrow rows);
  * ghost write-back: a [G]-row scatter.

Both are restructured here around the block layout ([B, bs, .., bs, C]
grids, `ibx.ops.block_ops`):

  * interpolation gathers ONE (2 x bs)-cell patch per ghost instead of K
    narrow rows whenever the stencil fits two adjacent block rows (~75% of
    stencils on the RAE2822 mesh); the weighted sum runs over the patch with
    a statically scattered weight table. Remaining stencils use per-point
    narrow gathers.
  * the write-back becomes: place blended ghost values into per-ghost-block
    dense grids via run-window gathers (sorted ghosts decompose into runs of
    consecutive cell ids = consecutive value rows AND consecutive block
    slots, so each run is ONE wide contiguous window of the value array),
    then scatter whole ghost-block rows (~500 wide rows instead of 24k
    narrow ones).

Numerics match `ibx.topology.domain.FusedBoundary` up to f32 summation
order (tests/test_blocked_bc.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..utils import pytree_dataclass

_PIB = lax.GatherScatterMode.PROMISE_IN_BOUNDS


def _take_mode():
    """Take mode for wb/dense row gathers.  "clip" is REQUIRED for the
    sharded stacked tables (their inert pads are deliberate OOB rows;
    the default "fill" mode would inject NaN).  IBX_BC_CLIP=0 restores
    the pre-round-5 default-mode lowering for single-chip A/Bs only."""
    import os

    return "clip" if os.environ.get("IBX_BC_CLIP", "1") != "0" else None


def _concat_layer_update(blk, ax, bs, layers, side, new_plane):
    """Rebuild ``blk`` with the boundary layers' planes replaced, as ONE
    `concatenate` along ``ax`` instead of per-layer dynamic-update-slices
    (build by concatenate).  ``new_plane(li, p)`` returns the masked replacement
    plane for layer index ``li`` at axis position ``p`` (without the axis
    dim); untouched index ranges are kept as contiguous slices."""
    pos = {(bs - 1 - l) if side else l: li for li, l in enumerate(layers)}
    pieces = []
    q = 0
    while q < bs:
        if q in pos:
            pieces.append(jnp.expand_dims(new_plane(pos[q], q), ax))
            q += 1
        else:
            q1 = q
            while q1 < bs and q1 not in pos:
                q1 += 1
            pieces.append(lax.slice_in_dim(blk, q, q1, axis=ax))
            q = q1
    if len(pieces) == 1:
        return pieces[0]
    return jnp.concatenate(pieces, axis=ax)


@pytree_dataclass(meta_fields=("names", "bs", "nd", "n_patch", "n_fb",
                               "fb_width", "g_pad_front", "g_pad_len",
                               "patch_win", "dense_spec"))
class BlockedBC:
    """Fused multi-family ghost BC on the block-grid state.

    Built by `build_blocked_bc`; apply with ``bc(P3, fns)`` where
    ``fns[name](P_image, normals) -> bc values`` (same contract as
    `FusedBoundary`).

    Image-point stencils are DEDUPLICATED: ghosts sharing an identical
    (index, weight) stencil row — every hypercube-family ghost column does,
    since its 2 (2D) / 3 (3D) layered ghosts project to the same plane
    point and image distance — interpolate once; ``g2u`` expands the unique
    image values back to per-ghost rows with one full-row take.
    """

    # image interpolation (over UNIQUE stencils, n_patch + n_fb rows)
    patch_start: jnp.ndarray   # int32[Up, nd] (block, (z0,) y0) patch starts
    patch_w: jnp.ndarray       # f32[Up, prod(win)*bs] scattered weights
    fb_cell: jnp.ndarray       # int32[Uf*K] flat cell ids per stencil point
    fb_w: jnp.ndarray          # f32[Uf, K]
    g2u: jnp.ndarray           # int32[G] ghost -> unique stencil row
    # BC data (canonical ghost order: sorted by global cell id)
    normals: jnp.ndarray       # f32[G, nd]
    eta: jnp.ndarray           # f32[G, 1]
    family: jnp.ndarray        # int32[G]
    image_distances: jnp.ndarray  # f32[G] (wall-model BCs need them)
    ghosts: jnp.ndarray        # int32[G] canonical-order global cell ids
    # phase-view run placement over ghost-containing 16-slot tiles only
    # (see `__call__`); E = number of such tiles
    tile_gid: jnp.ndarray      # int32[E] global tile row (blk*n_tiles + t)
    tile_row: jnp.ndarray      # int32[E, T] rows into the phase stack
    tile_lo: jnp.ndarray       # int32[E, T] first in-tile slot of the run
    tile_hi: jnp.ndarray       # int32[E, T] one-past-last slot
    tile_mask: jnp.ndarray     # f32[E, 16] 1 on ghost slots
    ovf_src: jnp.ndarray       # int32[O] g rows of overflow ghosts
    ovf_dst: jnp.ndarray       # int32[O] (e * 16 + slot) of those ghosts
    # union write-back (one full-view gather + one scatter per BC
    # application; all per-group reads/writes run on the gathered buffer)
    wb_blocks: jnp.ndarray     # int32[Bu] union of gblk/dense blocks
    tile_loc_u: jnp.ndarray    # int32[E] rank-in-wb*n_tiles + tile
    blk_mask_u: jnp.ndarray    # f32[Bu, bs^nd] 1 on ghost slots
    dense_slot: Tuple[jnp.ndarray, ...]  # int32[Bf] wb row per group
    # dense-plane hypercube fast path (one entry per (family, face)):
    # conforming farfield ghost planes are computed as static plane
    # algebra over gathered boundary-block rows — zero narrow gathers,
    # zero scatters. dense_spec entries are static:
    #   (family_idx, dim, side, layers, p0, p1, w0, etas)
    dense_mask: Tuple[jnp.ndarray, ...]   # f32[Bf, L, (bs,)*(nd-1)]
    dense_spec: Tuple
    names: Tuple[str, ...]
    bs: int
    nd: int
    n_patch: int
    n_fb: int
    fb_width: int
    g_pad_front: int
    g_pad_len: int
    patch_win: Tuple[int, ...]

    def interpolate(self, P3):
        """Image-point values [U, C] in canonical UNIQUE-stencil order
        (patch stencils first, then fallback); expand per-ghost with
        ``take(values, g2u)``."""
        bs, nd = self.bs, self.nd
        C = P3.shape[-1]
        parts = []
        if self.n_patch:
            win = self.patch_win    # ((wz,) wy): slow-dim window sizes
            # operand [B, (z,) y, x, C]; starts (b, (z0,) y0); the slice is
            # full-width in x and C
            dn = lax.GatherDimensionNumbers(
                offset_dims=tuple(range(1, nd + 2)),
                collapsed_slice_dims=(0,),
                start_index_map=tuple(range(nd)),
            )
            patch = lax.gather(
                P3, self.patch_start, dn,
                slice_sizes=(1,) + win + (bs, C),
                mode=_PIB,
            ).reshape(self.n_patch, int(np.prod(win)) * bs, C)
            parts.append((patch * self.patch_w[..., None]).sum(axis=1))
        if self.n_fb:
            # flat full-row takes (the block grid reshapes to [N, C] for
            # free). One take per stencil POINT, chained into the weighted
            # sum: the single [Uf*K]-row take materializes a [Uf, K, C]
            # cube whose reduction XLA lowers through a [C, Uf, K]
            # relayout; the chained form fuses each gather straight into
            # its multiply-add.
            P_flat = P3.reshape(-1, C)
            cells = self.fb_cell.reshape(self.n_fb, self.fb_width)
            acc = None
            for k in range(self.fb_width):
                t = jnp.take(P_flat, cells[:, k], axis=0) \
                    * self.fb_w[:, k:k + 1]
                acc = t if acc is None else acc + t
            parts.append(acc)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    def place(self, g):
        """[G, C] canonical-order values -> per-tile values [E, 16, C].

        Sorted ghosts decompose into runs of consecutive cell ids =
        consecutive value rows AND consecutive block slots, so placement is
        window extraction at static offsets, read as FULL rows of a 16-phase
        shifted view stack (partial-slice gathers lower to per-row
        dynamic-slice loops): phase p is the contiguous reslice g_flat[p*C:] viewed as
        [M, 16*C] rows; any 16-aligned tile of a run is one row of one
        phase. Per (ghost-containing 16-slot tile, covering run): one
        `take` row plus an interval mask. Only tiles that actually hold
        ghosts are assembled (a dense per-block grid wastes ~5x in 3D,
        where ghosts cover a few planes of a 4096-cell block).
        """
        C = g.shape[-1]
        E, T = self.tile_row.shape
        g_flat = jnp.concatenate([
            jnp.zeros((self.g_pad_front, C), g.dtype),
            g,
            jnp.zeros((self.g_pad_len - self.g_pad_front - g.shape[0], C),
                      g.dtype),
        ]).reshape(-1)
        M = (self.g_pad_len - 16) // 16
        phases = jnp.stack(
            [lax.dynamic_slice_in_dim(g_flat, p * C, M * 16 * C)
             .reshape(M, 16 * C) for p in range(16)]
        ).reshape(16 * M, 16 * C)
        rows = jnp.take(phases, self.tile_row.reshape(-1), axis=0)
        rows = rows.reshape(E, T, 16, C)
        j = jnp.arange(16, dtype=jnp.int32)
        m = ((j >= self.tile_lo[..., None]) & (j < self.tile_hi[..., None]))
        # where(), not multiply: a NaN in an unselected row slot must not
        # contaminate the tile (0 * NaN = NaN)
        placed = jnp.where(m[..., None], rows, 0.0).sum(axis=1)
        if self.ovf_src.shape[0]:
            # rare ghosts beyond T covering runs per tile: plain row scatter
            # (mode="drop": sharded stacks pad ovf_dst with distinct OOB
            # slots >= E*16, dropped here)
            placed = placed.reshape(E * 16, C).at[self.ovf_dst].set(
                jnp.take(g, self.ovf_src, axis=0),
                mode="drop", unique_indices=True, indices_are_sorted=True,
            ).reshape(E, 16, C)
        return placed

    def __call__(self, P3, fns: Dict[str, Callable], *,
                 guard: Callable = None,
                 mirror: Sequence[str] = (), mirror_scale=None):
        """Apply all families' BCs; returns the updated grid state.

        Write-back goes through the XLA phase-view placement + block-row
        scatter path.
        """
        if int(self.wb_blocks.shape[0]) == 0:
            return P3
        C = P3.shape[-1]
        npb = self.bs ** self.nd
        view = P3.reshape(P3.shape[0], npb * C)
        # ONE full-view row gather; every group below reads/writes the
        # small union buffer.  mode="clip": sharded
        # stacks pad wb_blocks with distinct OOB rows (>= B_loc) whose
        # reads clip to the last (dump) block and whose writes are
        # dropped by `_wb_scatter`; the default take mode fills NaN.
        buf = lax.optimization_barrier(
            jnp.take(view, self.wb_blocks, axis=0, mode=_take_mode()))
        if int(self.ghosts.shape[0]) == 0:
            # every ghost went through the dense-plane path
            dense_new = [self._dense_values(buf, i, fns, guard)
                         for i in range(len(self.dense_spec))]
            for i, planes in enumerate(dense_new):
                buf = self._dense_write(buf, i, planes)
            return self._wb_scatter(view, buf, P3.shape)
        Pi = jnp.take(self.interpolate(P3), self.g2u, axis=0)
        r = None
        for i, name in enumerate(self.names):
            ri = fns[name](Pi, self.normals)
            sel = (self.family == i)[:, None]
            r = ri if r is None else jnp.where(sel, ri, r)
        g = self.eta * Pi + (1.0 - self.eta) * r
        if mirror:
            # mirrored-ghost normal velocity (flagged deviation from the
            # reference blend, which gives the ghost +eta*u_n(image) — a
            # porous wall under near-wall vortical flow; the mirror makes
            # it -eta*u_n(image), an actual reflection): g_un -= 2 eta un_i
            nd = self.nd
            mm = None
            for i, name in enumerate(self.names):
                if name in mirror:
                    s = self.family == i
                    mm = s if mm is None else (mm | s)
            un_i = (Pi[:, 2:2 + nd] * self.normals).sum(axis=1)
            corr = jnp.where(mm, 2.0 * self.eta[:, 0] * un_i, 0.0)
            if mirror_scale is not None:
                # per-ghost gate (e.g. thin-geometry exclusion: mirroring
                # a trailing-edge sliver reflects BOTH surfaces into the
                # wake and blows up the startup transient)
                corr = corr * mirror_scale
            g = jnp.concatenate([
                g[:, :2],
                g[:, 2:2 + nd] - corr[:, None] * self.normals,
                g[:, 2 + nd:],
            ], axis=1)
        if guard is not None:
            # keep blended ghosts physical: linear image-point stencils can
            # extrapolate (negative weights) at thin geometry - unguarded
            # negative ghost pressures at the trailing edge cascade into
            # NaN on fine meshes (~11k steps at wall_h=5e-4)
            g = guard(g)

        # dense-plane groups: compute ghost-plane values from the INPUT
        # state (matching the canonical semantics: every family's image
        # interpolation reads the pre-write state), write after the
        # general path's write-back
        dense_new = [self._dense_values(buf, i, fns, guard)
                     for i in range(len(self.dense_spec))]
        buf = self._ghost_write(buf, g)
        for i, planes in enumerate(dense_new):
            buf = self._dense_write(buf, i, planes)
        return self._wb_scatter(view, buf, P3.shape)

    def _wb_scatter(self, view, buf, shape):
        """ONE row scatter of the (barrier-pinned) union buffer back into
        the full-state row view."""
        return view.at[self.wb_blocks].set(
            lax.optimization_barrier(buf),
            mode="drop", unique_indices=True, indices_are_sorted=True,
        ).reshape(shape)

    def _ghost_write(self, buf, g):
        """Masked merge of the placed general-path ghosts into the union
        buffer ([Bu, npb*C] cell-major rows)."""
        E = int(self.tile_gid.shape[0])
        if E == 0:
            return buf
        C = g.shape[-1]
        npb = self.bs ** self.nd
        n_tiles = npb // 16
        Bu = int(self.wb_blocks.shape[0])
        placed = self.place(g)
        dense = jnp.zeros((Bu * n_tiles, 16 * C), g.dtype).at[
            self.tile_loc_u].set(
            placed.reshape(E, 16 * C),
            mode="drop", unique_indices=True, indices_are_sorted=True,
        ).reshape(Bu, npb, C)
        # where(), not blend-by-multiply: NaN in non-ghost placed slots
        # must not contaminate the kept state
        new = jnp.where(self.blk_mask_u[..., None] > 0, dense,
                        buf.reshape(Bu, npb, C))
        return new.reshape(Bu, npb * C)

    def _dense_values(self, buf, i, fns, guard):
        """Ghost-plane values for dense group ``i``: [L, Bf, lat.., C].
        ``buf``: the pre-write union buffer ([Bu, npb*C] cell-major
        rows)."""
        fam, d, side, layers, p0, p1, w0, w1, etas = self.dense_spec[i]
        bs, nd = self.bs, self.nd
        npb = bs ** nd
        C = buf.shape[-1] // npb
        rows = self.dense_slot[i]
        blk = jnp.take(buf, rows, axis=0, mode=_take_mode())
        blk = blk.reshape((rows.shape[0],) + (bs,) * nd + (C,))
        ax = 1 + (nd - 1 - d)
        Pi = (w0 * lax.index_in_dim(blk, p0, axis=ax, keepdims=False)
              + w1 * lax.index_in_dim(blk, p1, axis=ax, keepdims=False))
        flat = Pi.reshape(-1, C)
        nvec = np.zeros(nd, np.float32)
        nvec[d] = -1.0 if side else 1.0
        nrm = jnp.broadcast_to(jnp.asarray(nvec), (flat.shape[0], nd))
        r = fns[self.names[fam]](flat, nrm)
        out = []
        for eta in etas:
            gl = eta * flat + (1.0 - eta) * r
            if guard is not None:
                gl = guard(gl)
            out.append(gl.reshape(Pi.shape))
        return jnp.stack(out)

    def _dense_write(self, buf, i, planes):
        """Masked RMW of group ``i``'s ghost planes into the union
        buffer ([Bu, npb*C] cell-major rows)."""
        fam, d, side, layers, p0, p1, w0, w1, etas = self.dense_spec[i]
        bs, nd = self.bs, self.nd
        npb = bs ** nd
        C = buf.shape[-1] // npb
        rows = self.dense_slot[i]
        mask = self.dense_mask[i]
        blk = jnp.take(buf, rows, axis=0, mode=_take_mode())
        blk = blk.reshape((rows.shape[0],) + (bs,) * nd + (C,))
        ax = 1 + (nd - 1 - d)

        def new_plane(li, p):
            old = lax.index_in_dim(blk, p, axis=ax, keepdims=False)
            m = mask[:, li][..., None]
            return jnp.where(m > 0, planes[li], old)

        blk = _concat_layer_update(blk, ax, bs, layers, side, new_plane)
        return buf.at[rows].set(
            blk.reshape(rows.shape[0], -1),
            mode="drop", unique_indices=True, indices_are_sorted=True,
        )


def _collect_families(dom, names: Sequence[str]) -> dict:
    """Claimed-dedup (last listed family wins, matching the sequential
    ``impose_bc`` semantics of the reference,
    ``src/ImmersedBoundary.jl:1197-1247``) + concat of the named families'
    host-boundary arrays into one canonical ghost set in the domain's
    flat cell-id space."""
    ghost_l, idx_l, w_l, nrm_l, eta_l, fam_l = [], [], [], [], [], []
    imd_l = []
    claimed = {}
    for i, name in enumerate(names):
        hb = dom._host_boundaries[name]
        for g in hb.ghosts:
            claimed[int(g)] = i
    for i, name in enumerate(names):
        hb = dom._host_boundaries[name]
        keep = np.array([claimed[int(g)] == i for g in hb.ghosts],
                        dtype=bool)
        ghost_l.append(hb.ghosts[keep])
        idx_l.append(hb.interp_idx[keep])
        w_l.append(hb.interp_w[keep])
        nrm_l.append(hb.normals[keep])
        eta_l.append((hb.ghost_distances / hb.image_distances)[keep])
        imd_l.append(hb.image_distances[keep])
        fam_l.append(np.full(int(keep.sum()), i, dtype=np.int32))
    ghosts = np.concatenate(ghost_l)
    if np.unique(ghosts).size != ghosts.size:
        raise ValueError("fused families share ghost cells")
    K = max(a.shape[1] for a in idx_l)

    def padk(a, repeat_first):
        if a.shape[1] == K:
            return a
        fill = a[:, :1] if repeat_first else np.zeros_like(a[:, :1])
        return np.concatenate(
            [a] + [fill] * (K - a.shape[1]), axis=1)

    return dict(
        ghosts=ghosts.astype(np.int64),
        idx=np.concatenate([padk(a, True) for a in idx_l]).astype(np.int64),
        w=np.concatenate([padk(a, False) for a in w_l]).astype(np.float32),
        normals=np.concatenate(nrm_l).astype(np.float32),
        eta=np.concatenate(eta_l).astype(np.float32),
        imd=np.concatenate(imd_l).astype(np.float32),
        family=np.concatenate(fam_l),
    )


def _dense_conf(bs: int, nd: int, fams: dict, fsel: np.ndarray) -> dict:
    """Per-ghost conformance data for the dense-plane template algebra
    over the family subset ``fsel``.  All quantities are invariant under
    block-grid relocalization (within-block offsets and stencil weights
    survive the global->local block remap), so templates discovered on
    the global grid apply verbatim to per-device local grids."""
    npb = bs ** nd
    strides = np.array([bs ** k for k in range(nd)], np.int64)
    n_f = fams["normals"][fsel]
    d_ax = np.abs(n_f).argmax(1)
    ar = np.arange(fsel.size)
    unit = np.abs(np.abs(n_f[ar, d_ax]) - 1.0) < 1e-6
    w_f = fams["w"][fsel]
    idx_f = fams["idx"][fsel]
    k2 = (np.abs(w_f[:, 2:]).max(1) == 0.0) if w_f.shape[1] > 2 \
        else np.ones(fsel.size, bool)
    g_f = fams["ghosts"][fsel]
    blk_f = g_f // npb
    wi = g_f % npb
    coords = np.stack([(wi // strides[k]) % bs for k in range(nd)], 1)
    i0, i1 = idx_f[:, 0], idx_f[:, 1]
    same_blk = (i0 // npb == blk_f) & (i1 // npb == blk_f)
    c0 = np.stack([((i0 % npb) // strides[k]) % bs
                   for k in range(nd)], 1)
    c1 = np.stack([((i1 % npb) // strides[k]) % bs
                   for k in range(nd)], 1)
    lat_ok = np.ones(fsel.size, bool)
    for k in range(nd):
        lat_ok &= np.where(d_ax != k,
                           (c0[:, k] == coords[:, k])
                           & (c1[:, k] == coords[:, k]), True)
    side = n_f[ar, d_ax] < 0        # inward normal -e_d -> plus face
    cd = coords[ar, d_ax]
    layer = np.where(side, bs - 1 - cd, cd)
    conf = unit & k2 & same_blk & lat_ok & (layer < bs // 2)
    p0 = c0[ar, d_ax]
    p1 = c1[ar, d_ax]
    w0 = w_f[:, 0]
    key = (p0.astype(np.int64) * npb + p1) * (1 << 32) \
        + np.ascontiguousarray(w0).view(np.uint32)
    return dict(conf=conf, d_ax=d_ax, side=side, layer=layer, key=key,
                p0=p0, p1=p1, w0=w0, w1=w_f[:, 1], blk_f=blk_f,
                coords=coords)


def _f32_bits(x) -> np.uint32:
    return np.asarray(x, np.float32).view(np.uint32)[()]


def _compile_bc_tables(bs: int, nd: int, fams: dict, hcube_fam_idx,
                       *, dense_templates=None, force_pad_len=None,
                       force_T=None):
    """Core host compiler: family arrays (any flat block-major cell-id
    space) -> BlockedBC numpy tables.

    ``dense_templates``: when given (the sharded per-device build), skip
    template discovery and assign ghosts to exactly these groups with no
    minimum-count thresholds — every device then shares one static
    ``dense_spec`` (shard_map traces a single program), possibly with
    empty per-device groups.  ``force_pad_len`` / ``force_T`` pin the
    placement-table geometry to common values across devices.

    Returns ``(fields, meta, templates)``: numpy leaf dict, static-meta
    dict, and the dense template list (discovered or passed through).
    """
    npb = bs ** nd
    ghosts = fams["ghosts"]
    idx = fams["idx"]
    w = fams["w"]
    normals = fams["normals"]
    eta = fams["eta"]
    imd = fams["imd"]
    family = fams["family"]
    K = idx.shape[1]

    # ---- dense-plane hypercube groups --------------------------------------
    # Hypercube-family ghosts with exact unit-axis normals and the 2-point
    # same-block axis stencil (domain.py `axis_stencils`) conform to ONE
    # template per (face, layer): their BC application becomes static
    # plane algebra over gathered boundary-block rows. On the 5.3M-cell
    # sphere this removes ~96% of the 122k farfield ghosts (~1M narrow
    # gather rows per application) from the general path.
    dense_rows_l, dense_mask_l, dense_spec_l = [], [], []
    dense_sel = np.zeros(ghosts.size, bool)

    def emit_group(cf, fsel, mi, spec):
        fam_i, d, s, layers, p0, p1, w0, w1, etas = spec
        Lh = len(layers)
        if mi.size:
            blk_f = cf["blk_f"]
            coords = cf["coords"]
            layer = cf["layer"]
            blocks = np.unique(blk_f[mi])
            b2r = {int(b): r for r, b in enumerate(blocks)}
            l2i = {l: i for i, l in enumerate(layers)}
            mask = np.zeros((blocks.size, Lh) + (bs,) * (nd - 1),
                            np.float32)
            lat_dims = [k for k in range(nd - 1, -1, -1) if k != d]
            for gi in mi:
                pos = tuple(int(coords[gi, k]) for k in lat_dims)
                mask[(b2r[int(blk_f[gi])], l2i[int(layer[gi])])
                     + pos] = 1.0
            dense_sel[fsel[mi]] = True
        else:
            blocks = np.zeros(0, np.int64)
            mask = np.zeros((0, Lh) + (bs,) * (nd - 1), np.float32)
        dense_rows_l.append(blocks.astype(np.int32))
        dense_mask_l.append(mask)
        dense_spec_l.append(spec)

    if dense_templates is None:
        min_count = 4 * bs ** (nd - 1)
        for fam_i in sorted(hcube_fam_idx):
            fsel = np.nonzero(family == fam_i)[0]
            if not fsel.size:
                continue
            cf = _dense_conf(bs, nd, fams, fsel)
            eta_f = np.ascontiguousarray(eta[fsel], np.float32)
            eta_u32 = eta_f.view(np.uint32)
            for d in range(nd):
                for s in (False, True):
                    mf = cf["conf"] & (cf["d_ax"] == d) & (cf["side"] == s)
                    if mf.sum() < min_count:
                        continue
                    # one dense group per (p0, p1, w0-bits) template over
                    # the face — octrees with several block sizes at the
                    # boundary produce one template per size octave, and
                    # EVERY large one must go dense (the round-3
                    # majority-only selection left ~46k conforming
                    # farfield ghosts on the 5.3M sphere to the general
                    # gather path)
                    vals, cnts = np.unique(cf["key"][mf],
                                           return_counts=True)
                    for tkey in vals[cnts >= min_count]:
                        m = mf & (cf["key"] == tkey)
                        # per-layer eta must be single-valued (scale-
                        # invariant: eta = (l+.5)/(1.5*sqrt(nd))); drop
                        # deviating ghosts
                        for l in np.unique(cf["layer"][m]):
                            ml = m & (cf["layer"] == l)
                            ev, ec = np.unique(eta_u32[ml],
                                               return_counts=True)
                            m &= ~(ml & (eta_u32 != ev[ec.argmax()]))
                        layers = [int(l) for l in np.unique(cf["layer"][m])]
                        if not layers or m.sum() < min_count:
                            continue
                        etas = [float(eta_f[m & (cf["layer"] == l)][0])
                                for l in layers]
                        mi = np.nonzero(m)[0]
                        spec = (int(fam_i), int(d), bool(s), tuple(layers),
                                int(cf["p0"][mi[0]]), int(cf["p1"][mi[0]]),
                                float(cf["w0"][mi[0]]),
                                float(cf["w1"][mi[0]]), tuple(etas))
                        emit_group(cf, fsel, mi, spec)
    else:
        # template mode: exact global membership predicate, no thresholds
        cf_cache = {}
        for spec in dense_templates:
            fam_i, d, s, layers, p0t, p1t, w0t, w1t, etas = spec
            fsel = np.nonzero(family == fam_i)[0]
            if fsel.size:
                if fam_i not in cf_cache:
                    cf_cache[fam_i] = _dense_conf(bs, nd, fams, fsel)
                cf = cf_cache[fam_i]
                tkey = ((np.int64(p0t) * npb + np.int64(p1t)) * (1 << 32)
                        + np.int64(_f32_bits(w0t)))
                eta_u32 = np.ascontiguousarray(
                    eta[fsel], np.float32).view(np.uint32)
                m = (cf["conf"] & (cf["d_ax"] == d) & (cf["side"] == s)
                     & (cf["key"] == tkey))
                sel_le = np.zeros(fsel.size, bool)
                for l, e in zip(layers, etas):
                    sel_le |= (cf["layer"] == l) & (eta_u32 == _f32_bits(e))
                mi = np.nonzero(m & sel_le)[0]
            else:
                cf = None
                mi = np.zeros(0, np.int64)
            emit_group(cf, fsel, mi, spec)

    if dense_sel.any():
        keep = ~dense_sel
        ghosts = ghosts[keep]
        idx = idx[keep]
        w = w[keep]
        normals = normals[keep]
        eta = eta[keep]
        imd = imd[keep]
        family = family[keep]

    # ---- stencil dedup -----------------------------------------------------
    # Hypercube-family ghost columns share image points exactly (same plane
    # projection, same image distance), so their (idx, w) stencil rows are
    # bit-identical: interpolate each unique stencil once and expand with a
    # full-row take. On the 5.3M-cell sphere this collapses the 122k
    # farfield ghosts to ~1/3 as many interpolations.
    key = np.concatenate(
        [idx.astype(np.int64),
         np.ascontiguousarray(w, np.float32).view(np.uint32).astype(np.int64)],
        axis=1)
    _, first, g2u_pre = np.unique(
        key, axis=0, return_index=True, return_inverse=True)
    u_idx = idx[first]
    u_w = w[first]
    U = first.size

    # ---- patch eligibility: unique stencil fits one same-block window of
    # full-x rows (win = (WY,) rows in 2D, (WZ, WY) row-planes in 3D) ----
    win = (min(3, bs),) if nd == 2 else (min(2, bs), min(2, bs))
    sblk = u_idx // npb
    same = (sblk == sblk[:, :1]).all(axis=1)
    within_idx = u_idx % npb
    rows = within_idx // bs            # y in 2D; (z*bs + y) // bs in 3D
    if nd == 2:
        spans = [rows % bs]
    else:
        spans = [within_idx // bs ** 2, rows % bs]   # z, y
    eligible = same
    for sp, wdim in zip(spans, win):
        eligible = eligible & (
            (sp.max(axis=1) - sp.min(axis=1)) <= wdim - 1)
    if nd == 3:
        # 3D patch windows are a measured LOSS on the 5.3M-cell sphere
        # bench vs the k=8 per-point fallback (36.4M cell-updates/s/chip):
        # (3,3) = 9 full [16, C] rows/ghost -> 29.9M; even (2,2) = 4 rows
        # -> 32.3M. Full-row gathers at 16 x C width are NOT free relative
        # to narrow rows at this ghost count (148k), so the fallback path
        # stays. In 2D the (3,) window IS the win (3 rows vs 4-8) and
        # stays on.
        eligible[:] = False

    # canonical unique order: patch stencils first, then fallback
    u_order = np.argsort(~eligible, kind="stable")
    u_rank = np.empty(U, dtype=np.int64)
    u_rank[u_order] = np.arange(U)
    g2u = u_rank[g2u_pre].astype(np.int32)
    u_idx = u_idx[u_order]
    u_w = u_w[u_order]
    Up = int(eligible.sum())
    Uf = U - Up

    # canonical ghost order: id-sorted (maximises consecutive-id runs for
    # the write-back placement)
    order = np.argsort(ghosts)
    ghosts_c = ghosts[order]
    g2u = g2u[order]
    G = ghosts.size
    blk_c = ghosts_c // npb
    within_c = ghosts_c % npb

    # ---- patch tables ------------------------------------------------------
    nwin = int(np.prod(win))
    if Up:
        pidx = u_idx[:Up]
        pw = u_w[:Up]
        pb = (pidx[:, 0] // npb).astype(np.int32)
        pwithin = pidx % npb
        pcol = pwithin % bs
        if nd == 2:
            pspans = [pwithin // bs]
        else:
            pspans = [pwithin // bs ** 2, (pwithin // bs) % bs]
        starts, rr = [pb], np.zeros_like(pcol)
        for sp, wdim in zip(pspans, win):
            s0 = np.minimum(sp.min(axis=1), bs - wdim).astype(np.int32)
            starts.append(s0)
            rr = rr * wdim + (sp - s0[:, None])
        rr = rr * bs + pcol
        patch_start = np.stack(starts, axis=1).astype(np.int32)
        patch_w = np.zeros((Up, nwin * bs), dtype=np.float32)
        np.add.at(patch_w, (np.arange(Up)[:, None], rr), pw)
    else:
        patch_start = np.zeros((0, nd), np.int32)
        patch_w = np.zeros((0, nwin * bs), np.float32)

    # ---- fallback tables ---------------------------------------------------
    if Uf:
        fb_cell = u_idx[Up:].reshape(-1).astype(np.int32)
        fb_w = u_w[Up:]
    else:
        fb_cell = np.zeros(0, np.int32)
        fb_w = np.zeros((0, K), np.float32)

    # ---- runs -> per-ghost-tile phase-view rows -----------------------------
    n_tiles = npb // 16
    pad_front = ((npb + 15) // 16 + 1) * 16   # window starts >= -npb
    pad_len = ((pad_front + G + 16 * 2 + 15) // 16) * 16 + 16
    if force_pad_len is not None:
        assert force_pad_len >= pad_len, "forced pad_len too small"
        pad_len = int(force_pad_len)
    M = (pad_len - 16) // 16
    if G:
        brk = np.zeros(G, dtype=bool)
        brk[0] = True
        if G > 1:
            brk[1:] = (np.diff(ghosts_c) != 1) | (np.diff(blk_c) != 0)
        starts = np.nonzero(brk)[0]
        lens = np.diff(np.concatenate([starts, [G]]))
        run_blk = blk_c[starts]
        run_s0 = within_c[starts]
        # entries[tile_gid] -> list of (phase_row, lo, hi, g_off_of_lo);
        # tile_gid = block * n_tiles + tile indexes the
        # [B * n_tiles, 16 * C] row view of the state
        entries = {}
        for rs0, rlen, rblk, rgoff in zip(run_s0, lens, run_blk, starts):
            for t in range(int(rs0) // 16,
                           (int(rs0) + int(rlen) + 15) // 16):
                a = pad_front + int(rgoff) - int(rs0) + 16 * t
                row = (a % 16) * M + a // 16
                lo = max(int(rs0) - 16 * t, 0)
                hi = min(int(rs0) + int(rlen) - 16 * t, 16)
                goff_lo = int(rgoff) + max(16 * t - int(rs0), 0)
                gid = int(rblk) * n_tiles + t
                entries.setdefault(gid, []).append((row, lo, hi, goff_lo))
        gids = np.asarray(sorted(entries), np.int64)
        g2e = {int(g): e for e, g in enumerate(gids)}
        E = gids.size
        # T covering runs per tile handled densely; overflow (rare) falls
        # back to a row scatter of the remaining ghosts
        T = min(2, max(len(v) for v in entries.values()))
        if force_T is not None:
            T = int(force_T)
        tile_row = np.zeros((E, T), np.int32)
        tile_lo = np.zeros((E, T), np.int32)
        tile_hi = np.zeros((E, T), np.int32)   # hi=0 -> empty mask
        ovf_src, ovf_dst = [], []
        for gid, ent in entries.items():
            e = g2e[gid]
            for j, (row, lo, hi, goff_lo) in enumerate(ent):
                if j < T:
                    tile_row[e, j] = row
                    tile_lo[e, j] = lo
                    tile_hi[e, j] = hi
                else:
                    for s in range(lo, hi):
                        ovf_src.append(goff_lo + (s - lo))
                        ovf_dst.append(e * 16 + s)
        if ovf_dst:
            ovf_order = np.argsort(ovf_dst)
            ovf_src = np.asarray(ovf_src, np.int32)[ovf_order]
            ovf_dst = np.asarray(ovf_dst, np.int32)[ovf_order]
        else:
            ovf_src = np.zeros(0, np.int32)
            ovf_dst = np.zeros(0, np.int32)
        tile_mask = np.zeros((E, 16), np.float32)
        e_of_ghost = np.asarray(
            [g2e[int(b) * n_tiles + int(wi) // 16]
             for b, wi in zip(blk_c, within_c)])
        tile_mask[e_of_ghost, within_c % 16] = 1.0
        gblk = np.unique(gids // n_tiles)
    else:
        T = int(force_T) if force_T is not None else 1
        gids = np.zeros((0,), np.int64)
        tile_row = np.zeros((0, T), np.int32)
        tile_lo = np.zeros((0, T), np.int32)
        tile_hi = np.zeros((0, T), np.int32)
        ovf_src = np.zeros(0, np.int32)
        ovf_dst = np.zeros(0, np.int32)
        tile_mask = np.zeros((0, 16), np.float32)
        gblk = np.zeros(0, np.int64)

    # ---- union write-back tables -------------------------------------------
    # ONE full-view row gather + ONE row scatter per BC application: the
    # ghost-bearing and dense-plane blocks are unioned into wb_blocks;
    # every per-group take/set then runs against the small gathered
    # buffer.
    wb_parts = ([gblk.astype(np.int64)]
                + [r.astype(np.int64) for r in dense_rows_l])
    wb_blocks = (np.unique(np.concatenate(wb_parts)) if wb_parts
                 else np.zeros(0, np.int64))
    tile_loc_u = np.zeros(0, np.int32)
    blk_mask_u = np.zeros((wb_blocks.size, npb), np.float32)
    if G:
        urank_of = np.searchsorted(wb_blocks, gids // n_tiles)
        tile_loc_u = (urank_of * n_tiles + gids % n_tiles).astype(np.int32)
        bm = np.zeros((wb_blocks.size * n_tiles, 16), np.float32)
        bm[tile_loc_u] = tile_mask
        blk_mask_u = bm.reshape(wb_blocks.size, npb)
    dense_slot = tuple(
        np.searchsorted(wb_blocks, r.astype(np.int64)).astype(np.int32)
        for r in dense_rows_l)

    fields = dict(
        patch_start=patch_start,
        patch_w=patch_w,
        fb_cell=fb_cell,
        fb_w=np.ascontiguousarray(fb_w, dtype=np.float32),
        g2u=g2u,
        normals=normals[order],
        eta=eta[order][:, None],
        image_distances=imd[order],
        family=family[order].astype(np.int32),
        ghosts=ghosts_c.astype(np.int32),
        tile_gid=gids.astype(np.int32),
        tile_row=tile_row,
        tile_lo=tile_lo,
        tile_hi=tile_hi,
        tile_mask=tile_mask,
        ovf_src=ovf_src,
        ovf_dst=ovf_dst,
        wb_blocks=wb_blocks.astype(np.int32),
        tile_loc_u=tile_loc_u,
        blk_mask_u=blk_mask_u,
        dense_slot=dense_slot,
        dense_mask=tuple(dense_mask_l),
    )
    meta = dict(
        n_patch=Up,
        n_fb=Uf,
        fb_width=K,
        g_pad_front=pad_front,
        g_pad_len=pad_len,
        patch_win=win,
        dense_spec=tuple(dense_spec_l),
    )
    return fields, meta, dense_spec_l


def _hcube_fam_idx(dom, names, dense_families):
    hcube_names = {n for n, _ in
                   dom.reconstruction_kwargs.get("hypercube_families", [])}
    if dense_families is not None:
        hcube_names &= set(dense_families)
    return {i for i, n in enumerate(names) if n in hcube_names}


def build_blocked_bc(dom, names: Sequence[str],
                     dense_families: Optional[Sequence[str]] = None,
                     ) -> BlockedBC:
    """Host compiler: fuse ``names`` families into a BlockedBC.

    Requires a single-partition domain (global index space).

    ``dense_families`` restricts the dense-plane fast path to the named
    hypercube families (default: all of them). The dense path evaluates a
    family's BC callback column-wise on plane-shaped inputs, so it is only
    valid for callbacks that are pure functions of ``(Si, nrm)`` — exclude
    any family whose callback closes over per-ghost tables (e.g. the
    flat-plate wall-function BC, which indexes ``image_distances`` in the
    general path's ghost order).
    """
    if dom.n_partitions != 1:
        raise ValueError("build_blocked_bc requires n_partitions == 1")
    msh = dom.mesh
    bs = int(msh.block_size)
    nd = msh.ndim
    names = list(names)
    fams = _collect_families(dom, names)
    fields, meta, _ = _compile_bc_tables(
        bs, nd, fams, _hcube_fam_idx(dom, names, dense_families))
    return _make_blocked_bc(fields, meta, names, bs, nd)


def _make_blocked_bc(fields, meta, names, bs, nd) -> BlockedBC:
    arr = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
               else jnp.asarray(v))
           for k, v in fields.items()}
    bc = BlockedBC(
        **arr,
        dense_spec=tuple(meta["dense_spec"]),
        names=tuple(names),
        bs=bs,
        nd=nd,
        n_patch=meta["n_patch"],
        n_fb=meta["n_fb"],
        fb_width=meta["fb_width"],
        g_pad_front=meta["g_pad_front"],
        g_pad_len=meta["g_pad_len"],
        patch_win=meta["patch_win"],
    )
    return jax.device_put(bc)


def build_blocked_bc_stacked(dom, names: Sequence[str], own_of_block,
                             g2l_list, B_loc: int,
                             dense_families: Optional[Sequence[str]] = None,
                             ):
    """Per-device BlockedBC tables for the sharded block runtime
    (VERDICT r4 item 1: the production BC fast paths must run under the
    sharded march, not only single-chip).

    Each device's own ghosts (ghost block owned per ``own_of_block``) are
    compiled into BlockedBC tables over the device's LOCAL block grid
    (``B_loc`` rows = own chunk + halo + dump; ``g2l_list[p]`` maps
    global block id -> local row, -1 where absent).  Dense-plane
    templates are discovered ONCE on the global ghost set so every
    device shares the same static ``dense_spec`` (shard_map traces one
    program for all devices); per-device leaves are padded to common
    shapes with inert entries — weight-0 stencils, OOB write slots
    dropped by the ``mode="drop"`` scatters, OOB read slots clipped.

    Returns ``(stacked, meta)``: ``stacked`` = numpy leaves with a
    leading device axis (tuples of such for dense groups); ``meta`` =
    kwargs for `local_blocked_bc`.
    """
    if dom.n_partitions != 1:
        raise ValueError("build from a single-partition Domain")
    msh = dom.mesh
    bs = int(msh.block_size)
    nd = msh.ndim
    npb = bs ** nd
    names = list(names)
    fams = _collect_families(dom, names)
    hidx = _hcube_fam_idx(dom, names, dense_families)
    # global template discovery (tables discarded; host-side, cheap
    # relative to the Domain build)
    _, _, templates = _compile_bc_tables(bs, nd, fams, hidx)

    P = len(g2l_list)
    own_of_block = np.asarray(own_of_block)
    owner_g = own_of_block[fams["ghosts"] // npb]
    G_max = max(1, int(np.max(np.bincount(owner_g, minlength=P))))
    pad_front = ((npb + 15) // 16 + 1) * 16
    pad_len = ((pad_front + G_max + 16 * 2 + 15) // 16) * 16 + 16

    tabs, metas = [], []
    for p in range(P):
        sel = owner_g == p
        g2l = np.asarray(g2l_list[p])
        f = {k: v[sel] for k, v in fams.items()}
        gb = f["ghosts"] // npb
        ib = f["idx"] // npb
        assert (g2l[gb] >= 0).all(), "own ghost outside local grid"
        assert (g2l[ib] >= 0).all(), "BC stencil escaped the halo set"
        f["ghosts"] = g2l[gb] * npb + f["ghosts"] % npb
        f["idx"] = g2l[ib] * npb + f["idx"] % npb
        fields, meta, _ = _compile_bc_tables(
            bs, nd, f, hidx, dense_templates=templates,
            force_pad_len=pad_len, force_T=2)
        tabs.append(fields)
        metas.append(meta)

    stacked = _stack_bc_fields(tabs, metas, bs, nd, B_loc, len(templates))
    meta = dict(
        names=tuple(names),
        bs=bs,
        nd=nd,
        n_patch=max(m["n_patch"] for m in metas),
        n_fb=max(m["n_fb"] for m in metas),
        fb_width=metas[0]["fb_width"],
        g_pad_front=pad_front,
        g_pad_len=pad_len,
        patch_win=metas[0]["patch_win"],
        dense_spec=tuple(templates),
    )
    return stacked, meta


def _stack_bc_fields(tabs, metas, bs, nd, B_loc, n_groups):
    """Stack per-device BlockedBC numpy tables with inert padding (see
    `build_blocked_bc_stacked` for the padding contract)."""
    npb = bs ** nd
    n_tiles = npb // 16

    def pad_rows(a, n, fill=0):
        if a.shape[0] == n:
            return a
        pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad], axis=0)

    def pad_iota(a, n, base):
        """Pad with base + j: distinct ascending OOB slots (reads clip,
        writes drop)."""
        if a.shape[0] == n:
            return a
        extra = (base + np.arange(n - a.shape[0])).astype(a.dtype)
        return np.concatenate([a, extra], axis=0)

    Up_max = max(m["n_patch"] for m in metas)
    Uf_max = max(m["n_fb"] for m in metas)
    K = metas[0]["fb_width"]
    G_max = max(t["g2u"].shape[0] for t in tabs)
    E_max = max(t["tile_gid"].shape[0] for t in tabs)
    O_max = max(t["ovf_src"].shape[0] for t in tabs)
    Bu_max = max(t["wb_blocks"].shape[0] for t in tabs)
    Bf_max = [max(t["dense_slot"][g].shape[0] for t in tabs)
              for g in range(n_groups)]

    out = {}

    def put(k, v):
        out.setdefault(k, []).append(v)

    for t, m in zip(tabs, metas):
        Up, Uf = m["n_patch"], m["n_fb"]
        G = t["g2u"].shape[0]
        # unique-value rows concat as [patch(Up_max), fb(Uf_max)]: shift
        # fb-range g2u entries by the patch padding
        g2u = t["g2u"].astype(np.int64)
        g2u = np.where(g2u < Up, g2u, g2u + (Up_max - Up)).astype(np.int32)
        put("patch_start", pad_rows(t["patch_start"], Up_max))
        put("patch_w", pad_rows(t["patch_w"], Up_max))
        put("fb_cell",
            pad_rows(t["fb_cell"].reshape(Uf, K), Uf_max).reshape(-1))
        put("fb_w", pad_rows(t["fb_w"], Uf_max))
        put("g2u", pad_rows(g2u, G_max))
        nrm = t["normals"]
        if nrm.shape[0] < G_max:
            padn = np.zeros((G_max - nrm.shape[0], nd), np.float32)
            padn[:, 0] = 1.0    # unit pad normal: keeps BC callbacks finite
            nrm = np.concatenate([nrm, padn], axis=0)
        put("normals", nrm)
        put("eta", pad_rows(t["eta"], G_max))
        put("image_distances",
            pad_rows(t["image_distances"], G_max, fill=1.0))
        put("family", pad_rows(t["family"], G_max))
        put("ghosts", pad_rows(t["ghosts"], G_max))
        put("tile_gid", pad_rows(t["tile_gid"], E_max))
        put("tile_row", pad_rows(t["tile_row"], E_max))
        put("tile_lo", pad_rows(t["tile_lo"], E_max))
        put("tile_hi", pad_rows(t["tile_hi"], E_max))
        put("tile_mask", pad_rows(t["tile_mask"], E_max))
        put("tile_loc_u",
            pad_iota(t["tile_loc_u"], E_max, Bu_max * n_tiles))
        put("ovf_src", pad_rows(t["ovf_src"], O_max))
        put("ovf_dst", pad_iota(t["ovf_dst"], O_max, E_max * 16))
        put("wb_blocks", pad_iota(t["wb_blocks"], Bu_max, B_loc))
        put("blk_mask_u", pad_rows(t["blk_mask_u"], Bu_max))
        for g in range(n_groups):
            put(f"dense_slot_{g}",
                pad_iota(t["dense_slot"][g], Bf_max[g], Bu_max))
            put(f"dense_mask_{g}", pad_rows(t["dense_mask"][g], Bf_max[g]))

    stacked = {k: np.stack(v) for k, v in out.items()}
    # fold group leaves back into tuples (pytree-friendly)
    stacked["dense_slot"] = tuple(
        stacked.pop(f"dense_slot_{g}") for g in range(n_groups))
    stacked["dense_mask"] = tuple(
        stacked.pop(f"dense_mask_{g}") for g in range(n_groups))
    return stacked


def local_blocked_bc(t, meta) -> BlockedBC:
    """Assemble a per-device BlockedBC inside a shard_map kernel from this
    device's slice of the stacked tables (leading device axis already
    stripped by the caller)."""
    return BlockedBC(**t, **meta)
