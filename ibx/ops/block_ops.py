"""Dense block-structured operators: the block fast path (device side).

State lives as [B, bs, ..., bs, C] block grids (a free reshape of the global
cell ordering, reference ``src/mesher.jl:1064-1088``). Face work decomposes
into (see `ibx.topology.blocks`):

  dense   — intra-block + equal-size inter-block + boundary one-sided faces:
            shift/slice vector ops; halo columns by one block-axis gather;
  2:1     — refinement interfaces as per-interface column ops (tiny
            block-granular gathers/scatters);
  generic — any leftover faces via batched gather + scatter-add.

Numerics are identical to the generic gather path (`ibx.ops.operators`) —
the parity tests enforce it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..physics.flux import inviscid_fluxes_hll, viscous_fluxes
from ..physics.fluid import Fluid, primitive2state, speed_of_sound, state2primitive
from ..topology.blocks import BlockTables
from .operators import minmod


def _axis(bt: BlockTables, d: int) -> int:
    """Array axis of spatial dim d in [B, x_{nd-1}, ..., x_0, C] layout."""
    return 1 + (bt.nd - 1 - d)


def to_blocks(bt: BlockTables, u_flat):
    return u_flat.reshape(
        (bt.n_blocks,) + (bt.block_size,) * bt.nd + u_flat.shape[1:]
    )


def to_flat(bt: BlockTables, u3):
    nlead = 1 + bt.nd
    return u3.reshape((bt.n_cells,) + u3.shape[nlead:])


def pad_dim(bt: BlockTables, u3, d: int):
    """Halo columns: regular neighbors' edge slices; boundary sides mirror
    the own edge (the reference's o == n one-sided faces); invalid sides get
    finite junk (masked by `face_mask`)."""
    ax = _axis(bt, d)
    bs = bt.block_size
    first = jax.lax.slice_in_dim(u3, 0, 1, axis=ax)
    last = jax.lax.slice_in_dim(u3, bs - 1, bs, axis=ax)

    def bmask(v):
        return v.reshape((bt.n_blocks,) + (1,) * (u3.ndim - 1))

    def btake(slab, idx):
        # gather whole-block rows via a 2D row view
        flat = slab.reshape(bt.n_blocks, -1)
        return jnp.take(flat, idx, axis=0).reshape(slab.shape)

    halo_l = btake(last, bt.nbr[d][0])
    halo_l = jnp.where(bmask(bt.bnd[d][0]) > 0, first, halo_l)
    halo_r = btake(first, bt.nbr[d][1])
    halo_r = jnp.where(bmask(bt.bnd[d][1]) > 0, last, halo_r)
    return jnp.concatenate([halo_l, u3, halo_r], axis=ax)


def face_lr(bt: BlockTables, up, d: int):
    ax = _axis(bt, d)
    uo = jax.lax.slice_in_dim(up, 0, bt.block_size + 1, axis=ax)
    un = jax.lax.slice_in_dim(up, 1, bt.block_size + 2, axis=ax)
    return uo, un


def face_mask(bt: BlockTables, d: int, n_trailing: int = 1):
    bs = bt.block_size
    m = jnp.ones((bt.n_blocks, bs + 1), dtype=jnp.float32)
    m = m.at[:, 0].set(bt.edge_valid[d][0])
    m = m.at[:, -1].set(bt.edge_valid[d][1])
    ax = _axis(bt, d)
    shape = [bt.n_blocks] + [1] * (bt.nd + n_trailing)
    shape[ax] = bs + 1
    return m.reshape(shape)


def _h_bcast(bt: BlockTables, d: int, n_trailing: int = 1):
    shape = [bt.n_blocks] + [1] * (bt.nd + n_trailing)
    return bt.h[:, d].reshape(shape)


def gg_dense(bt: BlockTables, F, d: int):
    ax = _axis(bt, d)
    bs = bt.block_size
    plus = jax.lax.slice_in_dim(F, 1, bs + 1, axis=ax)
    minus = jax.lax.slice_in_dim(F, 0, bs, axis=ax)
    return (plus - minus) / _h_bcast(bt, d, F.ndim - 1 - bt.nd)


def ugg_dense(bt: BlockTables, F, d: int):
    ax = _axis(bt, d)
    bs = bt.block_size
    plus = jax.lax.slice_in_dim(F, 1, bs + 1, axis=ax)
    minus = jax.lax.slice_in_dim(F, 0, bs, axis=ax)
    return (plus + minus) / _h_bcast(bt, d, F.ndim - 1 - bt.nd)


def _edge(bt: BlockTables, u3, d: int, s: int):
    """Edge column of every block: [B, n_side..., C]."""
    ax = _axis(bt, d)
    idx = bt.block_size - 1 if s else 0
    return jax.lax.index_in_dim(u3, idx, axis=ax, keepdims=False)


def _btake_rows(bt: BlockTables, slab, idx):
    """Gather whole-block rows by block id via a 2D row-gather view."""
    flat = slab.reshape(bt.n_blocks, -1)
    return jnp.take(flat, idx, axis=0).reshape(slab.shape)


def _edge_rows(bt: BlockTables, edge_slab, idx):
    """Gather whole edge columns by block id via a 2D row-gather view."""
    flat = edge_slab.reshape(bt.n_blocks, -1)
    rows = jnp.take(flat, idx, axis=0)
    return rows.reshape((idx.shape[0],) + edge_slab.shape[1:])


def _expand_half(col, off, bs: int):
    """col [V, bs, C], off [V] in {0,1} -> entry j = col[off*bs/2 + j//2]."""
    low = jnp.repeat(col[:, : bs // 2], 2, axis=1)
    high = jnp.repeat(col[:, bs // 2:], 2, axis=1)
    return jnp.where((off == 1)[:, None, None], high, low)


def _expand_coarse(col, off, bs: int, nd: int):
    """Coarse edge plane -> values seen by the fine-side plane cells.

    2D: col [V, bs, C], off in {0, 1} (which half). 3D: col [V, bs, bs, C]
    (hi-major plane), off = off_hi * 2 + off_lo (which quadrant); the
    quadrant is upsampled 2x per perpendicular dim.
    """
    if nd == 2:
        return _expand_half(col, off, bs)
    h = bs // 2
    outs = []
    for qh in (0, 1):
        for ql in (0, 1):
            quad = col[:, qh * h:qh * h + h, ql * h:ql * h + h]
            outs.append(jnp.repeat(jnp.repeat(quad, 2, axis=1), 2, axis=2))
    sel = off[:, None, None, None]
    out = outs[0]
    for k in (1, 2, 3):
        out = jnp.where(sel == k, outs[k], out)
    return out


def _coarse_side_neighbors(planes, nd: int):
    """Fine-block edge planes -> the 2^(nd-1) per-coarse-cell face values.

    2D: planes = [f_low, f_high] each [V, bs, C]. 3D: planes hi-major
    quadrant order, each [V, bs, bs, C]; assembles the double-resolution
    face and strides out the 2x(2) sub-face sets.
    """
    if nd == 2:
        fine = jnp.concatenate(planes, axis=1)          # [V, 2bs, C]
        return [fine[:, 0::2], fine[:, 1::2]]
    top = jnp.concatenate([planes[0], planes[1]], axis=2)
    bot = jnp.concatenate([planes[2], planes[3]], axis=2)
    p2 = jnp.concatenate([top, bot], axis=1)            # [V, 2bs, 2bs, C]
    return [p2[:, dy::2, dx::2] for dy in (0, 1) for dx in (0, 1)]


def _parts(W):
    """Normalize a channel-parts argument: tuple of grids, or one grid."""
    return W if isinstance(W, (tuple, list)) else (W,)


def _cat_fn(face_fn: Callable, widths):
    """Wrap a tuple-parts face_fn to operate on channel-concatenated
    arrays (the 2:1 interface machinery works on small edge columns, where
    one concat is cheap and keeps its placement logic single-array)."""
    offs = np.cumsum([0] + list(widths))

    def split(Wcat):
        return tuple(Wcat[..., offs[i]:offs[i + 1]]
                     for i in range(len(widths)))

    def fn(Wo, Wn, ho, hn):
        return face_fn(split(Wo), split(Wn), ho, hn)

    return fn


def interface_corrections(bt: BlockTables, d: int, W3, face_fn: Callable,
                          n_out: int, signed_mask):
    """Structured 2:1 interface contributions as a cell-grid array.

    ``face_fn(W_owner, W_neighbor, h_owner, h_neighbor) -> [..., n_out]``
    computes per-face quantities with the owner on the minus side. Columns
    flagged in ``signed_mask`` accumulate green-gauss style (+ on a cell's
    plus side, - on its minus side); others accumulate unsigned. The result
    is already divided by the accumulating cell's spacing.
    """
    parts = _parts(W3)
    if isinstance(W3, (tuple, list)):
        face_fn = _cat_fn(face_fn, [p.shape[-1] for p in parts])
    bs, nd = bt.block_size, bt.nd
    n_fine = 2 ** (nd - 1)
    signed = jnp.asarray(signed_mask, dtype=parts[0].dtype)
    ax = _axis(bt, d)

    def edge_cat(s):
        # channel-concat of the parts' edge planes (1/bs of the grid —
        # cheap, unlike concatenating the full grids)
        es = [_edge(bt, p, d, s) for p in parts]
        return es[0] if len(es) == 1 else jnp.concatenate(es, axis=-1)

    def fetch(side, blocks):
        return _edge_rows(bt, edge_cat(side), blocks)

    def place(vals, inv):
        # inverse-permutation gather: each block appears at most once per
        # table, so "scatter" = row-gather with a dummy zero row appended
        trail = vals.shape[1:]
        flat = vals.reshape(vals.shape[0], -1)
        padded = jnp.concatenate(
            [flat, jnp.zeros((1, flat.shape[1]), vals.dtype)], axis=0
        )
        out = jnp.take(padded, inv, axis=0)
        return out.reshape((bt.n_blocks,) + trail)

    def hshape(blocks):
        return bt.h[:, d][blocks].reshape((blocks.shape[0],) + (1,) * nd)

    cols = [None, None]
    for s in (0, 1):
        sgn = jnp.where(signed > 0, 1.0 if s == 1 else -1.0, 1.0)
        pieces = []

        fsb = bt.fs_block[d][s]
        if fsb.shape[0]:
            own = fetch(s, fsb)
            other_col = fetch(1 - s, bt.fs_coarse[d][s])
            other = _expand_coarse(other_col, bt.fs_off[d][s], bs, nd)
            hf = hshape(fsb)
            hc = 2.0 * hf
            if s == 1:
                vals = face_fn(own, other, hf, hc)
            else:
                vals = face_fn(other, own, hc, hf)
            pieces.append(vals * sgn / hf)

        csb = bt.cs_block[d][s]
        if csb.shape[0]:
            own = fetch(s, csb)
            planes = [fetch(1 - s, bt.cs_fine[d][s][:, q])
                      for q in range(n_fine)]
            hc = hshape(csb)
            hf = hc / 2.0
            tot = None
            for nb in _coarse_side_neighbors(planes, nd):
                if s == 1:
                    vals = face_fn(own, nb, hc, hf)
                else:
                    vals = face_fn(nb, own, hf, hc)
                tot = vals if tot is None else tot + vals
            pieces.append(tot * (sgn / n_fine) / hc)

        # one placement over the disjoint fine/coarse block sets
        cols[s] = (
            place(jnp.concatenate(pieces, axis=0), bt.ifc_inv[d][s])
            if pieces else None
        )

    if cols[0] is None and cols[1] is None:
        return None
    return cols


def _sparse_accum(bt: BlockTables, d: int, W, face_fn: Callable,
                  n_out: int, signed_mask, o, n, wr, wl):
    """Sparse face accumulation: gather (owner, neighbor) rows, evaluate
    ``face_fn``, scatter-add with per-face weights (wr to the owner, wl to
    the neighbor with the signed flip), divide by the cell spacing.

    ``W``: one flat [n_cells, K] array, or a tuple of channel-part grids
    (gathered per part and row-concatenated — never concatenating the full
    grids)."""
    parts = _parts(W)
    flats = [p.reshape(bt.n_cells, -1) for p in parts]
    if isinstance(W, (tuple, list)):
        face_fn = _cat_fn(face_fn, [f.shape[-1] for f in flats])

    def gather(idx):
        rows = [jnp.take(f, idx, axis=0) for f in flats]
        return rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=-1)

    Wo = gather(o)
    Wn = gather(n)
    sp = bt.spacing_flat[:, d]
    ho = jnp.take(sp, o, axis=0)[:, None]
    hn = jnp.take(sp, n, axis=0)[:, None]
    vals = face_fn(Wo, Wn, ho, hn)
    signed = jnp.asarray(signed_mask, dtype=vals.dtype)
    pm = jnp.where(signed > 0, -1.0, 1.0)
    out = jnp.zeros((bt.n_cells, n_out), dtype=vals.dtype)
    out = out.at[o].add(wr[:, None] * vals)
    out = out.at[n].add(wl[:, None] * vals * pm)
    return out / sp[:, None]


def _generic_sparse(bt: BlockTables, d: int, W_flat, face_fn: Callable,
                    n_out: int, signed_mask):
    """Leftover faces: batched gather + scatter-add (exotic topologies)."""
    return _sparse_accum(bt, d, W_flat, face_fn, n_out, signed_mask,
                         bt.sp_owner[d], bt.sp_neighbor[d],
                         bt.sp_wr[d], bt.sp_wl[d])


def face_accumulate(bt: BlockTables, d: int, W3, face_fn: Callable,
                    n_out: int, signed_mask):
    """Green-Gauss-style accumulation of arbitrary per-face quantities into
    cells along dim ``d`` — the reusable shape of the RHS passes.

    ``face_fn(W_owner, W_neighbor, h_owner, h_neighbor) -> [..., n_out]``
    computes face values from the cell channels ``W3`` — one [B, bs.., K]
    grid, or a TUPLE of channel-part grids (face_fn then receives tuples;
    the parts are never concatenated at grid size). Columns flagged in
    ``signed_mask`` accumulate (right - left)/h (signed divergence),
    others (right + left)/h (unsigned). Handles dense faces, structured
    2:1 interfaces and the generic sparse leftover — identical coverage to
    the Euler passes.

    Each flux is evaluated ONCE per face: interior faces on slice windows,
    block-edge faces separately, one `concatenate([lo, int, hi])` face
    array.
    """
    parts = _parts(W3)
    tup = isinstance(W3, (tuple, list))
    fn = face_fn if tup else (
        lambda Wo, Wn, ho, hn: face_fn(Wo[0], Wn[0], ho, hn))

    ax = _axis(bt, d)
    bs = bt.block_size
    h = _h_bcast(bt, d, 1)

    # interior faces (i-1, i), i = 1..bs-1: slice windows, no wrap
    lo_sl = tuple(jax.lax.slice_in_dim(p, 0, bs - 1, axis=ax)
                  for p in parts)
    hi_sl = tuple(jax.lax.slice_in_dim(p, 1, bs, axis=ax) for p in parts)
    F_int = fn(lo_sl, hi_sl, h, h)

    # block-edge faces: halo columns (dense neighbor edge planes; own edge
    # mirrored on one-sided boundary sides; invalid sides masked to zero —
    # the 2:1 corrections below add the real thing)
    def bmask(v, like):
        return v.reshape((bt.n_blocks,) + (1,) * (like.ndim - 1))

    firsts, lasts, halos_l, halos_r = [], [], [], []
    for p in parts:
        first = jax.lax.slice_in_dim(p, 0, 1, axis=ax)
        last = jax.lax.slice_in_dim(p, bs - 1, bs, axis=ax)
        hl = _btake_rows(bt, last, bt.nbr[d][0])
        hl = jnp.where(bmask(bt.bnd[d][0], p) > 0, first, hl)
        hr = _btake_rows(bt, first, bt.nbr[d][1])
        hr = jnp.where(bmask(bt.bnd[d][1], p) > 0, last, hr)
        firsts.append(first)
        lasts.append(last)
        halos_l.append(hl)
        halos_r.append(hr)
    n_trail = F_int.ndim - 1 - bt.nd
    mask_l = bt.edge_valid[d][0].reshape(
        (bt.n_blocks,) + (1,) * (bt.nd + n_trail))
    mask_r = bt.edge_valid[d][1].reshape(mask_l.shape)
    lo_face = fn(tuple(halos_l), tuple(firsts), h, h) * mask_l
    hi_face = fn(tuple(lasts), tuple(halos_r), h, h) * mask_r

    # ONE materialized face array [.., bs+1, ..]; its two unit-shifted
    # slice views fuse into the divergence consumer
    Fall = jnp.concatenate([lo_face, F_int, hi_face], axis=ax)
    Fm = jax.lax.slice_in_dim(Fall, 0, bs, axis=ax)
    Fp = jax.lax.slice_in_dim(Fall, 1, bs + 1, axis=ax)
    sgn = jnp.where(jnp.asarray(signed_mask, F_int.dtype) > 0, -1.0, 1.0)
    out = (Fp + sgn * Fm) / h

    cols = interface_corrections(bt, d, W3, face_fn, n_out, signed_mask)
    if cols is not None:
        ishape = [1] * out.ndim
        ishape[ax] = bs
        iota = jax.lax.broadcasted_iota(jnp.int32, tuple(ishape), ax)
        if cols[0] is not None:
            out = out + jnp.where(
                iota == 0, jnp.expand_dims(cols[0], ax), 0.0)
        if cols[1] is not None:
            out = out + jnp.where(
                iota == bs - 1, jnp.expand_dims(cols[1], ax), 0.0)
    if bt.sp_owner[d].shape[0]:
        gs = _generic_sparse(bt, d, W3 if tup else
                             W3.reshape(bt.n_cells, W3.shape[-1]),
                             face_fn, n_out, signed_mask)
        out = out + gs.reshape(out.shape)
    return out


def cell_gradient_grid(bt: BlockTables, u3, d: int):
    """Green-Gauss cell gradient of ``u3`` [B, bs.., K] along dim ``d`` —
    dense counterpart of `ibx.ops.operators.cell_gradient`."""
    K = u3.shape[-1]

    def face_fn(Wo, Wn, ho, hn):
        return (Wo * hn + Wn * ho) / (ho + hn)

    return face_accumulate(bt, d, u3, face_fn, K, [1.0] * K)


def euler_rhs_grid(
    bt: BlockTables,
    fluid: Fluid,
    P3,
    *,
    high_order: bool = True,
    with_dt: bool = False,
    cfl: float = 0.8,
    frozen=None,
    fix3=None,
    viscous: bool = False,
    mu_t3=None,
    cut3=None,
):
    """Fused Euler dQ/dt on the block-grid state [B, bs, ..., bs, C];
    numerics identical to `ibx.solve.euler.euler_rhs` (MUSCL + JST blending
    + HLL). Grid-native: no flat<->block relayout copies inside the march.

    ``frozen``: optional (du3_list, nu3) from a previous evaluation — reuses
    the gradient/sensor pass (frozen-limiter RK stages).

    ``fix3`` (optional [B, bs.., 1] in [0, 1]): trailing-edge-local robust
    blend. Where > 0 a face (taking the max of its two cells) widens the
    HLL wave speeds to the Einfeldt bounds (`ibx.physics.flux`), forces the
    sensor blend to limited upwinding, and scales the MUSCL slopes toward
    first order — the positivity recipe that keeps a resolved sharp
    trailing edge from expanding to vacuum. Default None = reference
    numerics everywhere.

    ``viscous=True`` subtracts Newtonian viscous + heat-conduction face
    fluxes (reference ``src/cfd.jl:664-736``) using the pass-A cell
    gradients with the orthogonality-corrected normal component — the
    dense counterpart of `ibx.solve.euler.euler_rhs(viscous=True)`.
    ``mu_t3`` ([B, bs.., 1]) is an optional eddy-viscosity field.

    ``cut3`` (optional): static cut-cell wall tables — the flagged
    cut-cell wall treatment (`ibx.geometry.cutcell`). Per dim, the
    solid-covered fraction of each cut face's pass-B flux is removed
    sparsely; each cut cell gains a wall pressure flux on its true wall
    vector (wall pressure = cell pressure + pass-A gradient correction to
    the wall point) and a 1/alpha volume scale; dt is scaled by alpha.
    Keys: owner/neighbor/w (per-dim tuples), wall_cells, wall_coef
    (= wall_vec / V), xw_rel, inv_alpha3 [B, bs.., 1], alpha3 [B, bs..].

    Returns R3 [B, bs.., C]; with ``with_dt`` also dt3 [B, bs..] and the
    frozen (du3_list, nu3) grids.
    """
    nd, bs = bt.nd, bt.block_size
    ncomp = P3.shape[-1]
    grid_shape = P3.shape[:-1]
    a3 = speed_of_sound(fluid, P3[..., 1])
    S3 = jnp.abs(P3[..., 2:2 + nd]) + a3[..., None]

    # the wave-speed channel (sf) is only needed when computing dt
    nA = ncomp + (3 if with_dt else 2)  # [Pf(ncomp), fd, |fd| (, sf)]
    signedA = [1.0] * (ncomp + 1) + [0.0] * (2 if with_dt else 1)

    def face_A(Wo, Wn, ho, hn):
        Po, Pn = Wo[0], Wn[0]
        Pf = (Po * hn + Pn * ho) / (ho + hn)
        fd = Pn[..., 0:1] - Po[..., 0:1]
        out = [Pf, fd, jnp.abs(fd)]
        if with_dt:
            So, Sn = Wo[1], Wn[1]
            out.append((So * hn + Sn * ho) / (ho + hn))
        return jnp.concatenate(out, axis=-1)

    du_grids = []
    nu3 = jnp.full(grid_shape + (1,), 1e-7, dtype=P3.dtype)
    dt_bound = jnp.zeros(grid_shape, dtype=P3.dtype) if with_dt else None

    if frozen is not None:
        du_grids, nu3 = frozen
    for d in range(nd if frozen is None else 0):
        partsA = (P3, S3[..., d:d + 1]) if with_dt else (P3,)
        outA = face_accumulate(bt, d, partsA, face_A, nA, signedA)
        du_grids.append(outA[..., :ncomp])
        G3 = outA[..., ncomp]
        U3 = outA[..., ncomp + 1]
        nu3 = jnp.maximum(
            nu3, ((1e-7 + jnp.abs(G3)) / (1e-7 + U3))[..., None])
        if with_dt:
            dt_bound = dt_bound + outA[..., ncomp + 2]

    # ---------------- pass B: MUSCL + HLL + divergence ---------------------
    signedB = [1.0] * ncomp
    has_fix = fix3 is not None
    has_mut = viscous and mu_t3 is not None

    R3 = jnp.zeros_like(P3)
    for d in range(nd):
        du3 = du_grids[d]

        def face_B(Wo, Wn, ho, hn, d=d):
            Po, Pn = Wo[0], Wn[0]
            duo, dun = Wo[1], Wn[1]
            Do, Dn = Wo[2], Wn[2]
            k = 3
            fo = None
            if has_fix:
                fo = jnp.maximum(Wo[k], Wn[k])
                k += 1
            down, dneigh = ho / 2, hn / 2
            grad_f = (Pn - Po) / (down + dneigh)
            slope_o = (2 * duo - grad_f) * down
            slope_n = (2 * dun - grad_f) * dneigh
            lim = minmod(slope_n, slope_o)
            if has_fix:
                lim = lim * (1.0 - fo)
            PL = Po + lim
            PR = Pn - lim
            D = jnp.maximum(jnp.maximum(Do, Dn), 1e-7)
            if has_fix:
                D = jnp.maximum(D, fo)
            uf = (Po * dneigh + Pn * down) / (down + dneigh)
            if high_order:
                uf = uf + (duo * down - dun * dneigh) / 8
            PL = PL * D + (1.0 - D) * uf
            PR = PR * D + (1.0 - D) * uf
            F = inviscid_fluxes_hll(fluid, PL, PR, d, fix=fo)
            if viscous:
                # at_faces interp of P, lateral gradients and mu_t;
                # normal gradient = the two-point difference (the
                # orthogonality-corrected form, src/ImmersedBoundary.jl:
                # 1051-1069)
                def at_f(a_o, a_n):
                    return (a_o * dneigh + a_n * down) / (down + dneigh)

                Pf = at_f(Po, Pn)
                gf = []
                kk = k
                for i in range(nd):
                    if i == d:
                        gf.append(grad_f)
                    else:
                        gf.append(at_f(Wo[kk], Wn[kk]))
                        kk += 1
                mu_t_f = 0.0
                if has_mut:
                    mu_t_f = at_f(Wo[kk], Wn[kk])[..., 0]
                F = F - viscous_fluxes(fluid, Pf, gf, d, mu_t=mu_t_f)
            return -F      # accumulate R += -divergence(F) directly

        Vparts = [P3, du3, nu3]
        if has_fix:
            Vparts.append(fix3)
        if viscous:
            Vparts.extend(du_grids[i] for i in range(nd) if i != d)
            if has_mut:
                Vparts.append(mu_t3)
        Vparts = tuple(Vparts)
        R3 = R3 + face_accumulate(bt, d, Vparts, face_B, ncomp, signedB)
        if cut3 is not None and cut3["owner"][d].shape[0]:
            # remove the solid-covered fraction (1 - aperture) of the cut
            # faces' dense fluxes: since face_B returns -F, the signed
            # sparse accumulation with +w on the owner and -w on the
            # neighbor cancels exactly that fraction of the accumulated
            # -gg(F); hypercube one-sided cut faces carry the weight on
            # one side only (owner == neighbor == the real cell there)
            rem = _sparse_accum(bt, d, Vparts, face_B, ncomp, signedB,
                                cut3["owner"][d], cut3["neighbor"][d],
                                cut3["wr"][d], cut3["wl"][d])
            R3 = R3 - rem.reshape(grid_shape + (ncomp,))

    if cut3 is not None:
        wc = cut3["wall_cells"]
        if wc.shape[0]:
            # wall pressure flux on the true wall vector; p_w from the
            # cell pressure plus the pass-A gradient to the wall point
            P_flat = P3.reshape(bt.n_cells, ncomp)
            p_w = jnp.take(P_flat, wc, axis=0)[:, 0]
            for d in range(nd):
                dp = jnp.take(
                    du_grids[d].reshape(bt.n_cells, ncomp), wc, axis=0)[:, 0]
                p_w = p_w + dp * cut3["xw_rel"][:, d]
            Rmom = -p_w[:, None] * cut3["wall_coef"]        # [M, nd]
            Rrow = jnp.concatenate(
                [jnp.zeros((wc.shape[0], 2), Rmom.dtype), Rmom,
                 jnp.zeros((wc.shape[0], ncomp - 2 - nd), Rmom.dtype)],
                axis=1)
            R3 = (R3.reshape(bt.n_cells, ncomp)
                  .at[wc].add(Rrow, unique_indices=True)
                  .reshape(grid_shape + (ncomp,)))
        R3 = R3 * cut3["inv_alpha3"]

    if with_dt:
        dt3 = cfl / dt_bound
        if cut3 is not None:
            dt3 = dt3 * cut3["alpha3"]     # cut-cell CFL: V -> alpha V
        return R3, dt3, (du_grids, nu3)
    return R3


def euler_rhs_block(
    bt: BlockTables,
    fluid: Fluid,
    P,
    *,
    high_order: bool = True,
    with_dt: bool = False,
    cfl: float = 0.8,
    frozen=None,
    fix=None,
):
    """Flat-state wrapper of `euler_rhs_grid` ([N, C] in / [N, C] out).

    ``frozen`` here uses the flat (du_list, nu) convention of round 1.
    ``fix`` is the flat [N] trailing-edge blend (see `euler_rhs_grid`).
    """
    P3 = to_blocks(bt, P)
    if frozen is not None:
        du_flat, nu = frozen
        frozen = ([to_blocks(bt, du) for du in du_flat],
                  to_blocks(bt, nu[:, None]))
    fix3 = None if fix is None else to_blocks(bt, fix[:, None])
    out = euler_rhs_grid(bt, fluid, P3, high_order=high_order,
                         with_dt=with_dt, cfl=cfl, frozen=frozen, fix3=fix3)
    if with_dt:
        R3, dt3, (du_grids, nu3) = out
        return (
            to_flat(bt, R3),
            dt3.reshape(bt.n_cells),
            ([to_flat(bt, du3) for du3 in du_grids],
             nu3.reshape(bt.n_cells)),
        )
    return to_flat(bt, out)


from ..physics.fluid import physicality_guard as _guard  # noqa: E402
from ..physics.fluid import state2primitive_guarded as _s2p_g  # noqa: E402


def smooth_residual_grid(bt: BlockTables, R3, *, eps: float = 0.6,
                         n_sweeps: int = 2, active3=None):
    """Implicit residual smoothing (Jameson): Jacobi sweeps toward
    (I - eps nabla^2) Rs = R, raising the stable CFL by ~sqrt(1 + 4 eps).

    The steady state is untouched (R = 0 is a fixed point of the smoother),
    so the smoothing stencil may be approximate: block sides without a
    same-size dense neighbor (2:1 interfaces) mirror the own edge column.
    ``active3`` masks cells whose residuals are meaningless (frozen
    solid-interior cells) out of the smoothing stencil — without it their
    garbage residuals bleed into wall-adjacent fluid cells and the march
    stalls in a spurious low-lift state.
    """
    nd, bs = bt.nd, bt.block_size
    if active3 is not None:
        R_in = R3
        R3 = R3 * active3[..., None]

    def neighbor_sum(Rs):
        acc = None
        for d in range(nd):
            ax = _axis(bt, d)
            first = jax.lax.slice_in_dim(Rs, 0, 1, axis=ax)
            last = jax.lax.slice_in_dim(Rs, bs - 1, bs, axis=ax)

            def bmask(v):
                return v.reshape((bt.n_blocks,) + (1,) * (Rs.ndim - 1))

            def btake(slab, idx):
                flat = slab.reshape(bt.n_blocks, -1)
                return jnp.take(flat, idx, axis=0).reshape(slab.shape)

            halo_l = jnp.where(bmask(bt.edge_valid[d][0]) > 0,
                               btake(last, bt.nbr[d][0]), first)
            halo_l = jnp.where(bmask(bt.bnd[d][0]) > 0, first, halo_l)
            halo_r = jnp.where(bmask(bt.edge_valid[d][1]) > 0,
                               btake(first, bt.nbr[d][1]), last)
            halo_r = jnp.where(bmask(bt.bnd[d][1]) > 0, last, halo_r)
            up = jnp.concatenate([halo_l, Rs, halo_r], axis=ax)
            left = jax.lax.slice_in_dim(up, 0, bs, axis=ax)
            right = jax.lax.slice_in_dim(up, 2, bs + 2, axis=ax)
            s = left + right
            acc = s if acc is None else acc + s
        return acc

    Rs = R3
    denom = 1.0 + eps * 2 * nd
    for _ in range(n_sweeps):
        Rs = (R3 + eps * neighbor_sum(Rs)) / denom
    if active3 is not None:
        Rs = jnp.where(active3[..., None] > 0, Rs, R_in)
    return Rs


def rk2_step_grid(
    bt: BlockTables,
    fluid: Fluid,
    P3,
    apply_bcs3,
    *,
    cfl: float = 0.8,
    high_order: bool = True,
    active3=None,
    freeze_gradients: bool = False,
    irs_eps: float = 0.0,
    fix3=None,
    cut3=None,
):
    """Local-dt TVD-RK2 pseudo step, grid-native (state stays [B, bs.., C]
    end to end; ``apply_bcs3`` maps grid -> grid). Same scheme as
    `ibx.solve.euler.rk2_step`. ``active3`` (float[B, bs..], 0/1) freezes
    cells — used for cells inside solid bodies, whose free evolution (the
    reference's behavior) can run away and pollute image stencils.
    ``freeze_gradients`` reuses stage-1 gradients/sensor in stage 2
    (frozen-limiter RK; saves one gradient pass per step). ``irs_eps > 0``
    enables implicit residual smoothing (raise ``cfl`` by ~sqrt(1+4 eps)).
    ``fix3``: trailing-edge robustness blend; ``cut3``: cut-cell wall
    tables — see `euler_rhs_grid`."""
    R0, dt3, frozen = euler_rhs_grid(bt, fluid, P3, high_order=high_order,
                                     with_dt=True, cfl=cfl, fix3=fix3,
                                     cut3=cut3)
    if irs_eps > 0.0:
        R0 = smooth_residual_grid(bt, R0, eps=irs_eps, active3=active3)
    if active3 is not None:
        dt3 = dt3 * active3
    dt = dt3[..., None]
    Q0 = primitive2state(fluid, P3)
    P1 = apply_bcs3(_s2p_g(fluid, Q0 + dt * R0))
    R1 = euler_rhs_grid(bt, fluid, P1, high_order=high_order,
                        frozen=frozen if freeze_gradients else None,
                        fix3=fix3, cut3=cut3)
    if irs_eps > 0.0:
        R1 = smooth_residual_grid(bt, R1, eps=irs_eps, active3=active3)
    P2 = apply_bcs3(_s2p_g(fluid, Q0 + dt * (R0 + R1) / 2))
    resnorm = jnp.abs(R0[..., 0]).max()
    return P2, resnorm


def euler_step_grid(
    bt: BlockTables,
    fluid: Fluid,
    P3,
    apply_bcs3,
    *,
    cfl: float = 0.4,
    high_order: bool = True,
    active3=None,
    fix3=None,
    cut3=None,
):
    """Single-stage explicit pseudo step with local time stepping — the
    reference's own march recipe (``test/advection.jl:85-93``): one residual
    evaluation per step. Grid-native."""
    R, dt3, _ = euler_rhs_grid(bt, fluid, P3, high_order=high_order,
                               with_dt=True, cfl=cfl, fix3=fix3, cut3=cut3)
    if active3 is not None:
        dt3 = dt3 * active3
    Q = primitive2state(fluid, P3) + dt3[..., None] * R
    P1 = apply_bcs3(_s2p_g(fluid, Q))
    resnorm = jnp.abs(R[..., 0]).max()
    return P1, resnorm


def _flat_bcs(bt: BlockTables, apply_bcs):
    def apply_bcs3(P3):
        return to_blocks(bt, apply_bcs(to_flat(bt, P3)))
    return apply_bcs3


def rk2_step_block(
    bt: BlockTables,
    fluid: Fluid,
    P,
    apply_bcs,
    *,
    cfl: float = 0.8,
    high_order: bool = True,
    active=None,
    freeze_gradients: bool = False,
):
    """Flat-state wrapper of `rk2_step_grid` (P [N, C], BCs on flat state)."""
    active3 = None if active is None else to_blocks(bt, active[:, None])[..., 0]
    P2, resnorm = rk2_step_grid(
        bt, fluid, to_blocks(bt, P), _flat_bcs(bt, apply_bcs),
        cfl=cfl, high_order=high_order, active3=active3,
        freeze_gradients=freeze_gradients,
    )
    return to_flat(bt, P2), resnorm


def euler_step_block(
    bt: BlockTables,
    fluid: Fluid,
    P,
    apply_bcs,
    *,
    cfl: float = 0.4,
    high_order: bool = True,
    active=None,
):
    """Flat-state wrapper of `euler_step_grid`."""
    active3 = None if active is None else to_blocks(bt, active[:, None])[..., 0]
    P1, resnorm = euler_step_grid(
        bt, fluid, to_blocks(bt, P), _flat_bcs(bt, apply_bcs),
        cfl=cfl, high_order=high_order, active3=active3,
    )
    return to_flat(bt, P1), resnorm
