"""Domain compiler: octree mesh -> static device index tables (host side).

Counterpart of reference ``src/ImmersedBoundary.jl:483-786``. The mesh is
"compiled" once into gather/scatter tables: faces, partitions with skirt
(halo) cell sets, ghost-cell boundary stencils and surface interpolators.
All device-side structures are fixed-shape, so every downstream operation
compiles to a single XLA executable per mesh.

Departures from the reference:
  * partitions are device-count-sized (default 1), not 100k-cell chunks —
    the partition axis IS the device mesh axis;
  * owned cells occupy the first ``n_own`` local slots (scatter = slice);
  * boundary stencil cells are folded into the partition skirt so BC
    imposition never needs non-local gathers;
  * everything is padded to static shapes with zero weights / masked rows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from ..geometry.octree import Mesh, get_cells
from ..geometry.stereolitography import Stereolitography, centers_and_normals
from ..ops.operators import Partition
from ..ops.stencil import Stencil, stencil_from_padded
from ..utils import pytree_dataclass
from .faces import hcube_faces, octree2faces, octree2faces_blocks
from .ghosts import ghosts_and_projections_hcube, ghosts_and_projections_stl
from .interp import interpolator

_EPS32 = float(np.finfo(np.float32).eps)


@pytree_dataclass(meta_fields=("n_ghost",))
class Boundary:
    """Ghost-cell boundary block (reference ``src/ImmersedBoundary.jl:406-448``).

    ghost: int32[G] cell indices (global for a 1-partition domain, local
    otherwise); padding rows carry an out-of-range index and valid=0.
    interp: image-point interpolation stencil in the same index space.
    eta = ghost_distance / image_distance (the ghost blending factor,
    reference ``src/ImmersedBoundary.jl:1220``).
    """

    ghost: jnp.ndarray
    projections: jnp.ndarray
    normals: jnp.ndarray
    image_distances: jnp.ndarray
    ghost_distances: jnp.ndarray
    eta: jnp.ndarray
    interp: Stencil
    valid: jnp.ndarray
    n_ghost: int


@dataclasses.dataclass
class Surface:
    """Postprocessing surface (reference ``src/ImmersedBoundary.jl:335-376``).

    Sampling points are STL face centers offset 1.01 circumdiameters along the
    unit normal; ``interpolator`` samples cell fields at the wall (stencil
    biased off-wall), ``offset_interpolator`` at 1.5x the offset (wall-model
    sampling). ``areas`` are normal magnitudes.
    """

    points: np.ndarray
    offsets: np.ndarray
    normals: np.ndarray
    areas: np.ndarray
    interpolator: Stencil
    offset_interpolator: Stencil
    stl: Stereolitography

    def __call__(self, u):
        return self.interpolator(jnp.asarray(u))

    def at_offset(self, u):
        return self.offset_interpolator(jnp.asarray(u))


def surface_integral(surf: Surface, u):
    """Area-weighted surface sum (reference ``src/ImmersedBoundary.jl:351-361``)."""
    a = jnp.asarray(surf.areas)
    u = jnp.asarray(u)
    return (u * a.reshape(a.shape + (1,) * (u.ndim - 1))).sum(axis=0)


@pytree_dataclass(meta_fields=("names",))
class FusedBoundary:
    """Several boundary families as one gather + one sorted scatter.

    The eta-blended ghost update (reference ``src/ImmersedBoundary.jl:
    1220-1245``) for all families in a single pass: ``family`` selects which
    BC function's result lands on each ghost row.
    """

    ghost: jnp.ndarray      # int32[G], sorted global cell ids
    interp: Stencil         # image-point stencil, global index space
    normals: jnp.ndarray    # f32[G, nd]
    eta: jnp.ndarray        # f32[G, 1]
    family: jnp.ndarray     # int32[G] index into names
    names: Tuple[str, ...]

    def __call__(self, P, fns: Dict[str, Callable], *, guard=None,
                 mirror: Sequence[str] = (), mirror_scale=None):
        """``fns[name](P_image, normals) -> bc values``; returns updated P.

        ``guard`` (optional) post-processes the blended ghost rows (e.g.
        `physicality_guard`): linear image stencils can extrapolate with
        negative weights at thin geometry. ``mirror`` (family names) flips
        the ghost normal velocity to -eta*u_n(image) (see BlockedBC).
        """
        Pi = self.interp(P)
        r = None
        for i, name in enumerate(self.names):
            ri = fns[name](Pi, self.normals)
            sel = (self.family == i).reshape(
                self.family.shape + (1,) * (Pi.ndim - 1)
            )
            r = ri if r is None else jnp.where(sel, ri, r)
        g = self.eta * Pi + (1.0 - self.eta) * r
        if mirror:
            nd = self.normals.shape[1]
            mm = None
            for i, name in enumerate(self.names):
                if name in mirror:
                    s = self.family == i
                    mm = s if mm is None else (mm | s)
            un_i = (Pi[:, 2:2 + nd] * self.normals).sum(axis=1)
            corr = jnp.where(mm, 2.0 * self.eta[:, 0] * un_i, 0.0)
            if mirror_scale is not None:
                corr = corr * mirror_scale
            g = jnp.concatenate([
                g[:, :2],
                g[:, 2:2 + nd] - corr[:, None] * self.normals,
                g[:, 2 + nd:],
            ], axis=1)
        if guard is not None:
            g = guard(g)
        return P.at[self.ghost].set(
            g, unique_indices=True, indices_are_sorted=True
        )


@dataclasses.dataclass
class HostBoundary:
    """Global (pre-partitioning) boundary tables."""

    ghosts: np.ndarray          # int64[G] global cell ids
    projections: np.ndarray     # f32[G, nd]
    normals: np.ndarray         # f32[G, nd]
    image_distances: np.ndarray
    ghost_distances: np.ndarray
    interp_idx: np.ndarray      # int64[G, k] global cell ids
    interp_w: np.ndarray        # f32[G, k]


def _build_host_boundary(
    centers: np.ndarray,
    widths: np.ndarray,
    tree: cKDTree,
    ghosts: np.ndarray,
    projs: np.ndarray,
    ghost_ratio: float,
    exclude_cells: Optional[np.ndarray] = None,
    reflect_solid: bool = False,
    axis_stencils: bool = False,
) -> HostBoundary:
    """Ghost geometry + image-point stencils
    (reference ``src/ImmersedBoundary.jl:422-448``).

    ``exclude_cells`` (optional bool[N]): cells banned from the stencil
    source cloud. The reference samples image points over ALL cells —
    including cells INSIDE the solid. Wherever the geometry is thin
    (both sides of a sharp trailing edge), the in-solid cells there are
    ghosts of BOTH surfaces whose values interpolate each other through
    the eta-blend, and the coupled update iterates with gain > 1: the
    region runs away to the physicality caps (the round-2 "fine-mesh TE
    breakdown", root-caused in round 3). The STL boundary build passes
    the in-solid mask so image stencils only sample solved or fluid-side
    cells — no feedback loop through unsolved values. (Excluding ALL
    ghost cells is too much: the image point then sits at the edge of
    the source cloud and interpolation degrades to >3x extrapolation,
    which destabilizes the high-order scheme.)

    ``w_cap=1.5`` additionally falls degenerate/extrapolative stencils
    back to convex IDW weights: the eta-blended ghost update feeds image
    values back through the stencils every application, so its gain is
    bounded by eta * sum|w| — caps much above 1 leave slow instabilities
    on coarse meshes (w_cap=4 diverged the FAS smoothing on the 4e-2
    RAE2822 hierarchy within ~40 fixed-point iterations; 1.5 is stable
    there while keeping exact linear reproduction for ~99% of stencils
    on production meshes, which sit at sum|w| ~ 1.0-1.1).
    """
    gc = centers[ghosts]
    normals = gc - projs
    gd = np.sqrt((normals.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    # divide by max(gd, eps), NOT gd + eps: hypercube ghost normals must
    # come out as EXACT unit axis vectors, so that the ghost layers of one
    # column share bit-identical image points (and hence stencils — the
    # BlockedBC dedup keys on exact equality; gd + eps made every layer's
    # normal differ in the last ulps and defeated it)
    normals = normals / np.maximum(gd, _EPS32)[:, None]
    diam = np.sqrt((widths[ghosts].astype(np.float64) ** 2).sum(1)).astype(np.float32)
    image_d = diam * ghost_ratio + _EPS32
    if reflect_solid and exclude_cells is not None:
        # flagged deviation (classic sharp-interface ghost-cell geometry):
        # the reference's normals = ghost - proj point INTO the solid for
        # in-solid ghosts, so their image points land DEEPER IN THE SOLID
        # (src/ImmersedBoundary.jl:422-448 — interpolating unsolved data).
        # Reflecting flips those normals outward so every image point sits
        # on the FLUID side; combined with mirror_velocity this is the
        # textbook reflected-ghost slip wall.
        ins_g = exclude_cells[ghosts]
        normals = np.where(ins_g[:, None], -normals, normals)
    images = projs + normals * image_d[:, None]
    if axis_stencils and ghosts.size:
        # hypercube-family image stencils: the normal is an EXACT unit
        # axis vector and the image point sits on the ghost's own cell
        # column, so exact linear interpolation needs only the two
        # straddling column cells. (The generic kNN fit adds tie-broken
        # lateral cells whose near-zero weights differ per column; the
        # 2-point form is bit-identical across a face's columns — the
        # stencil-dedup/dense-plane BC fast paths key on that — and
        # halves the farfield gather rows. Flagged deviation from the
        # reference's uniform kNN interpolator, src/ImmersedBoundary.jl:
        # 422-448; both are exact on linear fields.)
        d_axis = np.abs(normals).argmax(axis=1)
        _, knn = tree.query(images, k=2, workers=-1)
        c0 = centers[knn[:, 0]]
        c1 = centers[knn[:, 1]]
        h_g = widths[ghosts].max(axis=1)
        ar = np.arange(ghosts.size)
        lat_ok = np.ones(ghosts.size, bool)
        for dd in range(centers.shape[1]):
            ld = dd != d_axis
            lat_ok &= np.where(
                ld,
                (np.abs(c0[:, dd] - images[:, dd]) < 0.05 * h_g)
                & (np.abs(c1[:, dd] - images[:, dd]) < 0.05 * h_g),
                True,
            )
        a0 = c0[ar, d_axis]
        a1 = c1[ar, d_axis]
        sep_ok = np.abs(a1 - a0) > 0.5 * h_g
        t = (images[ar, d_axis] - a0) / np.where(sep_ok, a1 - a0, 1.0)
        ok = lat_ok & sep_ok & (t > -0.1) & (t < 1.1)
        idx2 = np.stack([knn[:, 0], knn[:, 1]], axis=1).astype(np.int64)
        w2 = np.stack([1.0 - t, t], axis=1).astype(np.float32)
        if ok.all():
            return HostBoundary(
                ghosts=ghosts.astype(np.int64),
                projections=projs.astype(np.float32),
                normals=normals.astype(np.float32),
                image_distances=image_d,
                ghost_distances=gd,
                interp_idx=idx2,
                interp_w=w2,
            )
        # mixed: kNN-fit the non-conforming ghosts (refinement
        # transitions along the outer box), keep the axis pairs elsewhere
        st = interpolator(centers, images[~ok], tree, linear=True,
                          w_cap=1.5)
        K = max(2, np.asarray(st.idx).shape[1])
        idx_f = np.zeros((ghosts.size, K), np.int64)
        w_f = np.zeros((ghosts.size, K), np.float32)
        idx_f[ok, :2] = idx2[ok]
        idx_f[ok, 2:] = idx2[ok, :1]
        w_f[ok, :2] = w2[ok]
        ki = np.asarray(st.idx, np.int64)
        idx_f[~ok, :ki.shape[1]] = ki
        idx_f[~ok, ki.shape[1]:] = ki[:, :1]
        w_f[~ok, :ki.shape[1]] = np.asarray(st.w, np.float32)
        return HostBoundary(
            ghosts=ghosts.astype(np.int64),
            projections=projs.astype(np.float32),
            normals=normals.astype(np.float32),
            image_distances=image_d,
            ghost_distances=gd,
            interp_idx=idx_f,
            interp_w=w_f,
        )
    if exclude_cells is not None and exclude_cells.any():
        src = np.nonzero(~exclude_cells)[0]
        st = interpolator(centers[src], images, linear=True, w_cap=1.5)
        st = dataclasses.replace(
            st, idx=src[np.asarray(st.idx, dtype=np.int64)].astype(
                st.idx.dtype))
    else:
        st = interpolator(centers, images, tree, linear=True, w_cap=1.5)
    return HostBoundary(
        ghosts=ghosts.astype(np.int64),
        projections=projs.astype(np.float32),
        normals=normals.astype(np.float32),
        image_distances=image_d,
        ghost_distances=gd,
        interp_idx=np.asarray(st.idx, dtype=np.int64),
        interp_w=np.asarray(st.w, dtype=np.float32),
    )


def _pairs_to_padded(cells, items, weights, n_cells, min_width=1):
    """Scatter (cell, item, weight) pairs into padded [C, K] tables."""
    order = np.argsort(cells, kind="stable")
    cells_s = cells[order]
    items_s = items[order]
    w_s = weights[order]
    counts = np.bincount(cells_s, minlength=n_cells)
    K = max(int(counts.max()) if counts.size else 0, min_width)
    starts = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(cells_s.size) - starts[cells_s]
    idx = np.zeros((n_cells, K), dtype=np.int32)
    w = np.zeros((n_cells, K), dtype=np.float32)
    idx[cells_s, slot] = items_s
    w[cells_s, slot] = w_s
    # pad columns with the row's first entry (harmless gather)
    has = counts > 0
    for kcol in range(1, K):
        need = counts <= kcol
        fix = has & need
        idx[fix, kcol] = idx[fix, 0]
    return idx, w


class DomainExecutionMixin:
    """Functional counterparts of the reference's partition executor."""

    def map(self, f, *arrays):
        """Run ``f(part, *local_arrays) -> updated locals`` over partitions
        and scatter owned rows back (reference
        ``src/ImmersedBoundary.jl:820-864``, made functional).
        Returns the updated global arrays (tuple, or single array)."""
        arrays = [jnp.asarray(a) for a in arrays]
        if self.n_partitions == 1:
            res = f(self.partitions[0], *arrays)
            if not isinstance(res, (tuple, list)):
                return res
            return tuple(res) if len(res) > 1 else res[0]
        outs = list(arrays)
        for p, part in enumerate(self.partitions):
            dom_idx = self.part_domain[p]
            dargs = [jnp.take(a, dom_idx, axis=0) for a in arrays]
            res = f(part, *dargs)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            own = self.part_own[p]
            n_real = own.size
            for i, r in enumerate(res):
                outs[i] = outs[i].at[own].set(r[:n_real])
        return outs[0] if len(outs) == 1 else tuple(outs)

    def collect(self, f, *arrays):
        """Run ``f(part, *local_arrays) -> value`` over partitions and return
        the list of per-partition values (the reference executor's return
        collection)."""
        arrays = [jnp.asarray(a) for a in arrays]
        vals = []
        for p, part in enumerate(self.partitions):
            dom_idx = self.part_domain[p]
            dargs = [jnp.take(a, dom_idx, axis=0) for a in arrays]
            vals.append(f(part, *dargs))
        return vals


class Domain(DomainExecutionMixin):
    """Compiled domain (reference ``src/ImmersedBoundary.jl:536-786``).

    Parameters mirror the reference; ``n_partitions`` (default 1) replaces
    thread-count-driven chunking — use the number of devices you intend to
    shard over. ``max_partition_size`` is accepted for API parity and
    converted to a partition count.
    """

    def __init__(
        self,
        msh: Mesh,
        *,
        n_partitions: int = 1,
        max_partition_size: Optional[int] = None,
        partition_skirt_depth: int = 2,
        ghost_layer_ratio: float = 1.5,
        hypercube_families: Sequence[Tuple[str, Sequence[Tuple[int, bool]]]] = (),
        fluid_ghost_ratio: Optional[float] = None,
        reflect_solid_images: bool = False,
        solve_inside_cells: Optional[np.ndarray] = None,
        verbose: bool = False,
    ):
        # ``solve_inside_cells`` (bool[N], cut-cell wall support): in-solid
        # cells the scheme SOLVES (fluid fraction above the cut-cell
        # floor). They are dropped from STL ghost bands (the BC must not
        # overwrite solved cells) and stay eligible as image-stencil
        # sources. Not persisted into reconstruction_kwargs: coarse
        # multigrid rebuilds use the plain ghost bands.
        self.mesh = msh
        nd = msh.ndim
        self.nd = nd
        self._verbose = bool(verbose)
        self._t0 = time.time()
        self._t_stage = self._t0
        # stage name -> elapsed seconds (observability; the reference prints
        # stage banners + wall clock, src/ImmersedBoundary.jl:544-767)
        self.build_timings: Dict[str, float] = {}
        centers, widths, _ = get_cells(msh)
        N = centers.shape[0]
        self.ncells = N
        self.centers = centers
        self.widths = widths
        self.reconstruction_kwargs = dict(
            n_partitions=n_partitions,
            max_partition_size=max_partition_size,
            partition_skirt_depth=partition_skirt_depth,
            ghost_layer_ratio=ghost_layer_ratio,
            hypercube_families=list(hypercube_families),
            fluid_ghost_ratio=fluid_ghost_ratio,
            reflect_solid_images=reflect_solid_images,
        )

        self._stage("cells", f"{N} cells")

        if max_partition_size is not None:
            n_partitions = max(1, -(-N // max_partition_size))
        P = n_partitions

        origins = centers - widths / 2
        fdim, fo, fn = octree2faces_blocks(msh, origins, widths)
        hdim, ho, hn = hcube_faces(msh.origin, msh.widths, origins, widths)
        fdim = np.concatenate([fdim, hdim])
        fo = np.concatenate([fo, ho])
        fn = np.concatenate([fn, hn])
        self.face_dim, self.face_owner, self.face_neighbor = fdim, fo, fn
        self._stage("faces", f"{fdim.size} faces")

        # ---- global boundaries & surfaces ------------------------------
        tree = cKDTree(centers)
        diams = np.sqrt((widths.astype(np.float64) ** 2).sum(1)).astype(np.float32)
        self._host_boundaries: Dict[str, HostBoundary] = {}
        self.surfaces: Dict[str, Surface] = {}

        for bname, bfaces in hypercube_families:
            ghosts, projs = ghosts_and_projections_hcube(
                list(bfaces), msh.origin, msh.widths, centers, widths,
                ghost_layer_ratio=ghost_layer_ratio,
            )
            self._host_boundaries[bname] = _build_host_boundary(
                centers, widths, tree, ghosts, projs, ghost_layer_ratio,
                axis_stencils=True,
            )
            self._stage(f"boundary[{bname}]", f"{ghosts.size} ghosts")

        for bname, dfield in msh.distance_fields.items():
            ghosts, projs = ghosts_and_projections_stl(
                dfield, centers, widths, ghost_layer_ratio=ghost_layer_ratio
            )
            self._stage(f"ghosts[{bname}]", f"{ghosts.size} ghosts")
            # ban in-solid cells from image stencils (no BC feedback loop
            # through unsolved values at thin geometry; see
            # _build_host_boundary). Only cells in the ghost band can be
            # stencil sources, so classify just those and their vicinity.
            from ..geometry.inside import points_inside
            inside = None
            if dfield.stl.simplices.shape[0] and ghosts.size:
                inside = np.zeros(N, bool)
                inside[ghosts] = points_inside(
                    dfield.stl, centers[ghosts])
            if solve_inside_cells is not None and ghosts.size:
                keep = ~solve_inside_cells[ghosts]
                ghosts, projs = ghosts[keep], projs[keep]
                if inside is not None:
                    inside = inside & ~solve_inside_cells
                self._stage(f"ghost-solved[{bname}]",
                            f"{ghosts.size} kept (cut cells solved)")
            if fluid_ghost_ratio is not None and inside is not None:
                # flagged deviation from the reference's unsigned ghost
                # band (src/ImmersedBoundary.jl:194-230, which overwrites
                # the first ~2 ROWS OF FLUID CELLS with eta-blended image
                # values every application — a self-referential update
                # whose inner image points land on other ghost rows; at
                # fine resolution it manufactures a vortical slip layer
                # that sheds counter-circulation and collapses the lift,
                # measured in BASELINE.md round 3). With the flag, fluid-
                # side cells further than fluid_ghost_ratio * circumdiam
                # from the wall are SOLVED, and the wall enters through
                # the in-solid ghost rows (classic sharp-interface IB).
                gd = np.sqrt(((centers[ghosts] - projs).astype(np.float64)
                              ** 2).sum(1))
                keep = inside[ghosts] | (
                    gd <= fluid_ghost_ratio * diams[ghosts])
                ghosts, projs = ghosts[keep], projs[keep]
                self._stage(f"ghost-band[{bname}]",
                            f"{ghosts.size} kept (solid+{fluid_ghost_ratio}d)")
            self._host_boundaries[bname] = _build_host_boundary(
                centers, widths, tree, ghosts, projs, ghost_layer_ratio,
                exclude_cells=inside, reflect_solid=reflect_solid_images,
            )
            # postprocessing surface (reference src/ImmersedBoundary.jl:743-763)
            stl = dfield.stl
            fcenters, fnormals = centers_and_normals(stl)
            _, idx = tree.query(fcenters, k=1, workers=-1)
            h = diams[idx] * 1.01
            A = np.sqrt((fnormals.astype(np.float64) ** 2).sum(1)).astype(np.float32) + _EPS32
            unit_n = fnormals / A[:, None]
            bias = unit_n * h[:, None]
            self.surfaces[bname] = Surface(
                points=fcenters,
                offsets=h,
                normals=unit_n,
                areas=A,
                interpolator=interpolator(centers, fcenters, tree, bias=bias,
                                          linear=True),
                offset_interpolator=interpolator(
                    centers, fcenters + bias * ghost_layer_ratio, tree,
                    linear=True,
                ),
                stl=stl,
            )

        self._stage(
            "boundaries",
            f"{sum(hb.ghosts.size for hb in self._host_boundaries.values())}"
            " ghosts",
        )

        # ---- partitions -------------------------------------------------
        n_own = -(-N // P)
        self.n_partitions = P
        self.n_own = n_own
        self.partitions: List[Partition] = []
        self.part_own: List[np.ndarray] = []       # real owned global ids
        self.part_domain: List[np.ndarray] = []    # domain global ids (padded)
        self.part_own_mask: List[np.ndarray] = []
        self._part_g2l: List[np.ndarray] = []

        interior = (fo >= 0) & (fn >= 0)
        eo, en = fo[interior].astype(np.int64), fn[interior].astype(np.int64)

        for p in range(P):
            lo, hi = p * n_own, min((p + 1) * n_own, N)
            own = np.arange(lo, hi, dtype=np.int64)

            mask = np.zeros(N, dtype=bool)
            mask[own] = True
            for _ in range(partition_skirt_depth):
                add_o = en[mask[eo]]
                add_n = eo[mask[en]]
                mask[add_o] = True
                mask[add_n] = True
            # fold BC stencil cells of owned ghosts into the skirt
            for hb in self._host_boundaries.values():
                sel = (hb.ghosts >= lo) & (hb.ghosts < hi)
                if sel.any():
                    mask[hb.interp_idx[sel].reshape(-1)] = True

            mask[own] = False
            skirt = np.nonzero(mask)[0]
            pad = n_own - own.size
            domain = np.concatenate([
                own,
                np.zeros(pad, dtype=np.int64),   # padding slots gather cell 0
                skirt,
            ])
            n_dom = domain.size

            g2l = np.full(N, -1, dtype=np.int64)
            g2l[skirt] = np.arange(skirt.size) + n_own
            g2l[own] = np.arange(own.size)        # own wins over any overlap

            own_mask = np.zeros(n_dom, dtype=np.float32)
            own_mask[: own.size] = 1.0

            part = self._build_partition_tables(
                p, domain, g2l, own_mask, centers, widths
            )
            self.partitions.append(part)
            self.part_own.append(own)
            self.part_domain.append(domain)
            self.part_own_mask.append(own_mask)
            self._part_g2l.append(g2l)

        self._stage("partitions", f"{P} partitions, n_own={n_own}")

        # ---- localized boundaries --------------------------------------
        # boundaries[name][p] — per-partition blocks (empty blocks possible)
        self.boundaries: Dict[str, List[Boundary]] = {}
        self._ghost_global: Dict[str, List[np.ndarray]] = {}
        for bname, hb in self._host_boundaries.items():
            blocks = []
            ghost_globals = []
            for p in range(P):
                lo, hi = p * n_own, min((p + 1) * n_own, N)
                sel = (hb.ghosts >= lo) & (hb.ghosts < hi)
                blocks.append(self._localize_boundary(hb, sel, p))
                ghost_globals.append(hb.ghosts[sel])
            self.boundaries[bname] = blocks
            self._ghost_global[bname] = ghost_globals

        self._stage("localize_boundaries")

        # ---- single device placement pass --------------------------------
        # One bulk transfer of long-lived pytrees. Do NOT allocate/free
        # device buffers during the host compile above: odd-sized churn
        # fragments the device allocator.
        self.partitions = jax.device_put(self.partitions)
        self.boundaries = jax.device_put(self.boundaries)
        for surf in self.surfaces.values():
            surf.interpolator = jax.device_put(surf.interpolator)
            surf.offset_interpolator = jax.device_put(surf.offset_interpolator)
        self._stage("device_put")
        if self._verbose:
            print(f"[ibx.Domain] total {time.time() - self._t0:.2f}s")

    def _stage(self, name: str, note: str = "") -> None:
        """Record (and optionally print) a build-stage wall-clock."""
        now = time.time()
        self.build_timings[name] = now - self._t_stage
        if self._verbose:
            extra = f" ({note})" if note else ""
            print(f"[ibx.Domain] {name}: "
                  f"{self.build_timings[name]:.2f}s{extra}", flush=True)
        self._t_stage = now

    # -- builders ---------------------------------------------------------

    def _build_partition_tables(self, p, domain, g2l, own_mask,
                                centers, widths) -> Partition:
        nd = self.nd
        n_dom = domain.size
        in_dom = np.zeros(self.ncells + 1, dtype=bool)
        in_dom[domain] = True

        fdim, fo, fn = self.face_dim, self.face_owner, self.face_neighbor
        # sentinel trick: in_dom has N+1 entries and in_dom[-1] == in_dom[N]
        # == False, so the -1 "outside" marker tests False directly
        touches = in_dom[fo] | in_dom[fn]

        face_owner, face_neighbor, acc_left, acc_right = [], [], [], []
        for d in range(nd):
            sel = touches & (fdim == d)
            o_g = fo[sel].astype(np.int64)
            n_g = fn[sel].astype(np.int64)
            o_l = np.where(o_g >= 0, g2l[o_g], -1)
            n_l = np.where(n_g >= 0, g2l[n_g], -1)
            # one-sided handling (reference src/ImmersedBoundary.jl:648-667)
            add_right = o_l >= 0
            add_left = n_l >= 0
            o_f = np.where(o_l < 0, n_l, o_l)
            n_f = np.where(n_l < 0, o_f, n_l)

            F = o_f.size
            face_owner.append(o_f.astype(np.int32))
            face_neighbor.append(n_f.astype(np.int32))

            face_ids = np.arange(F, dtype=np.int64)
            for side_cells, add, store in (
                (n_f, add_left, acc_left),
                (o_f, add_right, acc_right),
            ):
                cc = side_cells[add]
                ff = face_ids[add]
                counts = np.bincount(cc, minlength=n_dom).astype(np.float64)
                w = 1.0 / counts[cc]
                idx_t, w_t = _pairs_to_padded(
                    cc, ff.astype(np.int32), w.astype(np.float32), n_dom
                )
                store.append(stencil_from_padded(idx_t, w_t))

        return Partition(
            centers=centers[domain].astype(np.float32),
            spacing=widths[domain].astype(np.float32),
            face_owner=tuple(face_owner),
            face_neighbor=tuple(face_neighbor),
            acc_left=tuple(acc_left),
            acc_right=tuple(acc_right),
            own_mask=own_mask,
            n_own=int(self.n_own),
            n_dom=int(n_dom),
            nd=nd,
        )

    def _localize_boundary(self, hb: HostBoundary, sel: np.ndarray,
                           p: int) -> Boundary:
        g2l = self._part_g2l[p]
        n_dom = self.part_domain[p].size
        ghosts_l = g2l[hb.ghosts[sel]]
        idx_l = g2l[hb.interp_idx[sel]]
        assert (ghosts_l >= 0).all() and (idx_l >= 0).all(), \
            "boundary stencil escaped partition domain"
        G = int(sel.sum())
        gd = hb.ghost_distances[sel]
        idist = hb.image_distances[sel]
        return Boundary(
            ghost=ghosts_l.astype(np.int32),
            projections=hb.projections[sel],
            normals=hb.normals[sel],
            image_distances=idist,
            ghost_distances=gd,
            eta=(gd / idist).astype(np.float32),
            interp=stencil_from_padded(idx_l, hb.interp_w[sel]),
            valid=np.ones(G, dtype=np.float32),
            n_ghost=G,
        )

    # -- boundary imposition ------------------------------------------------

    def impose_bc(self, name: str, fn, *arrays, mirror_velocity=False,
                  **kwargs):
        """Functional ghost-cell BC application (reference
        ``src/ImmersedBoundary.jl:1197-1247``).

        ``fn(bdry, *image_values, **kwargs)`` maps image-point values to
        boundary values; ghosts blend ``eta * image + (1 - eta) * bc``.
        ``mirror_velocity`` flips the first array's ghost normal velocity
        to -eta*u_n(image) (flagged deviation; see FusedBoundary).
        Returns the updated global arrays.
        """
        arrays = [jnp.asarray(a) for a in arrays]
        outs = list(arrays)
        for p, bdry in enumerate(self.boundaries[name]):
            if bdry.n_ghost == 0:
                continue
            dom_idx = self.part_domain[p]
            if self.n_partitions == 1:
                dargs = arrays
            else:
                dargs = [jnp.take(a, dom_idx, axis=0) for a in arrays]
            iargs = [bdry.interp(a) for a in dargs]
            res = fn(bdry, *iargs, **kwargs)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            ghost_global = self._ghost_global[name][p]
            for i, (ia, ba) in enumerate(zip(iargs, res)):
                eta = bdry.eta.reshape(bdry.eta.shape + (1,) * (ia.ndim - 1))
                gvals = eta * ia + (1.0 - eta) * ba
                if mirror_velocity is not False and i == 0:
                    nd = bdry.normals.shape[1]
                    un_i = (ia[:, 2:2 + nd] * bdry.normals).sum(axis=1)
                    corr = 2.0 * bdry.eta * un_i
                    if mirror_velocity is not True:
                        # array gate aligned with this family's ghosts
                        corr = corr * mirror_velocity

                    gvals = jnp.concatenate([
                        gvals[:, :2],
                        gvals[:, 2:2 + nd] - corr[:, None] * bdry.normals,
                        gvals[:, 2 + nd:],
                    ], axis=1)
                outs[i] = outs[i].at[jnp.asarray(ghost_global)].set(
                    gvals, unique_indices=True, indices_are_sorted=True
                )
        return outs[0] if len(outs) == 1 else tuple(outs)

    def fused_boundary(self, names: Sequence[str]) -> "FusedBoundary":
        """Fuse several boundary families into ONE image-interpolation gather
        and ONE sorted ghost scatter (see ``FusedBoundary.__call__``). Ghost
        sets must be disjoint (they are for distinct families by
        construction). Single-partition domains only —
        the sharded executor localizes its own fused tables.
        """
        if self.n_partitions != 1:
            raise ValueError("fused_boundary requires n_partitions == 1")
        names = list(names)
        ghost_list, idx_list, w_list = [], [], []
        normal_list, eta_list, fam_list = [], [], []
        for i, name in enumerate(names):
            hb = self._host_boundaries[name]
            ghost_list.append(hb.ghosts)
            idx_list.append(hb.interp_idx)
            w_list.append(hb.interp_w)
            normal_list.append(hb.normals)
            eta_list.append(hb.ghost_distances / hb.image_distances)
            fam_list.append(np.full(hb.ghosts.size, i, dtype=np.int32))
        ghosts = np.concatenate(ghost_list)
        if np.unique(ghosts).size != ghosts.size:
            raise ValueError("fused families share ghost cells")
        order = np.argsort(ghosts)
        K = max(a.shape[1] for a in idx_list)

        def padk(a, fill):
            if a.shape[1] == K:
                return a
            pad = np.repeat(a[:, :1] if fill else np.zeros_like(a[:, :1]),
                            K - a.shape[1], axis=1)
            return np.concatenate([a, pad], axis=1)

        idx = np.concatenate([padk(a, True) for a in idx_list])[order]
        w = np.concatenate([padk(a, False) for a in w_list])[order]
        fb = FusedBoundary(
            ghost=jnp.asarray(ghosts[order].astype(np.int32)),
            interp=stencil_from_padded(idx.astype(np.int32),
                                       w.astype(np.float32)),
            normals=jnp.asarray(np.concatenate(normal_list)[order]),
            eta=jnp.asarray(
                np.concatenate(eta_list)[order].astype(np.float32)[:, None]
            ),
            family=jnp.asarray(np.concatenate(fam_list)[order]),
            names=tuple(names),
        )
        return jax.device_put(fb)

    def volume_integral(self, A):
        """Cell-volume-weighted integral (reference
        ``src/ImmersedBoundary.jl:1415-1431``)."""
        vol = jnp.asarray(np.prod(self.widths, axis=1))
        A = jnp.asarray(A)
        return (A * vol.reshape(vol.shape + (1,) * (A.ndim - 1))).sum(axis=0)

    def __len__(self):
        return self.ncells
