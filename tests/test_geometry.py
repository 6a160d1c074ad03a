import numpy as np
import pytest

from ibx.geometry import (
    Ball,
    Box,
    DistanceField,
    Line,
    Mesh,
    Stereolitography,
    build_mesh,
    centers_and_normals,
    feature_regions,
    get_cells,
    load_surface,
    merge_points,
    polyline,
    refine_octree,
    refine_to_length,
)
from ibx.cases.rae2822 import RAE_DAT


def test_polyline_closed_open():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    closed = polyline(pts, closed=True)
    assert closed.simplices.shape == (3, 2)
    assert closed.simplices[-1].tolist() == [2, 0]
    open_ = polyline(pts, closed=False)
    assert open_.simplices.shape == (2, 2)


def test_load_selig_dat():
    stl = load_surface(RAE_DAT)
    assert stl.points.shape == (129, 2)
    assert stl.simplices.shape == (129, 2)


def test_merge_points_dedup_and_degenerate():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1e-9], [0.0, 0.0]])
    stl = Stereolitography(pts, [[0, 1], [2, 3], [0, 3]])
    merged = merge_points(stl, tolerance=1e-7)
    assert merged.points.shape[0] == 2  # all dupes collapse
    # [0,3] becomes degenerate and is dropped
    assert merged.simplices.shape[0] == 2


def test_centers_and_normals_2d():
    stl = polyline(np.array([[0.0, 0.0], [2.0, 0.0]]), closed=False)
    c, n = centers_and_normals(stl)
    np.testing.assert_allclose(c, [[1.0, 0.0]])
    np.testing.assert_allclose(n, [[0.0, -2.0]])  # (vy, -vx), |n| = length


def test_refine_to_length_satisfies_target():
    stl = polyline(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]))
    refined = refine_to_length(stl, 0.13)
    coords = refined.points[refined.simplices]
    L = np.sqrt(((coords[:, 1] - coords[:, 0]) ** 2).sum(1))
    assert L.max() <= 0.13 + 1e-6
    # closed loop is preserved: every point is used exactly twice
    counts = np.bincount(refined.simplices.reshape(-1))
    assert np.all(counts == 2)


def test_analytic_distances():
    box = Box([0.0, 0.0], [1.0, 1.0])
    np.testing.assert_allclose(box(np.array([[0.5, 0.5]])), [0.0])
    np.testing.assert_allclose(box(np.array([[2.0, 0.5]])), [1.0])
    ball = Ball([0.0, 0.0], 1.0)
    np.testing.assert_allclose(ball(np.array([[2.0, 0.0]])), [1.0])
    line = Line([0.0, 0.0], [1.0, 0.0])
    np.testing.assert_allclose(line(np.array([[0.5, 0.3]])), [0.3])
    np.testing.assert_allclose(line(np.array([[2.0, 0.0]])), [1.0])


def test_distance_field_projection_exact():
    # unit square boundary; projections should land on the square
    stl = refine_to_length(
        polyline(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])),
        0.05,
    )
    df = DistanceField(stl)
    pts = np.array([[0.5, 0.2], [1.3, 0.5], [0.5, 0.5]], dtype=np.float32)
    proj, dist = df.projection(pts, R=np.full(3, 1.0))
    np.testing.assert_allclose(dist, [0.2, 0.3, 0.5], atol=1e-5)
    np.testing.assert_allclose(proj[0], [0.5, 0.0], atol=1e-5)
    np.testing.assert_allclose(proj[1], [1.0, 0.5], atol=1e-5)


def test_projection_exact_at_fine_scales():
    # regression: an absolute epsilon in the segment/triangle projection
    # denominators (uu ~ L^2, det ~ L^4) dominated at L <~ 5e-4 and
    # vertex-snapped every foot point — +-25 deg ghost-normal noise that
    # grew under wall refinement (the round-3 "fine-mesh accuracy floor").
    from ibx.geometry.refine import project_on_segments, project_on_triangles

    L = 2e-4
    # point above the 40% station of a tiny horizontal segment
    seg = np.array([[[0.3, -0.05], [0.3 + L, -0.05]]])
    p = np.array([[0.3 + 0.4 * L, -0.05 + 0.8 * L]])
    q = project_on_segments(seg, p)
    np.testing.assert_allclose(q, [[0.3 + 0.4 * L, -0.05]], rtol=0, atol=1e-9)

    # interior projection onto a tiny 3D triangle (det ~ L^4 ~ 1.6e-15)
    tri = np.array([[[0.0, 0.0, 0.0], [L, 0.0, 0.0], [0.0, L, 0.0]]])
    p3 = np.array([[0.25 * L, 0.25 * L, 0.5 * L]])
    q3 = project_on_triangles(tri, p3)
    np.testing.assert_allclose(
        q3, [[0.25 * L, 0.25 * L, 0.0]], rtol=0, atol=1e-9)

    # degenerate (zero-length) segment and sliver triangle stay finite
    seg0 = np.array([[[1.0, 1.0], [1.0, 1.0]]])
    q0 = project_on_segments(seg0, np.array([[2.0, 1.0]]))
    np.testing.assert_allclose(q0, [[1.0, 1.0]])
    sliver = np.array([[[0.0, 0.0, 0.0], [L, 0.0, 0.0], [2 * L, 0.0, 0.0]]])
    qs = project_on_triangles(sliver, np.array([[L, L, 0.0]]))
    np.testing.assert_allclose(qs, [[L, 0.0, 0.0]], rtol=0, atol=1e-9)


def test_feature_regions_sharp_corner():
    # L-shaped open polyline: the corner simplices are features
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    stl = polyline(pts, closed=False)
    feats = feature_regions(stl, angle=15.0)
    assert feats.simplices.shape[0] == 2  # both segments meet at 90 deg


def test_refine_octree_growth_and_criteria():
    ball = Ball([0.0, 0.0], 0.1)
    bo, bw = refine_octree([(ball, 0.05)], [0.0, 0.0], [1.0, 1.0], 2.0)
    # all blocks near the ball satisfy h
    centers = bo + bw / 2
    R = np.sqrt((bw ** 2).sum(1)) / 2
    L = bw.max(1)
    lmax = np.maximum((2.0 - 1.0) * (ball(centers) - R), 0.05)
    assert np.all(L <= lmax + 1e-6)
    # blocks tile the unit square exactly
    np.testing.assert_allclose(np.prod(bw, axis=1).sum(), 1.0, rtol=1e-6)


def test_get_cells_ordering_and_coverage():
    msh = Mesh(
        origin=np.zeros(2, np.float32),
        widths=np.ones(2, np.float32),
        block_size=2,
        block_origins=np.array([[0.0, 0.0], [0.5, 0.0]], np.float32),
        block_widths=np.array([[0.5, 0.5], [0.5, 1.0]], np.float32),
        distance_fields={},
    )
    centers, widths, margin = get_cells(msh)
    assert centers.shape == (8, 2)
    # block 0, axis-0 fastest: (0.125,0.125), (0.375,0.125), (0.125,0.375)...
    np.testing.assert_allclose(
        centers[:4],
        [[0.125, 0.125], [0.375, 0.125], [0.125, 0.375], [0.375, 0.375]],
    )
    np.testing.assert_allclose(widths[0], [0.25, 0.25])
    np.testing.assert_allclose(widths[4], [0.25, 0.5])
    assert not margin.any()


def test_build_mesh_rae2822():
    stl = merge_points(load_surface(RAE_DAT))
    msh = build_mesh(
        [-25.0, -25.0], [50.0, 50.0],
        ("wall", stl, 0.1),
        block_size=4,
    )
    assert msh.n_blocks > 10
    assert "wall" in msh.distance_fields
    centers, widths, _ = get_cells(msh)
    assert len(msh) == centers.shape[0]
    # mesh covers the domain exactly
    np.testing.assert_allclose(
        np.prod(msh.block_widths, axis=1).sum(), 2500.0, rtol=1e-4
    )


def test_project_on_ksimplices():
    """Arbitrary-arity simplex projection (reference proj2simplex,
    src/mesher.jl:544-596): validated against a dense barycentric
    brute-force minimum on random tetrahedra (k=4) and 4-simplices in
    5D (k=5)."""
    from ibx.geometry.refine import project_on_simplices

    rng = np.random.default_rng(11)

    def brute(simp, pt, n=24):
        # dense barycentric sampling of the simplex
        k = simp.shape[0]
        w = rng.dirichlet(np.ones(k), size=4000)
        cand = w @ simp
        d = ((cand - pt) ** 2).sum(1)
        return np.sqrt(d.min())

    for k, nd in ((4, 3), (5, 5)):
        simp = rng.standard_normal((40, k, nd)).astype(np.float64)
        pts = 2.0 * rng.standard_normal((40, nd))
        proj = project_on_simplices(simp, pts)
        # every foot point lies (numerically) inside the simplex: its
        # distance is a valid upper bound of the true minimum
        d_proj = np.sqrt(((proj - pts) ** 2).sum(1))
        for q in range(40):
            d_ref = brute(simp[q], pts[q])
            assert d_proj[q] <= d_ref + 1e-7, (q, d_proj[q], d_ref)
        # interior points of a full-dimensional simplex project to
        # themselves
        if k == nd + 1:
            center = simp.mean(axis=1)
            pc = project_on_simplices(simp, center)
            np.testing.assert_allclose(pc, center, atol=1e-12)

    # tiny-scale regression (the round-3 bug class): a 1e-4-sized tet
    # must project exactly like its unit-scale copy
    simp = rng.standard_normal((10, 4, 3))
    pts = rng.standard_normal((10, 3))
    big = project_on_simplices(simp, pts)
    small = project_on_simplices(simp * 1e-4, pts * 1e-4)
    np.testing.assert_allclose(small, big * 1e-4, rtol=1e-6, atol=1e-12)

    # degenerate (rank-deficient) simplex: falls through to the facets
    flat = np.stack([np.zeros(3), np.eye(3)[0], np.eye(3)[1],
                     np.eye(3)[0] + np.eye(3)[1]])[None]
    p = np.array([[0.3, 0.3, 1.0]])
    out = project_on_simplices(flat, p)
    np.testing.assert_allclose(out, [[0.3, 0.3, 0.0]], atol=1e-12)
