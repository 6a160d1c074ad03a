"""Sharded BLOCK fast path vs single-device grid fast path parity.

The key multi-chip correctness check (SURVEY §4: partition-count
invariance), on the dense block path: an 8-virtual-device march must match
the single-device march to f32 round-off.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ibx.cases.rae2822_block_sharded import build_rae2822_block_sharded


def test_sharded_block_matches_single_device():
    sbd, step, P0_sh, case = build_rae2822_block_sharded(
        8, wall_h=4e-2, feature_h=2e-2, cfl=0.7)
    assert len(sbd.offs) >= 1           # real neighbor exchange happening
    # initial distribution roundtrip
    np.testing.assert_array_equal(
        sbd.collect(P0_sh), np.asarray(case.P0))

    P_sh = P0_sh
    P_ref = case.P0
    for _ in range(5):
        P_sh, res_sh = step(P_sh)
        P_ref, res_ref = case.step(P_ref)
    out = sbd.collect(P_sh)
    ref = np.asarray(P_ref)
    assert np.isfinite(out).all()
    scale = np.abs(ref).max(axis=0)
    err = (np.abs(out - ref) / scale).max()
    assert err < 2e-5, f"sharded-vs-single mismatch {err}"
    # residual norms agree too
    np.testing.assert_allclose(float(res_sh), float(res_ref), rtol=1e-3)

    # --- shock-developed state: the JST sensor is active, so face fluxes
    # at chunk boundaries consume nu3/du3 AT halo cells — this is what the
    # round-2 one-ring halo got wrong (7.5e-4 error, invisible from
    # freestream where the sensor vanishes). March single-device into the
    # nonlinear regime, then demand step parity to f32 round-off.
    P_dev = np.asarray(case.march(case.P0, 400))
    P_sh = sbd.distribute(P_dev)
    P_ref = jnp.asarray(P_dev)
    for _ in range(3):
        P_sh, _ = step(P_sh)
        P_ref, _ = case.step(P_ref)
    out = sbd.collect(P_sh)
    ref = np.asarray(P_ref)
    assert np.isfinite(out).all()
    scale = np.abs(ref).max(axis=0)
    err = (np.abs(out - ref) / scale).max()
    # band: 3 RK2 steps of f32 summation-order noise near the shock (the
    # sharded BC gathers sum in a different order than BlockedBC's patch
    # path). Recalibrated round 3 after w_cap=1.5 shifted the 400-step
    # setup trajectory (measured 4.2e-5); the one-ring halo bug this test
    # exists to catch produced 7.5e-4 — an order more.
    assert err < 1e-4, f"sharded-vs-single (shocked) mismatch {err}"


@pytest.mark.slow   # minutes each on the CPU; the core 2D parity test
# above stays in the fast tier
def test_sharded_sphere3d_matches_single_device():
    """3D leg of the multi-chip parity check (VERDICT round-2 item 4)."""
    from ibx.cases.sphere3d_block_sharded import build_sphere3d_block_sharded

    sbd, step, P0_sh, case = build_sphere3d_block_sharded(8, wall_h=0.15)
    assert len(sbd.offs) >= 1
    np.testing.assert_array_equal(sbd.collect(P0_sh), np.asarray(case.P0))

    # develop the flow a little single-device so gradients/sensor are
    # nonzero, then demand step parity
    P_dev = np.asarray(case.march(case.P0, 50))
    P_sh = sbd.distribute(P_dev)
    P_ref = jnp.asarray(P_dev)
    for _ in range(3):
        P_sh, res_sh = step(P_sh)
        P_ref, res_ref = case.step(P_ref)
    out = sbd.collect(P_sh)
    ref = np.asarray(P_ref)
    assert np.isfinite(out).all()
    scale = np.abs(ref).max(axis=0)
    err = (np.abs(out - ref) / scale).max()
    assert err < 2e-5, f"3D sharded-vs-single mismatch {err}"
    # no resnorm comparison: the single-device step reports the UNMASKED
    # residual norm, which on the sphere is dominated by frozen
    # solid-interior cells that the sharded step masks out
    assert np.isfinite(float(res_sh))
    del res_ref


@pytest.mark.slow   # minutes each on the CPU; the core 2D parity test
# above stays in the fast tier
def test_sharded_overlap_matches_single_device():
    """Interior/frontier overlap split (VERDICT round-2 item 3): same
    numerics as the monolithic sharded step, hence as single-device."""
    sbd, step, P0_sh, case = build_rae2822_block_sharded(
        8, wall_h=4e-2, feature_h=2e-2, cfl=0.7, overlap=True)
    assert sbd.overlap
    P_dev = np.asarray(case.march(case.P0, 400))
    P_sh = sbd.distribute(P_dev)
    P_ref = jnp.asarray(P_dev)
    for _ in range(3):
        P_sh, _ = step(P_sh)
        P_ref, _ = case.step(P_ref)
    out = sbd.collect(P_sh)
    ref = np.asarray(P_ref)
    assert np.isfinite(out).all()
    scale = np.abs(ref).max(axis=0)
    err = (np.abs(out - ref) / scale).max()
    assert err < 1e-4, f"overlap sharded-vs-single mismatch {err}"


@pytest.mark.slow   # minutes each on the CPU; the core 2D parity test
# above stays in the fast tier
def test_sharded_te_fix_matches_single_device():
    """fix3 (TE robustness blend) through the sharded path: static local
    fix field must reproduce the single-device fix3 march."""
    sbd, step, P0_sh, case = build_rae2822_block_sharded(
        4, wall_h=4e-2, feature_h=2e-2, cfl=0.7, te_fix_radius=0.1)
    P_dev = np.asarray(case.march(case.P0, 50))
    P_sh = sbd.distribute(P_dev)
    P_ref = jnp.asarray(P_dev)
    scale = np.abs(P_dev).max(axis=0)

    # ONE step, tight band: the halo-ring bug class this file guards
    # against corrupts the very first RHS (advisor's measured 7.5e-4 from
    # a shocked state), while layout-order f32 noise after one step is
    # ~8e-6. Multi-step comparisons are a WEAKER detector here: this
    # case's 50-step TE transient amplifies the f32 seed geometrically at
    # the te-fix blend's minmod switching boundary (measured 6.4e-4 by
    # step 3, saturating ~1.4e-3 by step 8 — location-stable, first-step
    # clean, i.e. noise amplification, not halo corruption).
    P_sh, _ = step(P_sh)
    P_ref, _ = case.step(P_ref)
    err1 = (np.abs(sbd.collect(P_sh) - np.asarray(P_ref)) / scale).max()
    assert err1 < 1e-4, f"sharded te-fix first-step mismatch {err1}"

    for _ in range(2):
        P_sh, _ = step(P_sh)
        P_ref, _ = case.step(P_ref)
    err = (np.abs(sbd.collect(P_sh) - np.asarray(P_ref)) / scale).max()
    assert err < 2e-3, f"sharded te-fix mismatch {err}"
