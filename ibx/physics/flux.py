"""Inviscid and viscous flux functions (device side, pure array math).

Counterpart of reference ``src/cfd.jl:448-736``. ``dim`` may be an integer
(Cartesian face-normal dimension, 0-based) or a float[F, nd] matrix of face
normals.
"""

from __future__ import annotations

from typing import Sequence, Union

import jax.numpy as jnp

from .fluid import Fluid, primitive2state, speed_of_sound


def _normal_velocity(P, dim):
    if isinstance(dim, int):
        return P[..., 2 + dim]
    return (dim * P[..., 2:]).sum(axis=-1)


def _flux_one_side(fluid: Fluid, P, dim):
    """Q, F = state and directed inviscid flux for one side.

    Components on the last axis; any leading shape.
    """
    Q = primitive2state(fluid, P)
    p = P[..., 0:1]
    u_n = _normal_velocity(P, dim)
    un = u_n[..., None]
    # build the flux by concatenation, not channel-indexed .at[].add
    mom = Q[..., 2:] * un
    if isinstance(dim, int):
        mom = jnp.concatenate(
            [mom[..., :dim], mom[..., dim:dim + 1] + p, mom[..., dim + 1:]],
            axis=-1,
        )
    else:
        mom = mom + p * dim
    F = jnp.concatenate(
        [Q[..., 0:1] * un, (Q[..., 1:2] + p) * un, mom], axis=-1
    )
    return Q, F, u_n


def inviscid_fluxes_hll(fluid: Fluid, PL, PR, dim: Union[int, jnp.ndarray],
                        *, fix=None):
    """HLL flux from left/right primitive states
    (reference ``src/cfd.jl:459-508``, including its wave-speed choice
    ``SL = max(uL + aL, 0)``, ``SR = min(uR - aR, 0)``).

    ``fix`` (optional [..., 1] blend in [0, 1]): where > 0, widens the
    wave speeds toward the two-sided Einfeldt/Davis bounds
    ``SL = max(uL + aL, uR + aR, 0)``, ``SR = min(uL - aL, uR - aR, 0)``
    — an entropy fix for strong expansions (the reference's one-sided
    speeds return F = 0 on bilateral-rarefaction faces, which lets the
    sharp-trailing-edge expansion run to vacuum on fine meshes). Default
    None keeps the reference formula bit-exact.
    """
    QL, FL, uL = _flux_one_side(fluid, PL, dim)
    QR, FR, uR = _flux_one_side(fluid, PR, dim)
    aL = speed_of_sound(fluid, PL[..., 1])
    aR = speed_of_sound(fluid, PR[..., 1])
    SL = jnp.maximum(uL + aL, 0.0)[..., None]
    SR = jnp.minimum(uR - aR, 0.0)[..., None]
    if fix is not None:
        SLe = jnp.maximum(SL, (uR + aR)[..., None])
        SRe = jnp.minimum(SR, (uL - aL)[..., None])
        SL = SL + fix * (SLe - SL)
        SR = SR + fix * (SRe - SR)
    # SL = SR = 0 on a supersonic-rarefaction face (uL < -aL and uR > aR,
    # e.g. the deepening trailing-edge expansion on fine meshes): the
    # reference formula then divides 0/0 and the march NaNs. Guard exactly
    # those degenerate faces (F = 0, the vacuum-interface flux) and keep
    # the reference formula bit-exact everywhere else.
    denom = SL - SR
    safe = denom > 0
    return jnp.where(
        safe,
        (SL * FL - SR * FR + SR * SL * (QR - QL))
        / jnp.where(safe, denom, 1.0),
        0.0,
    )


def inviscid_fluxes_dissipative(
    fluid: Fluid, PL, PR, nuL, nuR, dim: Union[int, jnp.ndarray]
):
    """Central flux + Rusanov-style sensor-scaled dissipation
    (reference ``src/cfd.jl:516-554``)."""
    UcL = primitive2state(fluid, PL).at[:, 1].add(PL[:, 0])
    UcR = primitive2state(fluid, PR).at[:, 1].add(PR[:, 0])
    P = (PL + PR) / 2
    p = P[:, 0]
    u = _normal_velocity(P, dim)
    a = speed_of_sound(fluid, P[:, 1])
    F = (UcL + UcR) * u[:, None] / 2
    if isinstance(dim, int):
        F = F.at[:, 2 + dim].add(p)
    else:
        F = F.at[:, 2:].add(p[:, None] * dim)
    nu = jnp.maximum(jnp.asarray(nuL), jnp.asarray(nuR))
    if nu.ndim == 1:
        nu = nu[:, None]
    return F + (UcL - UcR) * (nu * (a + jnp.abs(u))[:, None] / 2)


# reference-parity alias dispatching on arity
def inviscid_fluxes(fluid, PL, PR, *args):
    if len(args) == 1:
        return inviscid_fluxes_hll(fluid, PL, PR, args[0])
    if len(args) == 3:
        return inviscid_fluxes_dissipative(fluid, PL, PR, *args)
    raise TypeError("inviscid_fluxes takes (PL, PR, dim) or (PL, PR, nuL, nuR, dim)")


def jst_sensor_3pt(Pim1, Pi, Pip1):
    """Classic 3-point JST pressure sensor (reference ``src/cfd.jl:563-573``)."""
    eps = 1e-14
    return (jnp.abs(Pim1 + Pip1 - 2 * Pi) + eps) / (
        jnp.abs(Pim1 - Pi) + jnp.abs(Pip1 - Pi) + eps
    )


def shock_sensor(velocity_gradients):
    """Ducros-style div^2/(div^2+|curl|^2) sensor (reference
    ``src/cfd.jl:589-617``). ``velocity_gradients[i][j]`` = d u_i / d x_j,
    a nested sequence of arrays.
    """
    eps = 1e-14
    nd = len(velocity_gradients)
    divu = velocity_gradients[0][0]
    vort2 = jnp.zeros_like(divu)
    divu = jnp.zeros_like(divu)
    for i in range(nd):
        i_n = (i + 1) % nd
        i_nn = (i_n + 1) % nd
        divu = divu + velocity_gradients[i][i]
        vort2 = vort2 + (
            velocity_gradients[i_nn][i_n] - velocity_gradients[i_n][i_nn]
        ) ** 2
    div2 = divu ** 2
    return (div2 + eps) / (div2 + vort2 + eps)


def viscous_fluxes(
    fluid: Fluid,
    P,
    Pgrad: Sequence,
    dim: Union[int, jnp.ndarray],
    *,
    mu_t=0.0,
):
    """Newtonian viscous + heat-conduction fluxes (reference
    ``src/cfd.jl:664-736``). ``Pgrad[j]`` is the primitive-variable gradient
    along axis j (same layout as P); ``mu_t`` an optional eddy viscosity.
    Accepts flat [N, C] or grid [..., C] layouts (components on the last
    axis).
    """
    from .fluid import dynamic_viscosity, heat_conductivity

    T = P[..., 1]
    mu = dynamic_viscosity(fluid, T) + mu_t
    k = heat_conductivity(fluid, T)
    nd = P.shape[-1] - 2

    def vel_grad(i, j):
        return Pgrad[j][..., 2 + i]

    divu = vel_grad(0, 0)
    for i in range(1, nd):
        divu = divu + vel_grad(i, i)

    def tau(i, j):
        t = vel_grad(i, j) + vel_grad(j, i)
        if i == j:
            t = t - (2.0 / 3.0) * divu
        return t * mu

    F = [jnp.zeros_like(T) for _ in range(nd + 2)]
    if isinstance(dim, int):
        F[1] = Pgrad[dim][..., 1] * k
        for j in range(nd):
            F[1] = F[1] + tau(dim, j) * P[..., 2 + j]
            F[2 + j] = tau(dim, j)
    else:
        tau_dim = []
        for i in range(nd):
            s = jnp.zeros_like(T)
            for j in range(nd):
                s = s + tau(i, j) * dim[..., j]
            tau_dim.append(s)
        for j in range(nd):
            F[1] = F[1] + Pgrad[j][..., 1] * k * dim[..., j]
            F[1] = F[1] + tau_dim[j] * P[..., 2 + j]
            F[2 + j] = tau_dim[j]
    return jnp.stack(F, axis=-1)
