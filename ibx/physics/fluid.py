"""Ideal-gas fluid model, variable transforms, atmosphere (device side).

Counterpart of reference ``src/cfd.jl:14-151,304-426,619-654,747-802``.
Deliberately replicated quirks (for output parity with the reference):
R defaults to 283.0 (nonstandard), Sutherland-style viscosity uses exponent
2/3 (the classic law uses 3/2), and temperatures clamp at 10 K.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

import jax.numpy as jnp

from ..utils import pytree_dataclass


@pytree_dataclass(meta_fields=())
class Fluid:
    """Ideal gas with polynomial heat conductivity and Sutherland-style
    viscosity (reference ``src/cfd.jl:14-53``)."""

    R: jnp.ndarray
    gamma: jnp.ndarray
    k: jnp.ndarray
    mu_ref: jnp.ndarray
    T_ref: jnp.ndarray
    S: jnp.ndarray


def make_fluid(
    R: float = 283.0,
    gamma: float = 1.4,
    k: Union[float, Sequence[float]] = (0.00646, 6.468e-5),
    mu_ref: float = 1.716e-5,
    T_ref: float = 273.15,
    S: float = 110.4,
) -> Fluid:
    """Fluid constructor with the reference's air defaults
    (``src/cfd.jl:40-53``)."""
    if np.isscalar(k):
        k = (float(k),)
    return Fluid(
        R=jnp.float32(R),
        gamma=jnp.float32(gamma),
        k=jnp.asarray(k, dtype=jnp.float32),
        mu_ref=jnp.float32(mu_ref),
        T_ref=jnp.float32(T_ref),
        S=jnp.float32(S),
    )


def _clampT(T):
    return jnp.clip(T, 10.0, None)


def speed_of_sound(fluid: Fluid, T):
    """a = sqrt(gamma R T), T clamped (reference ``src/cfd.jl:62-64``)."""
    return jnp.sqrt(fluid.gamma * fluid.R * _clampT(T))


def dynamic_viscosity(fluid: Fluid, T):
    """mu(T) with the reference's 2/3 exponent (``src/cfd.jl:71-77``)."""
    T = _clampT(T)
    return (
        fluid.mu_ref
        * (T / fluid.T_ref) ** (2.0 / 3.0)
        * (fluid.T_ref + fluid.S)
        / (T + fluid.S)
    )


def heat_conductivity(fluid: Fluid, T):
    """Polynomial k(T) (reference ``src/cfd.jl:84-90``)."""
    k = jnp.zeros_like(T)
    for i in range(fluid.k.shape[0]):
        k = k + fluid.k[i] * T ** i
    return k


def primitive2state(fluid: Fluid, P):
    """[p T u v (w)] -> [rho E rho*u ...] (reference ``src/cfd.jl:106-123``).

    Components live on the LAST axis; any leading shape is accepted (flat
    [N, C] or block-structured [B, ..., C]).
    """
    p = P[..., 0]
    T = _clampT(P[..., 1])
    u = P[..., 2:]
    kin = (u ** 2).sum(axis=-1) / 2
    rho = p / (fluid.R * T)
    E = rho * (fluid.R / (fluid.gamma - 1.0) * T + kin)
    return jnp.concatenate(
        [rho[..., None], E[..., None], rho[..., None] * u], axis=-1
    )


def state2primitive(fluid: Fluid, Q):
    """[rho E rho*u ...] -> [p T u ...] (reference ``src/cfd.jl:137-151``)."""
    rho = Q[..., 0]
    E = Q[..., 1]
    u = Q[..., 2:] / rho[..., None]
    kin = (u ** 2).sum(axis=-1) / 2
    p = (fluid.gamma - 1.0) * (E - rho * kin)
    T = _clampT(p / (rho * fluid.R))
    return jnp.concatenate([p[..., None], T[..., None], u], axis=-1)


def state2primitive_guarded(fluid: Fluid, Q, p_floor=1.0, u_max=3000.0,
                            rho_floor=1e-6, p_ceil=1e9, T_ceil=2e4):
    """`physicality_guard(state2primitive(...))` as ONE concatenation pass
    (numerically identical where the state is physical; saves a full
    materialization of P per call).

    Also floors the density: deep expansions (sharp-trailing-edge suction
    on fine meshes) can drive rho <= 0 in a single update, and mom / rho
    then produces inf whose downstream `inf * 0` turns the whole field
    NaN. The generous p/T ceilings bound every downstream flux within
    f32 range: without them a local runaway (e.g. a rough grid-sequencing
    transfer) can pump p unboundedly until a flux overflows to inf, and
    `0 * inf` NaN then spreads through multiplicative masks."""
    rho = jnp.maximum(Q[..., 0], rho_floor)
    E = Q[..., 1]
    u = Q[..., 2:] / rho[..., None]
    kin = (u ** 2).sum(axis=-1) / 2
    p = (fluid.gamma - 1.0) * (E - rho * kin)
    # T from the unguarded p, exactly like state2primitive -> guard
    T = jnp.clip(p / (rho * fluid.R), 10.0, T_ceil)
    vmag = jnp.sqrt((u ** 2).sum(axis=-1, keepdims=True) + 1e-12)
    scale = jnp.minimum(1.0, u_max / vmag)
    return jnp.concatenate(
        [jnp.clip(p, p_floor, p_ceil)[..., None], T[..., None], u * scale],
        axis=-1,
    )


def physicality_guard(P, p_floor=1.0, u_max=3000.0, p_ceil=1e9, T_ceil=2e4):
    """Floor pressure and cap velocity magnitude (T is clamped by the
    transforms). Engages only on unphysical states; keeps isolated bad
    cells (thin trailing edges, under-resolved coarse multigrid levels)
    from chain-reacting. Ceilings bound fluxes within f32 (see
    `state2primitive_guarded`)."""
    u = P[..., 2:]
    # eps inside the sqrt keeps the JVP finite at u = 0 (frozen stagnant
    # interior cells) — sqrt'(0) is infinite otherwise
    vmag = jnp.sqrt((u ** 2).sum(axis=-1, keepdims=True) + 1e-12)
    scale = jnp.minimum(1.0, u_max / vmag)
    # built by concatenation, not channel-indexed .at[].set
    return jnp.concatenate(
        [jnp.clip(P[..., 0:1], p_floor, p_ceil),
         jnp.clip(P[..., 1:2], None, T_ceil), u * scale], axis=-1
    )


def pressure_coefficient(fluid: Fluid, p, p_inf: float, M_inf: float):
    """Cp = 2 (p/p_inf - 1) / (gamma M^2) (reference ``src/cfd.jl:420-426``)."""
    return 2.0 * (p / p_inf - 1.0) / (M_inf ** 2 * fluid.gamma)


def reynolds_number(fluid: Fluid, P_inf, L_ref: float):
    """Re from freestream primitives (reference ``src/cfd.jl:626-637``)."""
    P_inf = jnp.asarray(P_inf)
    V = jnp.sqrt((P_inf[2:] ** 2).sum())
    T = P_inf[1]
    p = P_inf[0]
    rho = p / (fluid.R * T)
    mu = dynamic_viscosity(fluid, T)
    return V * L_ref * rho / mu


def adjust_reynolds(fluid: Fluid, P_inf, L_ref: float, Re: float) -> Fluid:
    """Rescale mu_ref to hit a target Re (reference ``src/cfd.jl:645-654``)."""
    Re_old = reynolds_number(fluid, P_inf, L_ref)
    return Fluid(
        R=fluid.R, gamma=fluid.gamma, k=fluid.k,
        mu_ref=fluid.mu_ref * Re_old / Re,
        T_ref=fluid.T_ref, S=fluid.S,
    )


# --- ISA standard atmosphere (host-side scalar; reference src/cfd.jl:304-397)

_ISA_LAYERS = [
    (0.0, 288.15, -6.5, 101325.0),
    (11000.0, 216.65, 0.0, 22632.0),
    (20000.0, 216.65, 1.0, 5474.9),
    (32000.0, 228.65, 2.8, 868.02),
    (47000.0, 270.65, 0.0, 110.91),
    (51000.0, 270.65, -2.8, 66.939),
    (71000.0, 214.65, -2.0, 3.9564),
]


def _isa_atmosphere(altitude_m: float, dT: float = 0.0):
    R = 287.05287
    g0 = 9.80665
    if altitude_m < 0:
        raise ValueError("Altitude cannot be negative")
    layer = _ISA_LAYERS[0]
    for i in range(len(_ISA_LAYERS) - 1):
        if altitude_m >= _ISA_LAYERS[i][0]:
            layer = _ISA_LAYERS[i]
    h_base, T_base, lapse, P_base = layer
    lapse_m = lapse / 1000.0
    dh = altitude_m - h_base
    T = T_base + lapse_m * dh + dT
    if abs(lapse_m) < 1e-10:
        P = P_base * np.exp(-g0 * dh / (R * (T_base + dT)))
    else:
        expn = -g0 / (R * lapse_m)
        Tb = T_base + dT
        P = P_base * ((Tb + lapse_m * dh) / Tb) ** expn
    return float(P), float(T)


def isa_atmosphere(
    altitude_m: float,
    *,
    dT: float = 0.0,
    Mach: float = 0.0,
    V: float = None,
    direction=(1.0,),
):
    """(Fluid, P_inf) for a flight condition (reference ``src/cfd.jl:379-397``)."""
    p, T = _isa_atmosphere(altitude_m, dT)
    fluid = make_fluid()
    if V is None:
        a = float(np.sqrt(1.4 * 283.0 * max(T, 10.0)))
        V = Mach * a
    d = np.asarray(direction, dtype=np.float64)
    d = d / (np.linalg.norm(d) + np.finfo(np.float32).eps)
    P_inf = np.concatenate([[p, T], V * d]).astype(np.float32)
    return fluid, P_inf


def streamwise_direction(alpha: float, beta: float = None):
    """Flow direction from angles in degrees (reference
    ``src/cfd.jl:407-409,434-436``)."""
    a = np.deg2rad(alpha)
    if beta is None:
        return np.array([np.cos(a), np.sin(a)], dtype=np.float32)
    b = np.deg2rad(beta)
    return np.array(
        [np.cos(a) * np.cos(b), -np.cos(a) * np.sin(b), np.sin(a)],
        dtype=np.float32,
    )


class TimeAverage:
    """Exponential moving average + moving std monitor (host-side stateful;
    reference ``src/cfd.jl:747-802``)."""

    def __init__(self, tau: float):
        self.tau = tau
        self.mu = None
        self.sigma = None

    def push(self, Q, dt=1.0):
        Q = jnp.asarray(Q)
        if self.mu is None:
            self.mu = Q
            self.sigma = jnp.zeros_like(Q)
            return self.mu
        dt = jnp.asarray(dt)
        if dt.ndim == 1 and Q.ndim > 1:
            dt = dt.reshape((1,) * (Q.ndim - 1) + (-1,))
        eta = dt / self.tau
        self.sigma = jnp.sqrt(
            self.sigma ** 2 * (1.0 - eta) + (self.mu - Q) ** 2 * eta
        )
        self.mu = self.mu * (1.0 - eta) + Q * eta
        return self.mu
