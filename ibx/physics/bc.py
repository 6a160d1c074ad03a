"""Characteristic-style flow boundary condition (device side).

Counterpart of reference ``src/cfd.jl:160-300``: per-point Mach/direction
switching of pressure, temperature and velocity between the interior (image)
values and the freestream, plus a ``normal_flow`` mode for slip walls with
optional transpiration and a wall-model velocity correction ``du_dn``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..utils import pytree_dataclass
from .fluid import Fluid, speed_of_sound

_EPS32 = float(np.finfo(np.float32).eps)


@pytree_dataclass(meta_fields=("normal_flow",))
class FlowBC:
    """Flow BC parameters (reference ``src/cfd.jl:160-235``)."""

    fluid: Fluid
    p_inf: jnp.ndarray
    T_inf: jnp.ndarray
    u_inf: jnp.ndarray
    normal_flow: bool

    def __call__(self, P, normals, **kwargs):
        return apply_flow_bc(self, P, normals, **kwargs)


def flow_bc(fluid: Fluid, P_inf, *, normal_flow: bool = False) -> FlowBC:
    """Constructor from a primitive vector [p T u v (w)]
    (reference ``src/cfd.jl:229-235``)."""
    P_inf = jnp.asarray(P_inf, dtype=jnp.float32)
    return FlowBC(
        fluid=fluid,
        p_inf=P_inf[0],
        T_inf=P_inf[1],
        u_inf=P_inf[2:],
        normal_flow=normal_flow,
    )


def apply_flow_bc(
    bc: FlowBC,
    P,
    normals,
    *,
    image_distances=None,
    du_dn=None,
    transpiration=0.0,
):
    """Impose the BC on image-point primitives (reference ``src/cfd.jl:243-300``).

    P: [G, 2+nd] primitives at image points; normals: [G, nd] outward (into
    the fluid) unit normals. Returns boundary primitives [G, 2+nd].
    """
    if bc.normal_flow:
        un = jnp.broadcast_to(bc.u_inf[0], (P.shape[0],))
    else:
        un = jnp.matmul(normals, bc.u_inf,
                        precision=jax.lax.Precision.HIGHEST)

    p = P[:, 0]
    T = P[:, 1]
    u = P[:, 2:]
    current_un = (u * normals).sum(axis=1)

    a = speed_of_sound(bc.fluid, T)
    M = jnp.abs(un) / a

    sup = (M > 1.0).astype(P.dtype)
    sub = 1.0 - sup
    outgoing = (un >= 0.0).astype(P.dtype)
    pb = outgoing * (sup * bc.p_inf + sub * p) + (1.0 - outgoing) * (
        sup * p + sub * bc.p_inf
    )
    Tb = jnp.where(un > 0.0, bc.T_inf, T)

    if bc.normal_flow:
        ub = u + normals * (un - current_un + transpiration)[:, None]
    else:
        out_mask = (un >= 0.0)[:, None]
        ub = jnp.where(out_mask, bc.u_inf[None, :], u)

    if (du_dn is None) != (image_distances is None):
        raise ValueError(
            "du_dn and image_distances must be passed together"
        )
    if du_dn is not None:
        V = jnp.sqrt((ub ** 2).sum(axis=1)) + _EPS32
        ub = ub * ((V - du_dn * image_distances) / V)[:, None]

    return jnp.concatenate([pb[:, None], Tb[:, None], ub], axis=1)
