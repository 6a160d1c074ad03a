"""Padded-stencil gather-reduce: the framework's core device kernel.

The reference implementation (ImmersedBoundary.jl, ``src/accumulator.jl:12-190``)
accumulates values over *variable-length* stencils by grouping stencils of equal
length into dense matrices and looping over the groups. That layout implies
ragged shapes and per-group dispatch — hostile to XLA.

Here every stencil table is compiled (on the host) into a single fixed-width
``(idx, w)`` pair, padded with zero weights. On device, applying a stencil is

    out[m, ...] = sum_k w[m, k] * f(v[idx[m, k], ...])

one gather + one weighted reduction over a tiny static axis — which XLA fuses
into a single pass over HBM. Used for: face accumulators (Green-Gauss),
kNN interpolators (boundary image points, surface sampling), multigrid
coarseners/prolongators.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..utils import pytree_dataclass


@pytree_dataclass(meta_fields=("n_output", "width"))
class Stencil:
    """Fixed-width weighted gather-reduce table.

    Mirrors the semantics of ``Accumulator`` (reference
    ``src/accumulator.jl:39-65``) with a fixed-width padded layout.

    Attributes:
      idx: int32[M, K] gather indices into the input's leading axis. Padded
        entries repeat a valid index (or 0) and carry zero weight.
      w:   float32[M, K] weights; zero on padding.
      n_output: M (static).
      width: K (static).
    """

    idx: jnp.ndarray
    w: jnp.ndarray
    n_output: int
    width: int

    def __call__(self, v, *, delta: bool = False, f: Optional[Callable] = None,
                 op: str = "sum"):
        return apply_stencil(self, v, delta=delta, f=f, op=op)


def stencil_from_lists(indices, weights=None, n_output=None,
                       min_width: int = 1) -> Stencil:
    """Host-side compiler: list-of-lists stencils -> padded Stencil.

    ``indices[m]`` is the (possibly empty) stencil of output row ``m``;
    ``weights[m]`` the matching weights (defaults to all-ones, matching the
    weightless Accumulator of the reference, ``src/accumulator.jl:84-93``).
    Zero-based indices.

    NOTE: leaves stay host (numpy) arrays. Device placement happens once per
    containing structure (``jax.device_put`` of the whole pytree) — creating
    and freeing odd-sized device buffers during the topology compile
    fragments the device allocator and degrades every subsequent kernel
    launch.
    """
    M = len(indices) if n_output is None else n_output
    K = max([min_width] + [len(s) for s in indices])
    idx = np.zeros((M, K), dtype=np.int32)
    w = np.zeros((M, K), dtype=np.float32)
    for m, s in enumerate(indices):
        L = len(s)
        if L == 0:
            continue
        idx[m, :L] = s
        if weights is None:
            w[m, :L] = 1.0
        else:
            w[m, :L] = weights[m]
        # pad with a repeat of the first valid index (harmless gather target)
        idx[m, L:] = s[0]
    return Stencil(idx=idx, w=w, n_output=M, width=K)


def stencil_from_padded(idx: np.ndarray, w: np.ndarray) -> Stencil:
    """Wrap already-padded host tables (int[M,K], float[M,K]); host leaves."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)
    return Stencil(idx=idx, w=w, n_output=idx.shape[0], width=idx.shape[1])


def _expand(w, ndim_extra):
    return w.reshape(w.shape + (1,) * ndim_extra)


def apply_stencil(st: Stencil, v, *, delta: bool = False,
                  f: Optional[Callable] = None, op: str = "sum"):
    """Apply the stencil to ``v`` along its leading axis.

    v: [N, ...] -> out: [M, ...]. ``delta`` subtracts the co-indexed output
    row (reference ``src/accumulator.jl:100``); ``f`` maps gathered values
    before reduction; ``op`` in {"sum", "max", "min"}.
    """
    v = jnp.asarray(v)
    flat = jnp.take(v, st.idx.reshape(-1), axis=0)
    g = flat.reshape(st.idx.shape + v.shape[1:])
    if delta:
        anchor = jax.lax.slice_in_dim(v, 0, st.n_output, axis=0)
        g = g - anchor[:, None]
    if f is not None:
        g = f(g)
    w = _expand(st.w, v.ndim - 1)
    if op == "sum":
        return (g * w).sum(axis=1)
    valid = _expand(jnp.abs(st.w) > 0, v.ndim - 1)
    gw = g * w
    if op == "max":
        return jnp.where(valid, gw, -jnp.inf).max(axis=1)
    if op == "min":
        return jnp.where(valid, gw, jnp.inf).min(axis=1)
    raise ValueError(f"unsupported op: {op}")


def reindex_stencil(st: Stencil, mapping: np.ndarray) -> Stencil:
    """Remap gather indices through ``mapping`` (host-side).

    Counterpart of the reference's ``re_index!`` (``src/nninterp.jl:175-183``)
    used to localize global stencils to a partition's domain numbering.
    """
    idx = np.asarray(st.idx)
    return Stencil(idx=np.asarray(mapping)[idx].astype(np.int32),
                   w=st.w, n_output=st.n_output, width=st.width)


def stencil_domain(*sts: Stencil):
    """Union of gather indices used by one or more stencils.

    Counterpart of ``NNInterpolator.domain`` (``src/nninterp.jl:147-168``):
    returns the sorted unique index vector and a dense inverse map
    (old index -> position in the domain vector).
    """
    allidx = np.concatenate([np.asarray(s.idx).reshape(-1) for s in sts])
    dom = np.unique(allidx)
    inv = np.full(int(dom.max()) + 1 if dom.size else 1, -1, dtype=np.int64)
    inv[dom] = np.arange(dom.size)
    return dom, inv
