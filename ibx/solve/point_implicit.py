"""Matrix-free point-implicit solver (device side).

Counterpart of reference ``src/point_implicit.jl``: Hutchinson +/-1-probe
estimation of the block-diagonal Jacobian, a linearization with
Jacobian-vector products, a block-diagonal pseudo-inverse preconditioner, and
a two-direction minimal-residual descent with optional coarse-to-fine
multigrid cycling. Departures: JVPs are exact (``jax.jvp``) instead of
finite differences, and the solve loop is a ``lax.while_loop`` so the whole
implicit step jits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

_EPS = 1.19e-7


def _jvp(f, x, v):
    return jax.jvp(f, (x,), (v,))[1]


def hutchinson_block_diagonal(
    f: Callable, X, n_samples: int = 30, *, key=None
):
    """Estimate per-row diagonal Jacobian blocks.

    X: [N, m] -> D: [N, m, m] with D[n, j, i] ~ d f(X)[n, j] / d X[n, i]
    (reference ``src/point_implicit.jl:18-91``). Uses exact JVPs with
    Rademacher probes restricted to one variable column at a time.
    For vector input [N] returns the diagonal [N].
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    X = jnp.asarray(X)

    if X.ndim == 1:
        def body(i, carry):
            s, key = carry
            key, sub = jax.random.split(key)
            z = jax.random.rademacher(sub, X.shape, dtype=X.dtype)
            s = s + z * _jvp(f, X, z)
            return s, key
        s, _ = jax.lax.fori_loop(0, n_samples, body,
                                 (jnp.zeros_like(f(X)), key))
        return s / n_samples

    N, m = X.shape
    cols = []
    for i in range(m):
        def body(k, carry, i=i):
            s, key = carry
            key, sub = jax.random.split(key)
            z = jax.random.rademacher(sub, (N,), dtype=X.dtype)
            v = jnp.zeros_like(X).at[:, i].set(z)
            s = s + z[:, None] * _jvp(f, X, v)
            return s, key
        s, key = jax.lax.fori_loop(0, n_samples, body,
                                   (jnp.zeros((N, m), X.dtype), key))
        cols.append(s / n_samples)
    return jnp.stack(cols, axis=2)  # [N, m_out, m_in]


class Linearization(NamedTuple):
    """f linearized at x (reference ``src/point_implicit.jl:98-114``);
    JVPs are exact."""

    f: Callable
    x: jnp.ndarray
    fx: jnp.ndarray

    def __call__(self, v):
        return _jvp(self.f, self.x, v)


class PIPreconditioner(NamedTuple):
    """Block-diagonal pseudo-inverse preconditioner
    (reference ``src/point_implicit.jl:121-161``)."""

    inverse_diagonal: jnp.ndarray

    def __call__(self, v):
        D = self.inverse_diagonal
        if D.ndim == 1:
            return v * D
        # out[n, j] = sum_i v[n, i] * D[n, j, i]
        return jnp.einsum("ni,nji->nj", v, D,
                          precision=jax.lax.Precision.HIGHEST)


def linearize(
    f: Callable,
    x,
    *,
    n_hutchinson_samples: int = 30,
    pre_evaluated_fx=None,
    key=None,
):
    """(A, b, preconditioner) for the Newton system A dx = b = -f(x)
    (reference ``src/point_implicit.jl:184-207``)."""
    x = jnp.asarray(x)
    fx = f(x) if pre_evaluated_fx is None else jnp.asarray(pre_evaluated_fx)
    D = hutchinson_block_diagonal(f, x, n_hutchinson_samples, key=key)
    if D.ndim == 1:
        Dinv = 1.0 / (_EPS + D)
    else:
        Dinv = _block_inv(D)
    return Linearization(f, x, fx), -fx, PIPreconditioner(Dinv)


def _block_inv(D, rel_reg: float = 1e-5):
    """Regularized inverse of small [N, k, k] blocks by vectorized
    Gauss-Jordan elimination.

    ``jnp.linalg.pinv`` lowers to a batched SVD; the Newton blocks here are
    diagonally dominant (I/dt - diag(J)), so unpivoted elimination with a
    diagonal Tikhonov term is stable and compiles to pure vector ops.
    """
    k = D.shape[-1]
    scale = jnp.sqrt((D * D).sum(axis=(-2, -1)) / (k * k)) + _EPS
    lam = (rel_reg * scale)[:, None]
    eye = jnp.eye(k, dtype=D.dtype)
    A = D + lam[..., None] * eye
    M = jnp.concatenate([A, jnp.broadcast_to(eye, A.shape)], axis=-1)
    for i in range(k):
        piv = M[:, i, i:i + 1]
        row = M[:, i, :] / (piv + _EPS)
        M = M - M[:, :, i:i + 1] * row[:, None, :]
        M = M.at[:, i, :].set(row)
    return M[:, :, k:]


def _dot(a, b):
    return (a * b).sum()


def _proj_along(A: Linearization, v, b):
    """alpha = argmin |b - alpha A v|; returns (alpha, A v)
    (reference ``src/point_implicit.jl:220-233``)."""
    Av = A(v)
    return _dot(Av, b) / (_dot(Av, Av) + _EPS), Av


def solve(
    A: Linearization,
    b,
    prec: PIPreconditioner,
    *,
    n_iter: int = 100,
    n_inner: int = 1,
    rtol: float = 1e-2,
    atol: float = 1e-7,
    multigrid=None,
):
    """Two-direction minimal-residual descent with block-diagonal
    preconditioning and optional coarsest-to-finest multigrid cycling
    (reference ``src/point_implicit.jl:250-329``).

    Returns (x, |r| / |r0|). Fully traceable (jit-compatible).
    """
    b = jnp.asarray(b)
    nr0 = jnp.sqrt(_dot(b, b))

    n_levels = 0 if multigrid is None else len(multigrid.coarseners)

    def smooth(level, s):
        # level == 0 -> identity; level n -> coarsen_n |> prolong_n
        if multigrid is None:
            return s
        branches = [lambda s: s] + [
            (lambda s, c=c, p=p: p(c(s)))
            for c, p in zip(multigrid.coarseners, multigrid.prolongators)
        ]
        return jax.lax.switch(level, branches, s)

    # carry: (it, n_mgrid, x, r, nr)
    def cond(c):
        it, _, _, _, nr = c
        return (it < n_iter) & (nr >= nr0 * rtol + atol)

    def body(c):
        it, n_mgrid, x, r, _ = c

        def one_inner(_, xr):
            x, r = xr
            s = prec(r)
            s = smooth(n_mgrid, s)
            alpha, As = _proj_along(A, s, r)
            x = x + s * alpha
            r = r - As * alpha
            s2 = r / (_EPS + jnp.abs(r).max())
            alpha, As = _proj_along(A, s2, r)
            x = x + s2 * alpha
            r = r - As * alpha
            return x, r

        x, r = jax.lax.fori_loop(0, n_inner, one_inner, (x, r))
        nr = jnp.sqrt(_dot(r, r))
        n_mgrid = jnp.where(n_mgrid == 0, n_levels, n_mgrid - 1)
        return it + 1, n_mgrid, x, r, nr

    x0 = jnp.zeros_like(b)
    it, _, x, r, nr = jax.lax.while_loop(
        cond, body, (0, jnp.int32(n_levels), x0, b, jnp.float32(jnp.inf))
    )
    return x, nr / (nr0 + _EPS)
