"""Ghost-cell boundary conditions.

Functional equivalents of the reference's boundary slice kernels
(`BC!` src/util.jl:192-210, `exitBC!` :216-222, `perBC!` :227-231).

Plane updates use width-1 *slice* windows (`a.at[.., 0:1, ..].set(...)`)
— static dynamic-update-slices that XLA performs (mostly) in place and
that the SPMD partitioner handles correctly under uneven spatial sharding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["bc_vector", "bc_scalar_periodic", "exit_bc"]


def _pl(D: int, j: int, lo: int, lead: int = 0) -> tuple:
    """Width-1 slice selecting plane ``axis j == lo`` (0-based, >=0)."""
    return (slice(None),) * lead + tuple(
        slice(lo, lo + 1) if d == j else slice(None) for d in range(D))


def _per_fill(a: jax.Array, j: int, lead: int = 0) -> jax.Array:
    """Periodic ghost fill along spatial axis j."""
    D = a.ndim - lead
    S = a.shape[lead:]
    a = a.at[_pl(D, j, 0, lead)].set(a[_pl(D, j, S[j] - 2, lead)])
    return a.at[_pl(D, j, S[j] - 1, lead)].set(a[_pl(D, j, 1, lead)])


def bc_vector(u: jax.Array, A, save_exit: bool = False,
              perdir: tuple = ()) -> jax.Array:
    """Apply domain BCs to the ghost cells of a vector field ``u`` (D,*S).

    Mirrors reference ``BC!`` (src/util.jl:192-210):
    - periodic direction ``j``: ghost planes copy the opposite interior plane;
    - normal component (``i==j``): Dirichlet ``A[i]`` on the ghost *and*
      first interior plane at the low wall, and on the high ghost plane
      (skipped for ``i==0`` when ``save_exit`` to preserve the outlet);
    - tangential components: zero-Neumann copy of the adjacent plane.

    Sequential update order (component-major, direction-minor) matches the
    reference so ghost-corner values agree exactly.
    """
    D = u.shape[0]
    S = u.shape[1:]
    # in-place plane updates on the stacked array (no unstack/restack copy);
    # component-major, direction-minor order matches the reference exactly
    cpl = lambda i, j, lo: (slice(i, i + 1),) + _pl(D, j, lo)
    for i in range(D):
        for j in range(D):
            if j in perdir:
                u = u.at[cpl(i, j, 0)].set(u[cpl(i, j, S[j] - 2)])
                u = u.at[cpl(i, j, S[j] - 1)].set(u[cpl(i, j, 1)])
            elif i == j:
                Ai = jnp.asarray(A[i], u.dtype)
                u = u.at[cpl(i, j, 0)].set(Ai)
                u = u.at[cpl(i, j, 1)].set(Ai)
                if not (save_exit and i == 0):
                    u = u.at[cpl(i, j, S[j] - 1)].set(Ai)
            else:
                u = u.at[cpl(i, j, 0)].set(u[cpl(i, j, 1)])
                u = u.at[cpl(i, j, S[j] - 1)].set(u[cpl(i, j, S[j] - 2)])
    return u


def bc_scalar_periodic(a: jax.Array, perdir: tuple, D: int | None = None) -> jax.Array:
    """Periodic ghost fill for a scalar field (reference ``perBC!``)."""
    if not perdir:
        return a
    D = a.ndim if D is None else D
    lead = a.ndim - D
    for j in perdir:
        a = _per_fill(a, j, lead)
    return a


def exit_bc(u: jax.Array, u0: jax.Array, U, dt) -> jax.Array:
    """1D convective outlet on the high-x ghost plane + global flux fix.

    Mirrors reference ``exitBC!`` (src/util.jl:216-222): the exit plane
    (last x-ghost, interior in the transverse directions) is advected out of
    the domain with speed ``U[0]`` and then shifted uniformly so the mean
    outflow equals ``U[0]`` (global mass conservation).
    """
    D = u.shape[0]
    S = u.shape[1:]
    tr = tuple(slice(1, -1) for _ in range(D - 1))
    ex = (0, slice(S[0] - 1, S[0])) + tr
    exm = (0, slice(S[0] - 2, S[0] - 1)) + tr
    new = u0[ex] - U[0] * dt * (u0[ex] - u0[exm])
    flux = jnp.mean(new) - U[0]
    return u.at[ex].set(new - flux)
