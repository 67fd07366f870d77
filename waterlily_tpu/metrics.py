"""Derived flow fields and body forces/moments.

Re-design of src/Metrics.jl: every metric is a whole-array
stencil expression; body forces are fused multiply-reduce programs that
keep the reduction on device and return a tiny vector.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .grid import shift, interior, interior_view, loc_grid, interp
from .body import measure, kern

__all__ = ["ke", "grad_tensor", "strain_rate", "lambda2", "curl", "omega",
           "omega_mag", "omega_theta", "nds", "pressure_force",
           "viscous_force", "total_force", "pressure_moment"]

# f32 contractions must not drop to TF32 on GPUs
_HI = jax.lax.Precision.HIGHEST


def ke(u, U=None):
    """Cell-centered kinetic energy ``½‖u-U‖²`` (reference `ke`, Metrics.jl:19-21).

    Face pairs are averaged to the center: ``0.125*Σᵢ(uᵢ[I]+uᵢ[I+δᵢ]-2Uᵢ)²``.
    Returns a scalar field with zero ghosts.
    """
    D = u.shape[0]
    s = jnp.zeros(u.shape[1:], u.dtype)
    for i in range(D):
        Ui = 0.0 if U is None else U[i]
        s = s + (u[i] + shift(u[i], i, +1) - 2.0 * Ui) ** 2
    out = jnp.zeros_like(s)
    return out.at[interior(D)].set(0.125 * s[interior(D)])


def _dudx(i, j, u):
    """∂uᵢ/∂xⱼ at cell centers (reference `∂(i,j,I,u)`, Metrics.jl:28-30).

    Inline terms use the compact staggered difference; cross terms the wider
    4-point average."""
    if i == j:
        return shift(u[i], i, +1) - u[i]
    return (shift(u[i], j, +1) + shift(shift(u[i], j, +1), i, +1)
            - shift(u[i], j, -1) - shift(shift(u[i], j, -1), i, +1)) / 4.0


def grad_tensor(u):
    """Velocity gradient ∂uᵢ/∂xⱼ as a (D,D,*S) field."""
    D = u.shape[0]
    return jnp.stack([jnp.stack([_dudx(i, j, u) for j in range(D)]) for i in range(D)])


def strain_rate(u):
    """Rate-of-strain tensor ``∂ᵢuⱼ+∂ⱼuᵢ`` (reference `∇²u`, Metrics.jl:107-108)."""
    g = grad_tensor(u)
    return g + jnp.swapaxes(g, 0, 1)


def _sym3_eigvals_mid(A):
    """Middle eigenvalue of a symmetric 3×3 matrix field, closed form.

    Trigonometric method (no LAPACK on the grid — pure VPU math).
    ``A`` has shape (3,3,*S)."""
    q = (A[0, 0] + A[1, 1] + A[2, 2]) / 3.0
    B00, B11, B22 = A[0, 0] - q, A[1, 1] - q, A[2, 2] - q
    p2 = (B00 ** 2 + B11 ** 2 + B22 ** 2
          + 2.0 * (A[0, 1] ** 2 + A[0, 2] ** 2 + A[1, 2] ** 2))
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    psafe = jnp.where(p == 0, 1.0, p)
    # det(B)/2 / p^3
    detB = (B00 * (B11 * B22 - A[1, 2] ** 2)
            - A[0, 1] * (A[0, 1] * B22 - A[1, 2] * A[0, 2])
            + A[0, 2] * (A[0, 1] * A[1, 2] - B11 * A[0, 2]))
    rr = jnp.clip(detB / (2.0 * psafe ** 3), -1.0, 1.0)
    phi = jnp.arccos(rr) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return e2


def lambda2(u):
    """λ₂ vortex criterion (reference Metrics.jl:40-44): middle eigenvalue
    of S²+Ω² from the velocity-gradient tensor.  3D only."""
    g = grad_tensor(u)
    S = 0.5 * (g + jnp.swapaxes(g, 0, 1))
    O = 0.5 * (g - jnp.swapaxes(g, 0, 1))
    M = (jnp.einsum("ik...,kj...->ij...", S, S, precision=_HI)
         + jnp.einsum("ik...,kj...->ij...", O, O, precision=_HI))
    out = _sym3_eigvals_mid(M)
    z = jnp.zeros_like(out)
    return z.at[interior(u.shape[0])].set(out[interior(u.shape[0])])


def curl(i, u):
    """Edge vorticity component i (reference `curl`, Metrics.jl:54).

    ``ω_i = ∂ⱼu_k - ∂_k u_j`` evaluated at the cell edge: each term is the
    backward difference of the face velocity, ``∂(j, CI(I,k), u) =
    u_k[I]-u_k[I-δⱼ]``."""
    D = u.shape[0]
    if D == 2:
        if i != 2:
            raise ValueError("2D vorticity is the z-component (i=2)")
        j, k = 0, 1
        return (u[k] - shift(u[k], j, -1)) - (u[j] - shift(u[j], k, -1))
    j, k = (i + 1) % 3, (i + 2) % 3
    return (u[k] - shift(u[k], j, -1)) - (u[j] - shift(u[j], k, -1))


def omega(u):
    """Center vorticity vector (reference `ω`, Metrics.jl:60): ``ω_i =
    ∂ⱼu_k - ∂_k u_j`` with the center-gradient stencil."""
    assert u.shape[0] == 3
    comps = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        comps.append(_dudx(k, j, u) - _dudx(j, k, u))
    return jnp.stack(comps)


def omega_mag(u):
    """‖ω‖ at cell centers (reference Metrics.jl:66)."""
    w = omega(u)
    return jnp.sqrt(jnp.sum(w * w, axis=0))


def omega_theta(u, z_axis, center):
    """Azimuthal vorticity ω·θ̂ around axis ``z`` through ``center``
    (reference Metrics.jl:73-77)."""
    D = u.shape[0]
    assert D == 3
    S = u.shape[1:]
    x = jnp.moveaxis(loc_grid(S, None, u.dtype), -1, 0)  # (3,*S)
    z = jnp.asarray(z_axis, u.dtype).reshape(3, *([1] * len(S)))
    c = jnp.asarray(center, u.dtype).reshape(3, *([1] * len(S)))
    rel = x - c
    theta = jnp.cross(z, rel, axisa=0, axisb=0, axisc=0)
    n = jnp.sqrt(jnp.sum(theta * theta, axis=0))
    w = omega(u)
    dot = jnp.sum(theta * w, axis=0)
    return jnp.where(n <= jnp.finfo(u.dtype).eps, 0.0, dot / jnp.where(n == 0, 1.0, n))


def _band_measure(body, S, t, dtype):
    """Per-cell band geometry: kernel weight ``w``, outward normal ``n`` and
    the surface projection ``xs = x - d·n̂`` of every cell center.

    ``measure`` early-outs to ``(d, 0, 0)`` outside ``fastd²=1`` — there the
    kernel weight is exactly zero (``kern(±1)=0``) so the degenerate
    projection (``xs=x``) never contributes.  Flat ``(Ncells, ·)`` layout.
    """
    D = len(S)
    pts = loc_grid(S, None, dtype).reshape(-1, D)
    t_ = jnp.asarray(t, dtype)
    d, n, _ = jax.vmap(lambda x: measure(body, x, t_, 1.0))(pts)
    w = kern(jnp.clip(d, -1, 1))
    xs = pts - d[:, None] * n
    return w, n, xs


def nds(body, S, t, dtype):
    """BDIM-masked surface normal field ``n̂·kern(clamp(d,-1,1))`` at cell
    centers (reference `nds`, Metrics.jl:84-87).  Shape (D,*S)."""
    D = len(S)
    w, n, _ = _band_measure(body, S, t, dtype)
    return jnp.moveaxis((n * w[:, None]).reshape(S + (D,)), -1, 0).astype(dtype)


def _band_sample(scalar, sampling, n, xs):
    """Sample a cell-centered scalar field over band points per ``sampling``.

    ``"surface"`` interpolates at the surface projection ``xs``; ``"extrap"``
    linearly extrapolates to the surface from probes one and two cells
    OUTSIDE it along the normal (``f_s = 2·f(xs+n̂) − f(xs+2n̂)``), so the
    sample never reads values from inside the BDIM-smeared band."""
    samp = lambda q: jax.vmap(lambda x: interp(x, scalar))(q)
    if sampling == "surface":
        return samp(xs)
    if sampling == "extrap":
        return 2.0 * samp(xs + n) - samp(xs + 2.0 * n)
    raise ValueError(f"unknown sampling {sampling!r}")


def pressure_force(p, body, t=0.0, sampling="center"):
    """Σ p·n̂ ds over the body surface (reference Metrics.jl:94-100).

    ``sampling`` selects where the integrand is evaluated (the kern-weighted
    band quadrature itself is unchanged):

    - ``"center"`` (default) — band-cell centers, the reference's exact
      semantics.
    - ``"surface"`` — multilinear ``interp`` at the surface projection
      ``x − d·n̂``.
    - ``"extrap"`` — linear extrapolation to the surface from probes at
      ``+1h``/``+2h`` outside it, avoiding values contaminated by BDIM's
      O(h) boundary smearing.  Measured on the laminar sphere at Re=100
      (scripts/cd_estimators.py): cuts the Cd deficit vs literature from
      −20% to −10% at radius 6 and from −17% to −2% at radius 12, almost
      entirely by recovering the under-resolved surface strain rate.
      Assumes the body is ≳2 cells from the domain boundary (probes are
      clamped at grid edges).
    """
    S = p.shape
    D = len(S)
    if sampling == "center":
        nd = nds(body, S, t, p.dtype)
        return jnp.stack([jnp.sum(interior_view(p * nd[i], D)) for i in range(D)])
    w, n, xs = _band_measure(body, S, t, p.dtype)
    ps = _band_sample(p, sampling, n, xs)
    pw = (ps * w).reshape(S)
    nd = jnp.moveaxis(n.reshape(S + (D,)), -1, 0)
    return jnp.stack([jnp.sum(interior_view(pw * nd[i], D)) for i in range(D)])


def viscous_force(u, nu, body, t=0.0, sampling="center"):
    """Σ -ν(∇u+∇uᵀ)·n̂ ds over the surface (reference Metrics.jl:114-120).

    ``sampling`` as in `pressure_force`: the rate-of-strain tensor is
    evaluated at band-cell centers (reference semantics), at the surface
    projection, or extrapolated to the surface from outside the smeared
    band — the dominant coarse-grid force error lives in this term."""
    D = u.shape[0]
    S = u.shape[1:]
    sr = strain_rate(u)
    if sampling == "center":
        nd = nds(body, S, t, u.dtype)
        out = []
        for i in range(D):
            tot = jnp.zeros(S, u.dtype)
            for j in range(D):
                tot = tot + sr[i, j] * nd[j]
            out.append(-nu * jnp.sum(interior_view(tot, D)))
        return jnp.stack(out)
    w, n, xs = _band_measure(body, S, t, u.dtype)
    # Sample each strain component at the probe points (sr lives at cell
    # centers, so plain scalar interp applies componentwise).
    srs = jnp.stack([jnp.stack([_band_sample(sr[i, j], sampling, n, xs)
                                for j in range(D)]) for i in range(D)])  # (D,D,Ncells)
    tot = jnp.einsum("ijc,cj->ci", srs, n, precision=_HI) * w[:, None]  # (Ncells,D)
    totg = jnp.moveaxis(tot.reshape(S + (D,)), -1, 0)
    return jnp.stack([jnp.sum(interior_view(-nu * totg[i], D)) for i in range(D)])


def total_force(u, p, nu, body, t=0.0, sampling="center"):
    """Pressure + viscous force (reference Metrics.jl:127)."""
    return (pressure_force(p, body, t, sampling=sampling)
            + viscous_force(u, nu, body, t, sampling=sampling))


def pressure_moment(x0, p, body, t=0.0):
    """Pressure moment about ``x0`` (reference Metrics.jl:135-141).

    Returns a scalar in 2D (z-moment) and a 3-vector in 3D."""
    S = p.shape
    D = len(S)
    nd = nds(body, S, t, p.dtype)
    x = jnp.moveaxis(loc_grid(S, None, p.dtype), -1, 0)
    rel = x - jnp.asarray(x0, p.dtype).reshape(D, *([1] * D))
    if D == 2:
        cr = rel[0] * nd[1] - rel[1] * nd[0]
        return jnp.sum(interior_view(p * cr, D))
    cr = jnp.cross(rel, nd, axisa=0, axisb=0, axisc=0)
    return jnp.stack([jnp.sum(interior_view(p * cr[i], D)) for i in range(D)])
