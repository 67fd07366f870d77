"""Multi-chip fast path: the PCG smoother under `shard_map`.

The GSPMD path (`parallel.mesh`) is correct everywhere but leaves the
partitioner to place the stencil's communication.  `shard_map` makes it
explicit: each device runs the local slice-form stencil on its block, with

- halo exchange via `jax.lax.ppermute` ring shifts (`parallel.halo`) — one
  plane of ``eps`` per sharded axis per iteration;
- the PCG dot products as per-shard partial sums + `jax.lax.psum`.

The smoother dominates pressure-solve traffic, so routing it through this
path gives a sharded step whose hot loop is purely local; the remaining
V-cycle plumbing (restrict, prolongate, jacobi, residual) stays on GSPMD
where XLA's partitioner is already collective-permute-clean (HLO-asserted
in tests/test_sharding.py).

Math is the same masked-early-exit PCG as `ops.poisson.pcg` (reference
src/Poisson.jl:123-143); only the dot-product reduction order differs
(per-shard partials then psum), which perturbs results at the ulp level.

Reference scope: the reference has no distributed support (README.md:157);
SURVEY.md §5.8 and §7 stage 8 specify this design.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from .halo import (halo_exchange, _axis_shards, spatial_specs, shift_up,
                   ghost_mask_local, per_fill_local)

__all__ = ["shardmap_pcg", "can_shardmap", "local_mult", "prep_local_op",
           "shardmap_increment", "shardmap_residual", "pcg_local",
           "increment_local", "residual_local", "conv_diff_local"]


def _spatial_names(mesh: Mesh):
    return tuple(n for n in mesh.axis_names if n != "r")


def can_shardmap(mesh: Mesh | None, S: tuple, perdir: tuple) -> bool:
    """Gate for the shard_map fast paths: a mesh whose shard counts divide
    the level shape evenly (shard_map requires exact divisibility, unlike
    GSPMD's padded sharding).  Periodic directions are supported via
    `per_fill_local` ghost fills + modular wrap halos (`halo_exchange`
    perdir=); a sharded periodic axis additionally needs local blocks of
    at least 4 planes so the width-2 wrap window [2, 4) / [B-4, B-2)
    stays clear of the ghost band."""
    if mesh is None:
        return False
    names = _spatial_names(mesh)
    if not names:
        return False
    for k in range(min(len(names), len(S))):
        n_sh = mesh.shape[names[k]]
        if S[k] % n_sh != 0:
            return False
        if k in perdir and n_sh > 1 and S[k] // n_sh < 4:
            return False
    return True


def prep_local_op(mesh: Mesh, L_l, D: int):
    """The pre-shifted upper-face coefficients (`halo.shift_up`) of a local
    operator, built ONCE per shard_map region: L is constant across
    smoother iterations, so every matvec of a region shares them."""
    ax = _axis_shards(mesh, D)
    return [shift_up(L_l[i], i, mesh, ax) for i in range(D)]


def local_mult(mesh: Mesh, S, L_l, Dd_l, op, x_l, mask, perdir: tuple = ()):
    """A·x on a shard's local block after one halo-exchange round.

    ``op`` is `prep_local_op`'s output for this level (shared by every
    matvec in the region).  Periodic directions fill the global ghost
    planes first (the dense ``mult``'s `bc_scalar_periodic`,
    src/Poisson.jl:62-75 + perBC) — after the fill every boundary-adjacent
    stencil tap is an in-block read, so the zero edge halos stay unread
    exactly as in the wall case.
    """
    D = x_l.ndim
    if perdir:
        x_l = per_fill_local(x_l, mesh, S, perdir)
    xh = halo_exchange(x_l, mesh, D)
    z = x_l * Dd_l
    loc_shape = x_l.shape

    def sl(a, d, off):
        return a[tuple(
            slice(1 + (off if k == d else 0), 1 + (off if k == d else 0)
                  + loc_shape[k]) for k in range(D))]

    for i in range(D):
        z = z + sl(xh, i, -1) * L_l[i] + sl(xh, i, +1) * op[i]
    return jnp.where(mask, z, 0.0)


def pcg_local(mesh: Mesh, S, L_l, Dd_l, iD_l, x_l, r_l, it: int,
              op=None, perdir: tuple = ()):
    """PCG smoother body on a shard's local block (must run inside a
    shard_map region).  Same algebra as `ops.poisson.pcg` with the
    dead-mask early exits; dots are per-shard partials + psum."""
    D = x_l.ndim
    dt = x_l.dtype
    teneps = 10 * jnp.finfo(dt).eps
    names = _spatial_names(mesh)
    mask = ghost_mask_local(mesh, S, x_l.shape)
    if op is None:
        op = prep_local_op(mesh, L_l, D)

    def matvec(eps_l):
        # eps is per-filled at the loop top (dense pcg's bc_scalar_periodic
        # position) — no refill inside the matvec
        return local_mult(mesh, S, L_l, Dd_l, op, eps_l, mask)

    def gdot(a, b):
        return jax.lax.psum(jnp.sum(a * b), names)

    def mask_int(a):
        return jnp.where(mask, a, 0).astype(a.dtype)

    z = r_l * iD_l
    eps = z
    rho = gdot(r_l, z)
    dead = jnp.abs(rho) < teneps
    for i in range(it):
        if perdir:
            # fill BEFORE the axpy too: dense pcg's x += alpha*eps uses the
            # filled eps, so x's periodic ghosts carry the same (benign)
            # pollution — full-array parity with `ops.poisson.pcg`
            eps = per_fill_local(eps, mesh, S, perdir)
        z = matvec(eps)
        denom = gdot(z, eps)
        alpha = jnp.where(dead | (denom == 0), 0.0,
                          rho / jnp.where(denom == 0, 1.0, denom)).astype(dt)
        dead = dead | (jnp.abs(alpha) < 1e-2) | (jnp.abs(alpha) > 1e2)
        upd = jnp.where(dead, 0.0, alpha).astype(dt)
        x_new = x_l + upd * eps
        r_new = r_l - upd * z
        x_l, r_l = x_new, r_new
        if i == it - 1:
            break
        z2 = r_l * iD_l
        rho2 = gdot(r_l, z2)
        dead = dead | (jnp.abs(rho2) < teneps)
        beta = jnp.where(dead, 0.0,
                         rho2 / jnp.where(rho == 0, 1.0, rho)).astype(dt)
        eps = mask_int(beta * eps + z2)
        rho = jnp.where(dead, rho, rho2)
    return x_l, r_l


def shardmap_pcg(lev, x, r, it: int = 6):
    """Jacobi-preconditioned CG smoother with explicit collectives.

    Same algebra as `ops.poisson.pcg` with the dead-mask early exits.
    """
    mesh = lev.mesh
    D = x.ndim
    S = x.shape
    sc, vec = spatial_specs(mesh, D)

    def local(L_l, Dd_l, iD_l, x_l, r_l):
        return pcg_local(mesh, S, L_l, Dd_l, iD_l, x_l, r_l, it,
                         perdir=lev.perdir)

    fn = jax.shard_map(local, mesh=mesh,
                         in_specs=(vec, sc, sc, sc, sc),
                         out_specs=(sc, sc), check_vma=False)
    return fn(lev.L, lev.D, lev.iD, x, r)


def shardmap_increment(lev, x, r, eps):
    """Fused ``x += eps; r -= A·eps`` with explicit ppermute halos.

    The V-cycle's remaining fine-level stencils (the Jacobi pre-smooth and
    the prolongate-increment, reference src/Poisson.jl:99-113) run the same
    per-shard halo protocol as `shardmap_pcg`.  ``eps`` must be ghost-zero
    (the matvec fills periodic ghosts itself, like the dense `increment`)."""
    mesh = lev.mesh
    D = x.ndim
    S = x.shape
    sc, vec = spatial_specs(mesh, D)

    def local(L_l, Dd_l, x_l, r_l, eps_l):
        return increment_local(mesh, S, L_l, Dd_l, x_l, r_l, eps_l,
                               perdir=lev.perdir)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(vec, sc, sc, sc, sc),
                         out_specs=(sc, sc), check_vma=False)
    return fn(lev.L, lev.D, x, r, eps)


def increment_local(mesh: Mesh, S, L_l, Dd_l, x_l, r_l, eps_l, op=None,
                    perdir: tuple = ()):
    """``x += eps; r -= A·eps`` on a local block (inside shard_map)."""
    D = x_l.ndim
    mask = ghost_mask_local(mesh, S, x_l.shape)
    if op is None:
        op = prep_local_op(mesh, L_l, D)
    ae = local_mult(mesh, S, L_l, Dd_l, op, eps_l, mask, perdir)
    return x_l + eps_l, r_l - ae


def shardmap_residual(lev, x, z):
    """``r = z - A·x`` body-masked and mean-corrected (reference
    ``residual!``, src/Poisson.jl:91-97) with explicit collectives: one
    ppermute halo round, the per-shard stencil, and the solvability mean
    as per-shard partial sums + psum."""
    mesh = lev.mesh
    D = x.ndim
    S = x.shape
    sc, vec = spatial_specs(mesh, D)

    def local(L_l, Dd_l, iD_l, x_l, z_l):
        return residual_local(mesh, S, L_l, Dd_l, iD_l, x_l, z_l,
                              perdir=lev.perdir)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(vec, sc, sc, sc, sc),
                         out_specs=sc, check_vma=False)
    return fn(lev.L, lev.D, lev.iD, x, z)


def residual_local(mesh: Mesh, S, L_l, Dd_l, iD_l, x_l, z_l, op=None,
                   perdir: tuple = ()):
    """Body-masked, mean-corrected ``r = z - A·x`` on a local block."""
    from ..grid import inside_count
    D = x_l.ndim
    dt = x_l.dtype
    names = _spatial_names(mesh)
    cnt = inside_count(S)
    teps = 2 * jnp.finfo(dt).eps
    mask = ghost_mask_local(mesh, S, x_l.shape)
    if op is None:
        op = prep_local_op(mesh, L_l, D)
    ax_l = local_mult(mesh, S, L_l, Dd_l, op, x_l, mask, perdir)
    r_int = jnp.where(mask & (iD_l != 0), z_l - ax_l, 0.0).astype(dt)
    s = jax.lax.psum(jnp.sum(r_int), names) / cnt
    corr = jnp.where(jnp.abs(s) <= teps, 0.0, s).astype(dt)
    return jnp.where(mask, r_int - corr, 0.0).astype(dt)


def shardmap_conv_diff(mesh: Mesh, u, nu, limiter, perdir: tuple = ()):
    """conv_diff with explicit collectives: width-2 ppermute halos (QUICK
    reads ``I-2δ``, reference src/Flow.jl:6) and per-shard flux evaluation
    (the gather-form core) with global-index boundary masks.

    Periodic directions ride MODULAR wrap halos (`halo_exchange`
    perdir=): the halo planes hold the ghost-band-skipping wrap values, so
    the per-shard flux is the uniform periodic formula — bitwise the
    reference's ϕuP wrap + top-face flux copy (src/Flow.jl:7,60; see the
    halo_exchange docstring for the equivalence).
    """
    D = u.shape[0]
    S = u.shape[1:]
    sc, vec = spatial_specs(mesh, D)

    def local(u_l):
        return conv_diff_local(mesh, S, u_l, nu, limiter, perdir)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(vec,), out_specs=vec,
                       check_vma=False)
    return fn(u)


def conv_diff_local(mesh: Mesh, S, u_l, nu, limiter, perdir: tuple = ()):
    """conv_diff tendency on a shard's local block (inside shard_map):
    width-2 ppermute halos (modular wrap on periodic axes) + the gather-form
    core with global-index boundary masks (``base`` offsets).
    ``u_l``'s ghost planes must be periodic-filled on entry (the step's BC
    maintains this — the same contract as the dense path)."""
    from ..ops.convect import conv_core
    D = u_l.shape[0]
    loc = u_l.shape[1:]
    ax = _axis_shards(mesh, D)
    uh = halo_exchange(u_l, mesh, D, width=2, perdir=perdir)
    base = tuple(
        (jax.lax.axis_index(name) * (S[d] // k) if k > 1 else 0)
        for d, (name, k) in enumerate(ax))
    return conv_core(uh, loc, S, base, nu, perdir, limiter, modular=True)
