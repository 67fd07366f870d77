"""Whole multigrid pressure solve as ONE shard_map region.

Routing each smoother/stencil call through its own `shard_map` region
makes a 256³ V-cycle cross ~20 region boundaries per outer iteration.
This module removes the region count from the equation: the ENTIRE
`ml_solve` (residual, V-cycles, smoothers, transfers,
the adaptive while_loop) runs inside a single `shard_map` region.

Layout inside the region (multigrid decomposition):
- **Fine level sharded.**  Each device holds its local block of level 0
  (~87% of all multigrid cells in 3D) and runs the slice-form stencils on
  it, with `ppermute` halo planes and `psum` dot products.
- **Coarse levels replicated.**  Every coarser level is computed
  identically on all devices with the PLAIN dense operators — zero
  communication.
  Coarse work is ≤1/8 of the fine level per 3D coarsening, so replication
  costs a bounded fraction of ideal scaling while eliminating ~18 regions
  and every coarse-level collective per V-cycle.
- **Transfers are exact.**  Restriction computes each coarse cell's
  child-sum on the ONE shard owning the lower child (upper child via the
  width-1 halo), scattered into a zero coarse array and `psum`-reduced:
  each coarse value is one shard's dense-order pair sum plus zeros, so the
  replicated coarse residual is BITWISE equal to the dense restriction.
  Prolongation reads the replicated coarse correction directly (a dynamic
  slice + repeat per axis) — an exact copy, no communication at all.

Reference scope: the reference is single-device (README.md:157); this is
the scaling design of SURVEY.md §5.8 / §7 stage 8 for its
`solver!` (src/MultiLevelPoisson.jl:87-99).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .halo import halo_exchange, _axis_shards, spatial_specs, \
    ghost_mask_local, per_fill_local
from .shard_smooth import (can_shardmap, prep_local_op, pcg_local,
                           increment_local, residual_local, _spatial_names)

__all__ = ["shardmap_ml_solve", "can_shard_solve", "replicate_level",
           "ml_solve_local", "restrict_replicated", "prolongate_local"]


def can_shard_solve(levels, trace: bool = False) -> bool:
    """Gate: fine level carries an evenly-dividing mesh (periodic dirs ride
    `per_fill_local` ghost fills — see `can_shardmap`), and no residual-
    trace capture (the trace rows stay on the per-phase path)."""
    fine = levels[0]
    return (fine.mesh is not None and not trace
            and can_shardmap(fine.mesh, fine.D.shape, fine.perdir))


def replicate_level(lev):
    """A coarse level as the in-region replicated copy: plain dense
    operators, no banded window (matching `constrain_levels`' sharded-level
    numerics so the sharded solve's iteration counts track the GSPMD
    path)."""
    return lev.replace(mesh=None, sharded=False, banded=False,
                       box_shape=None, box_start=None)


def _restrict_axis_local(v, d, b, Bf, M):
    """Pair-sum one axis of a halo'd local block down one level.

    ``v`` is halo-extended along axis ``d`` (rows [b-1, b+Bf]); coarse
    interior cell ``c`` sums fine rows ``2c-1, 2c`` (reference
    ``restrict``, src/MultiLevelPoisson.jl:3-9).  This shard owns exactly
    the coarse cells whose LOWER child lies in its block — the upper child
    is local or the first halo plane.  Returns (owned block of size
    ``nmax`` along d, first owned coarse row c0, owned count npair);
    entries past ``npair`` or past the coarse interior M are zeroed.
    ``b`` (this block's first global row) is traced; shapes are static.
    """
    nmax = Bf // 2 + 1
    if Bf % 2:
        # odd blocks: the slice window [o0, o0+2*nmax) can overrun the
        # halo'd extent by one row — append a zero plane (never selected)
        pad = [(0, 0)] * v.ndim
        pad[d] = (0, 1)
        v = jnp.pad(v, pad)
        o0 = 2 - (b % 2)              # local index of the first odd row
        npair = Bf // 2 + (b % 2) * (Bf % 2)
    else:
        # even blocks start on even rows: statically o0=2, all pairs owned
        o0 = jnp.int32(2)
        npair = Bf // 2
    c0 = b // 2 + 1
    starts = [jnp.int32(0)] * v.ndim
    starts[d] = jnp.int32(o0)
    sizes = list(v.shape)
    sizes[d] = 2 * nmax
    w = jax.lax.dynamic_slice(v, starts, sizes)
    sh = w.shape[:d] + (nmax, 2) + w.shape[d + 1:]
    s = w.reshape(sh).sum(axis=d + 1)
    # zero not-owned tail pairs and ghost-row coarse cells (c > M)
    i = jax.lax.broadcasted_iota(jnp.int32, s.shape, d)
    valid = (i < npair) & (c0 + i <= M)
    return jnp.where(valid, s, 0.0).astype(v.dtype), c0


def restrict_replicated(mesh: Mesh, S, r_l):
    """Dense-order restriction of a sharded fine residual to a REPLICATED
    coarse grid: per-shard owned-pair sums (bitwise the dense reshape-sum —
    each coarse cell is produced by exactly one shard) scattered into a
    zero coarse array and `psum`-summed (adding zeros: exact)."""
    D = r_l.ndim
    names = _spatial_names(mesh)
    ax = _axis_shards(mesh, D)
    Sc = tuple(1 + s // 2 for s in S)
    v = halo_exchange(r_l, mesh, D)
    c0s = []
    for d in range(D):
        name, k = ax[d]
        Bf = S[d] // k
        b = (jax.lax.axis_index(name) * Bf if k > 1 else jnp.int32(0))
        v, c0 = _restrict_axis_local(v, d, b, Bf, (Sc[d] - 2))
        c0s.append(jnp.int32(c0))
    out = jnp.zeros(Sc, r_l.dtype)
    out = jax.lax.dynamic_update_slice(out, v, tuple(c0s))
    return jax.lax.psum(out, names)


def prolongate_local(mesh: Mesh, S, xc):
    """Local block of the piecewise-constant injection of a REPLICATED
    coarse correction (reference :34): per axis, slice the owned coarse
    window, repeat ×2, and re-align by the block's parity.  Exact copy —
    no communication; global ghosts zeroed by the caller's mask."""
    D = xc.ndim
    ax = _axis_shards(mesh, D)
    v = xc
    for d in range(D):
        name, k = ax[d]
        Bf = S[d] // k
        b = (jax.lax.axis_index(name) * Bf if k > 1 else jnp.int32(0))
        c0 = (b + 1) // 2
        ncr = Bf // 2 + 1
        starts = [jnp.int32(0)] * v.ndim
        starts[d] = jnp.int32(c0)
        sizes = list(v.shape)
        sizes[d] = ncr
        w = jax.lax.dynamic_slice(v, starts, sizes)
        w = jnp.repeat(w, 2, axis=d)
        starts[d] = jnp.int32(b + 1 - 2 * c0)      # 0 or 1
        sizes[d] = Bf
        v = jax.lax.dynamic_slice(w, starts, sizes)
    mask = ghost_mask_local(mesh, S, v.shape)
    return jnp.where(mask, v, 0.0).astype(xc.dtype)


def ml_solve_local(mesh: Mesh, S, fL, fD, fiD, coarse_l, x_l, z_l,
                   tol=1e-4, itmx=32, fixed=None, it_smooth=6, op=None,
                   perdir: tuple = ()):
    """`ml_solve` body on a shard's local fine block (must run inside a
    shard_map region).  ``coarse_l`` are the REPLICATED coarser levels
    (see `replicate_level`); ``op`` optionally shares `prep_local_op`'s
    output with the caller.  Returns ``(x_l, r_l, n)`` with ``n``
    replicated-identical across shards and ``x_l``'s periodic ghosts
    filled (the dense solve's final `bc_scalar_periodic`)."""
    from ..ops.multigrid import vcycle as plain_vcycle
    from ..ops.poisson import smooth as plain_smooth

    D = x_l.ndim
    names = _spatial_names(mesh)
    if op is None:
        op = prep_local_op(mesh, fL, D)

    def gdot2(a):
        return jax.lax.psum(jnp.sum(a * a), names)

    def vcycle_local(x_l, r_l):
        # Jacobi pre-smooth on the fine level (src/Poisson.jl:110-113)
        x_l, r_l = increment_local(mesh, S, fL, fD, x_l, r_l,
                                   r_l * fiD, op=op, perdir=perdir)
        rc = restrict_replicated(mesh, S, r_l)
        xc = jnp.zeros_like(coarse_l[0].D)
        if len(coarse_l) > 1:
            xc, rc = plain_vcycle(coarse_l, 0, xc, rc)
        xc, rc = plain_smooth(coarse_l[0], xc, rc, it_smooth)
        eps_l = prolongate_local(mesh, S, xc)
        return increment_local(mesh, S, fL, fD, x_l, r_l, eps_l,
                               op=op, perdir=perdir)

    def outer(x_l, r_l):
        x_l, r_l = vcycle_local(x_l, r_l)
        return pcg_local(mesh, S, fL, fD, fiD, x_l, r_l, it_smooth,
                         op=op, perdir=perdir)

    r_l = residual_local(mesh, S, fL, fD, fiD, x_l, z_l, op=op,
                         perdir=perdir)

    if fixed is not None:
        for _ in range(fixed):
            x_l, r_l = outer(x_l, r_l)
        if perdir:
            x_l = per_fill_local(x_l, mesh, S, perdir)
        return x_l, r_l, jnp.int32(fixed)

    def cond(c):
        _x, _r, n, r2, stop = c
        return (n == 0) | ((r2 >= tol) & (n < itmx) & ~stop)

    def body(c):
        x_l, r_l, n, r2p, _ = c
        x_l, r_l = outer(x_l, r_l)
        r2 = gdot2(r_l)
        # divergence safeguard: see ops.multigrid.ml_solve
        return (x_l, r_l, n + 1, r2, r2 > 2.0 * r2p)

    x_l, r_l, n, _r2, _ = jax.lax.while_loop(
        cond, body, (x_l, r_l, jnp.int32(0), gdot2(r_l), False))
    if perdir:
        x_l = per_fill_local(x_l, mesh, S, perdir)
    return x_l, r_l, n


def shardmap_ml_solve(levels, x, z, tol=1e-4, itmx=32, fixed=None):
    """Multigrid pressure solve in ONE shard_map region (see module doc).

    Same math as `ops.multigrid.ml_solve`: V-cycle + fine PCG per outer
    iteration, ≥1 iteration, on-device while_loop with the r·r-doubling
    divergence safeguard; ``fixed=k`` unrolls exactly k iterations.
    Returns ``(x, r, n)``.  Dots differ from the dense solve only by the
    per-shard-partials + psum association; transfers are bitwise-exact.
    """
    fine = levels[0]
    mesh = fine.mesh
    D = x.ndim
    S = x.shape
    sc, vec = spatial_specs(mesh, D)
    rep = P()
    coarse = tuple(replicate_level(l) for l in levels[1:])
    coarse_specs = jax.tree_util.tree_map(lambda _: rep, coarse)

    def local(fL, fD, fiD, coarse_l, x_l, z_l):
        return ml_solve_local(mesh, S, fL, fD, fiD, coarse_l, x_l, z_l,
                              tol=tol, itmx=itmx, fixed=fixed,
                              perdir=fine.perdir)

    fn = jax.shard_map(local, mesh=mesh,
                         in_specs=(vec, sc, sc, coarse_specs, sc, sc),
                         out_specs=(sc, sc, rep), check_vma=False)
    return fn(fine.L, fine.D, fine.iD, coarse, x, z)
