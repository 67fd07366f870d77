"""Explicit-collective spatial decomposition: shard_map + ppermute halos.

The production scaling path (`parallel.mesh`) relies on GSPMD: fields are
annotated and XLA's SPMD partitioner inserts the halo exchanges.  This
module is the *explicit* alternative — `shard_map` gives each device its
local block and the halo planes move through hand-written
`jax.lax.ppermute` collectives.  Two reasons it exists:

1. **Control.**  When the partitioner picks a bad layout (an all-gather
   fallback on an unevenly-sharded axis, say), the explicit path is the
   escape hatch: every byte moved between devices is visible in the
   source.
2. **Verification.**  `tests/test_sharding.py` pins it against the dense
   operator, which in turn documents precisely what communication the
   stencil *needs*: two width-1 planes of ``x`` per sharded axis (one per
   direction) plus one upper plane of each face-coefficient component.

The grid must shard evenly (`mesh_for` guarantees it); each local block
then holds ``S[d] / shards[d]`` planes of the ghost-padded global array,
and a 7-point stencil needs exactly one received plane per face.

Reference scope: the reference has no distributed support at all
(README.md:157); SURVEY.md §5.8 specifies this module's design.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from ..grid import axis_coord

__all__ = ["halo_exchange", "shardmap_mult", "spatial_specs",
           "shift_up", "ghost_mask_local", "per_fill_local"]


def spatial_specs(mesh: Mesh, D: int):
    """(scalar, vector) PartitionSpecs mapping mesh axes onto spatial dims.

    Delegates to the GSPMD path's `_spatial_spec` so the axis→dim mapping
    convention (positional, skipping the replica axis "r") lives in exactly
    one place."""
    from .mesh import _spatial_spec
    return _spatial_spec(mesh, D, 0), _spatial_spec(mesh, D, 1)


def _axis_shards(mesh: Mesh, D: int):
    names = [n for n in mesh.axis_names if n != "r"]
    return ([(names[k], mesh.shape[names[k]]) if k < len(names) else (None, 1)
             for k in range(D)])


def shift_up(a, d, mesh: Mesh, ax):
    """a_global[j+1] along axis d from the local block: local shift + ONE
    received plane.

    The only L communication the stencil needs — the upper-face
    coefficient — so each component costs a single ppermute (the appended
    top plane is zero on the last shard / unsharded axes, where it only
    feeds masked global-ghost outputs).  Must be called inside `shard_map`.
    """
    name, k = ax[d]
    lo = jax.lax.slice_in_dim(a, 0, 1, axis=d)
    if k > 1:
        bwd = [((i + 1) % k, i) for i in range(k)]
        recv = jax.lax.ppermute(lo, name, bwd)
        recv = jnp.where(jax.lax.axis_index(name) == k - 1, 0.0, recv)
    else:
        recv = jnp.zeros_like(lo)
    rest = jax.lax.slice_in_dim(a, 1, None, axis=d)
    return jnp.concatenate([rest, recv], axis=d)


def ghost_mask_local(mesh: Mesh, S, loc_shape):
    """Mask (local block) of cells NOT in the global ghost ring."""
    ax = _axis_shards(mesh, len(S))
    m = None
    for d in range(len(S)):
        name, k = ax[d]
        base = (jax.lax.axis_index(name) * (S[d] // k) if k > 1 else 0)
        g = axis_coord(loc_shape, d) + base
        md = (g >= 1) & (g <= S[d] - 2)
        m = md if m is None else m & md
    return m


def halo_exchange(x_local, mesh: Mesh, D: int, width: int = 1, perdir=()):
    """Grow every spatial axis of a shard_map-local block by ``width`` planes.

    Sharded axes receive the neighbouring shards' edge planes via
    `jax.lax.ppermute` (a pure ring shift — no gather); unsharded axes
    and domain edges get zeros, which is safe because the global ghost ring
    lives inside the first/last local block so edge halos are never read
    for interior outputs.  ``width=2`` serves the QUICK convection stencil
    (reads ``I-2δ``, reference src/Flow.jl:6).  Must be called inside
    `shard_map`.

    ``perdir`` axes get MODULAR wrap halos that skip the 2-plane ghost
    band: global position ``-m`` holds interior plane ``S-2-m`` and
    ``S-1+m`` holds plane ``1+m``.  Combined with periodic-filled ghost
    planes (``per_fill_local`` / the step's BC), every flux/stencil tap of
    a periodic direction then reads the value the reference's ϕuP wrap and
    top-face flux copy would produce (src/Flow.jl:7,60) with NO global
    switches: the face-1 far-upwind tap at position -1 IS plane S-3, and
    the top-face flux evaluated from {S-3, S-2, S-1≡1, S≡2} reproduces
    face 1's flux bitwise (identical input values, identical expression).
    Costs one extra 2-edge ppermute per sharded periodic axis.
    """
    lead = x_local.ndim - D
    for k, (name, n_shards) in enumerate(_axis_shards(mesh, D)):
        axis = lead + k
        n = x_local.shape[axis]
        lo = jax.lax.slice_in_dim(x_local, 0, width, axis=axis)
        hi = jax.lax.slice_in_dim(x_local, n - width, None, axis=axis)
        periodic = k in perdir
        if n_shards > 1:
            fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            bwd = [((i + 1) % n_shards, i) for i in range(n_shards)]
            from_below = jax.lax.ppermute(hi, name, fwd)   # shard i-1's top
            from_above = jax.lax.ppermute(lo, name, bwd)   # shard i+1's bottom
            idx = jax.lax.axis_index(name)
            if periodic:
                # wrap planes skip the ghost band: the top shard sends its
                # planes [n-2-width, n-2) to shard 0 and shard 0 sends
                # [2, 2+width) to the top shard (needs local blocks >= 2 +
                # width on periodic axes — gated by `can_shardmap`)
                wlo = jax.lax.ppermute(
                    jax.lax.slice_in_dim(x_local, n - 2 - width, n - 2,
                                         axis=axis),
                    name, [(n_shards - 1, 0)])
                whi = jax.lax.ppermute(
                    jax.lax.slice_in_dim(x_local, 2, 2 + width, axis=axis),
                    name, [(0, n_shards - 1)])
                from_below = jnp.where(idx == 0, wlo, from_below)
                from_above = jnp.where(idx == n_shards - 1, whi, from_above)
            else:
                from_below = jnp.where(idx == 0, 0.0, from_below)
                from_above = jnp.where(idx == n_shards - 1, 0.0, from_above)
        elif periodic:
            from_below = jax.lax.slice_in_dim(x_local, n - 2 - width, n - 2,
                                              axis=axis)
            from_above = jax.lax.slice_in_dim(x_local, 2, 2 + width,
                                              axis=axis)
        else:
            from_below = jnp.zeros_like(lo)
            from_above = jnp.zeros_like(hi)
        x_local = jnp.concatenate([from_below, x_local, from_above],
                                  axis=axis)
    return x_local


def per_fill_local(a, mesh: Mesh, S, perdir, lead: int = 0):
    """Periodic ghost fill on a shard_map-local block (reference ``perBC!``,
    src/util.jl:227-231; the `bc_scalar_periodic` analog): for each axis in
    ``perdir``, global ghost plane 0 := plane S-2 and plane S-1 := plane 1.
    Sharded axes move each source plane with one targeted `ppermute`;
    unsharded axes copy locally.  Applied per axis in ``perdir`` order on
    the current values — identical sequencing to the dense fill, so ghost
    corners agree exactly.  Must be called inside `shard_map`."""
    D = len(S)
    ax = _axis_shards(mesh, D)
    for d in perdir:
        name, k = ax[d]
        axis = lead + d
        n = a.shape[axis]
        if k > 1:
            idx = jax.lax.axis_index(name)
            # plane S-2 lives on the top shard (local n-2); ghost 0 on shard 0
            src_hi = jax.lax.slice_in_dim(a, n - 2, n - 1, axis=axis)
            recv0 = jax.lax.ppermute(src_hi, name, [(k - 1, 0)])
            # plane 1 lives on shard 0 (local 1); ghost S-1 on the top shard
            src_lo = jax.lax.slice_in_dim(a, 1, 2, axis=axis)
            recvN = jax.lax.ppermute(src_lo, name, [(0, k - 1)])
            row0 = jnp.where(idx == 0, recv0,
                             jax.lax.slice_in_dim(a, 0, 1, axis=axis))
            rowN = jnp.where(idx == k - 1, recvN,
                             jax.lax.slice_in_dim(a, n - 1, n, axis=axis))
        else:
            row0 = jax.lax.slice_in_dim(a, n - 2, n - 1, axis=axis)
            rowN = jax.lax.slice_in_dim(a, 1, 2, axis=axis)
        a = jnp.concatenate(
            [row0, jax.lax.slice_in_dim(a, 1, n - 1, axis=axis), rowN],
            axis=axis)
    return a




def shardmap_mult(mesh: Mesh, L, Dd, x):
    """z = A·x with explicit halo exchange (matches `ops.poisson.mult` for
    non-periodic levels on an evenly-dividing mesh).

    ``L`` (D,*S), ``Dd`` (*S), ``x`` (*S) may arrive unsharded; they are
    placed with `spatial_specs` and each device computes its block after
    one `ppermute` round per sharded axis.
    """
    D = x.ndim
    S = x.shape
    ax = _axis_shards(mesh, D)
    for d in range(D):
        if S[d] % ax[d][1] != 0:
            raise ValueError(
                f"axis {d}: size {S[d]} not divisible by {ax[d][1]} shards "
                f"(build the mesh with mesh_for)")
    sc, vec = spatial_specs(mesh, D)

    def local(L_l, Dd_l, x_l):
        loc_shape = x_l.shape
        xh = halo_exchange(x_l, mesh, D)

        def sl(a, offs, lead=0):
            # halo'd read: local cell j sits at padded index j+1
            return a[(slice(None),) * lead + tuple(
                slice(1 + offs[d], 1 + offs[d] + loc_shape[d])
                for d in range(D))]

        def offv(i, v):
            return tuple(v if d == i else 0 for d in range(D))

        z = x_l * Dd_l
        for i in range(D):
            z = (z + sl(xh, offv(i, -1)) * L_l[i]
                 + sl(xh, offv(i, +1)) * shift_up(L_l[i], i, mesh, ax))
        # zero the global ghost ring (cells at global index 0 or S-1)
        return jnp.where(ghost_mask_local(mesh, S, loc_shape), z, 0.0)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(vec, sc, sc),
                         out_specs=sc)
    L = jax.device_put(L, NamedSharding(mesh, vec))
    Dd = jax.device_put(Dd, NamedSharding(mesh, sc))
    x = jax.device_put(x, NamedSharding(mesh, sc))
    return fn(L, Dd, x)
