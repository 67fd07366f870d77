"""Spatial domain decomposition over a JAX device mesh (GSPMD path).

The reference is single-device only (multi-GPU is unmerged upstream work,
README.md:157) — this module is the scaling path it lacks.
Fields are annotated with `with_sharding_constraint` along spatial mesh
axes *inside* the jitted step; XLA's SPMD partitioner then inserts the halo
exchanges for stencil shifts and the psum collectives for solver dot
products automatically.

Ghost-padded shapes (N+2) are never divisible by the mesh, so constraints
(which tolerate uneven shards via padding) are used instead of explicit
input shardings.  Coarse multigrid levels whose interiors are smaller than
the mesh are constrained to replicated — their work is negligible and this
keeps per-V-cycle collectives cheap.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..flow import FlowState, mom_step

__all__ = ["make_mesh", "mesh_for", "state_specs", "constrain_state",
           "constrain_levels", "sharded_step_fn", "sharded_scan_fn"]


def make_mesh(n: int | None = None, devices=None, axes=("x",)) -> Mesh:
    """1D (or multi-D) device mesh over the first ``n`` devices."""
    if devices is None:
        devices = jax.devices()
        if n is not None:
            devices = devices[:n]
    devices = np.asarray(devices)
    if len(axes) > 1:
        n = devices.size
        dims = []
        for _ in axes[:-1]:
            f = 1
            for c in range(int(np.sqrt(n)), 0, -1):
                if n % c == 0:
                    f = c
                    break
            dims.append(f)
            n //= f
        dims.append(n)
        devices = devices.reshape(dims)
    return Mesh(devices, axes)


def mesh_for(S: tuple, n: int | None = None, devices=None) -> Mesh:
    """Device mesh whose per-axis factors *divide* the padded grid size.

    GSPMD handles unevenly-sharded axes correctly but pays for them: any
    offset write-back (ghost pad, window update) on an axis whose size is
    not a multiple of its shard count falls back to an all-gather, while
    evenly-sharded axes lower purely to `collective-permute` halo exchanges
    (measured: pad/roll forms go from 3 gathers to 0).  Ghost-padded sizes
    ``N+2`` with the solver's even-``N`` constraint are always divisible by
    2 — and so is every coarser multigrid level — so factors of 2 per axis
    are always clean.

    Greedily assigns the largest power-of-2 factor of ``n`` dividing each
    ``S[d]``; any remainder becomes a trailing replica axis ``"r"`` (not
    referenced by the field specs, so fields are replicated across it).
    """
    if devices is None:
        devices = jax.devices()
        if n is not None:
            devices = devices[:n]
    n = len(devices)
    names = ("x", "y", "z")
    dims, axes = [], []
    rem = n
    for d, s in enumerate(S[:3]):
        f = 1
        while rem % 2 == 0 and s % (2 * f) == 0:
            f *= 2
            rem //= 2
        if f > 1:
            dims.append(f)
            axes.append(names[d])
    if rem > 1:
        dims.append(rem)
        axes.append("r")
    if not dims:
        # single device (or nothing divided): a trivial size-1 axis keeps
        # the Mesh non-empty — with_sharding_constraint rejects shardings
        # over an axis-less mesh, and a 1-sized axis shards nothing
        dims, axes = [1], ["x"]
    return Mesh(np.asarray(devices).reshape(dims), tuple(axes))


def _spatial_spec(mesh: Mesh, D: int, lead: int) -> P:
    # mesh axes map positionally onto spatial dims; a replica axis "r"
    # (mesh_for's non-dividing remainder) is never assigned to a dim
    names = [n for n in mesh.axis_names if n != "r"]
    return P(*([None] * lead + [names[k] if k < len(names) else None
                                for k in range(D)]))


def state_specs(mesh: Mesh, D: int) -> FlowState:
    sc = NamedSharding(mesh, _spatial_spec(mesh, D, 0))
    vec = NamedSharding(mesh, _spatial_spec(mesh, D, 1))
    ten = NamedSharding(mesh, _spatial_spec(mesh, D, 2))
    rep = NamedSharding(mesh, P())
    return FlowState(u=vec, p=sc, V=vec, mu0=vec, mu1=ten, dt=rep, t=rep,
                     bbox=rep)


def constrain_state(state: FlowState, mesh: Mesh) -> FlowState:
    """Pin every state leaf to its spatial sharding (inside jit)."""
    D = state.u.shape[0]
    return jax.lax.with_sharding_constraint(state, state_specs(mesh, D))


# Minimum level size (padded cells) for routing a level's smoother/stencils
# through shard_map regions.  Each region carries a fixed overhead on top
# of its compute (region entry/exit, per-call collectives), so tiny
# multigrid levels pay more in region count than their whole compute is
# worth: a 256³ solve has ~18 coarse-level regions per outer iteration.
# Below the threshold levels keep the GSPMD XLA forms.  The value was set
# on the previous accelerator and is to be re-tuned on the card.
SHARDMAP_MIN_CELLS = 2 ** 21


def constrain_levels(levels: tuple, mesh: Mesh, min_per_shard: int = 2) -> tuple:
    """Pin multigrid levels: sharded while every sharded spatial dim keeps at
    least ``min_per_shard`` interior cells per device, replicated below.

    Every returned level is marked ``sharded`` (SPMD-partitionable grid
    transfers) and un-banded (a dynamic window would gather across shards)
    — even for levels the caller built without the flag.  Levels of at
    least ``SHARDMAP_MIN_CELLS`` also carry ``mesh``, routing their
    smoother/stencils through the explicit shard_map path
    (`parallel.shard_smooth`)."""
    import math
    out = []
    names = [n for n in mesh.axis_names if n != "r"]
    for lev in levels:
        S = lev.D.shape
        lev = lev.replace(sharded=True, banded=False, box_shape=None,
                          box_start=None)
        ok = all((S[k] - 2) >= min_per_shard * mesh.shape[names[k]]
                 for k in range(min(len(names), len(S))))
        if ok:
            sh_sc = NamedSharding(mesh, _spatial_spec(mesh, len(S), 0))
            sh_vec = NamedSharding(mesh, _spatial_spec(mesh, len(S), 1))
            # `mesh` routes the smoother through the shard_map fast path
            # (ops.poisson.smooth) when it divides this level evenly AND
            # the level is big enough for a region to pay for itself
            big = math.prod(S) >= SHARDMAP_MIN_CELLS
            out.append(lev.replace(
                mesh=mesh if big else None,
                L=jax.lax.with_sharding_constraint(lev.L, sh_vec),
                D=jax.lax.with_sharding_constraint(lev.D, sh_sc),
                iD=jax.lax.with_sharding_constraint(lev.iD, sh_sc)))
        else:
            rep = NamedSharding(mesh, P())
            out.append(jax.lax.with_sharding_constraint(lev, rep))
    return tuple(out)


def mom_step_auto(cfg, levels, state):
    """`mom_step`, routed through the ONE-region shard_map step when the
    (constrained) fine level carries a mesh and the config allows it
    (`parallel.shard_step` — the multi-chip fast path), the per-phase
    GSPMD step otherwise."""
    fine = levels[0]
    if getattr(fine, "mesh", None) is not None:
        from .shard_step import can_shard_step, shardmap_mom_step
        if can_shard_step(cfg, levels):
            return shardmap_mom_step(cfg, levels, state)
    return mom_step(cfg, levels, state)


def sharded_step_fn(cfg, mesh: Mesh):
    """Jitted momentum step with spatial-decomposition constraints."""
    cfg = cfg._replace(sharded=True)

    def step(state, levels):
        state = constrain_state(state, mesh)
        levels = constrain_levels(levels, mesh)
        new, aux = mom_step_auto(cfg, levels, state)
        return constrain_state(new, mesh), aux

    return jax.jit(step)


def sharded_scan_fn(cfg, mesh: Mesh):
    """Jitted n-step scan under spatial decomposition (no host sync)."""
    cfg = cfg._replace(sharded=True)

    def steps(state, levels, n):
        state = constrain_state(state, mesh)
        levels = constrain_levels(levels, mesh)

        def body(s, _):
            s, aux = mom_step_auto(cfg, levels, s)
            return constrain_state(s, mesh), aux["pois_n"]

        state, pois = jax.lax.scan(body, state, None, length=n)
        return state, pois

    return jax.jit(steps, static_argnums=(2,))
