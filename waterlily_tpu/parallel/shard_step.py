"""The ENTIRE momentum step as one shard_map region.

`shard_solve` collapsed the pressure solve to one region; this module
goes the rest of the way: conv_diff, BDIM, boundary conditions, the exit
BC, both projections (with their solves) and the CFL reduction all run
inside a SINGLE shard_map region per time step, which minimizes the
region crossings and sync boundaries per step.

Every phase runs on the shard's local block with ppermute halos and
global-index masks:
- conv_diff / the solve reuse `shard_smooth.conv_diff_local` /
  `shard_solve.ml_solve_local`.
- BDIM blends the halo-exchanged force field locally (src/Flow.jl:131-135).
- BC applies the reference's sequential stage semantics (util.jl:192-210)
  as global-index where-selects: every ghost's source lies in the same
  shard (local blocks are ≥2 cells wide), so no communication at all.
- exitBC's mass-flux mean is a psum (util.jl:216-222).
- CFL is a local max + pmax (src/Flow.jl:172-182).

Reference scope: `mom_step!` (src/Flow.jl:153-169); the decomposition
design is SURVEY.md §5.8 / §7 stage 8 (the reference is single-device).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .halo import halo_exchange, _axis_shards, spatial_specs, \
    ghost_mask_local, per_fill_local
from .shard_smooth import can_shardmap, conv_diff_local, _spatial_names
from .shard_solve import ml_solve_local, replicate_level

__all__ = ["shardmap_mom_step", "can_shard_step", "bc_vector_local",
           "shardmap_conv_bdim"]


def shardmap_conv_bdim(cfg, u_in, u0, V, mu0, mu1, dt, t_eff, scale,
                       bc=None):
    """conv_diff + accelerate + BDIM blend in ONE shard_map region.

    The middle granularity between per-phase regions and the whole-step
    region: GSPMD's forms of the dense BDIM blend re-shard the μ₁
    contraction's shifted operands on a sharded layout, while the same
    blend as per-shard local slices of one halo-exchanged ``f`` is purely
    local.  Folding it into the conv region removes those forms without
    the whole-step region's halo-concat chain.

    ``scale=None`` is the predictor (``scale_u!(a,0)`` + BDIM!,
    src/Flow.jl:131-135,157-160: interior := blend, ghosts keep u0);
    ``scale=0.5`` is the corrector (interior := 0.5·(u_in + blend)).

    ``bc=U`` additionally applies the post-BDIM boundary conditions
    inside the region (`bc_vector_local` + `exit_bc_local` when
    ``cfg.exitBC`` and ``scale is None``) — the sequential-stage BC is
    communication-free per shard, so riding the region
    replaces GSPMD's DUS chains.
    """
    mesh = cfg.mesh
    D, S, dtype = cfg.D, cfg.S, cfg.dtype
    sc, vec = spatial_specs(mesh, D)
    ten = P(*([None, None] + list(vec[1:])))
    rep = P()
    from ..ops.convect import accelerate

    def local(u_l, u0_l, V_l, mu0_l, mu1_l, dt_l, t_l, U_l):
        r = conv_diff_local(mesh, S, u_l, cfg.nu, cfg.limiter, cfg.perdir)
        r = accelerate(r, t_l, cfg.g, cfg.U, dtype)
        blend = _bdim_blend_local(mesh, S, u0_l, r, V_l, mu0_l, mu1_l, dt_l)
        gmask = ghost_mask_local(mesh, S, u_l.shape[1:])
        if scale is None:
            un = jnp.where(gmask[None], blend, u0_l)
        else:
            un = jnp.where(gmask[None], scale * (u_l + blend), u_l)
        if bc is not None:
            A = tuple(U_l[i] for i in range(D))
            un = bc_vector_local(mesh, S, un, A, cfg.exitBC,
                                 perdir=cfg.perdir)
            if cfg.exitBC and scale is None:
                un = exit_bc_local(mesh, S, un, u0_l, A, dt_l)
        return un

    U_arr = (jnp.stack([jnp.asarray(a, dtype) for a in bc])
             if bc is not None else jnp.zeros((D,), dtype))
    fn = jax.shard_map(local, mesh=mesh,
                         in_specs=(vec, vec, vec, vec, ten, rep, rep, rep),
                         out_specs=vec, check_vma=False)
    return fn(u_in, u0, V, mu0, mu1,
              jnp.asarray(dt, dtype), jnp.asarray(t_eff, dtype), U_arr)


# Default OFF: on the previous accelerator the whole-step region measured
# slower than the one-region solve + per-phase conv regions (the in-region
# halo materializations — explicit concat rounds for conv/BDIM/div/
# projection/CFL — cost more than the saved region crossings).  Not yet
# measured on the card; flip here or monkeypatch in tests — the
# virtual-mesh parity tests stay green either way.
WHOLE_STEP_REGION = False


def can_shard_step(cfg, levels) -> bool:
    """Gate for the one-region step: an evenly-dividing mesh on the fine
    level (periodic dirs supported — see `can_shardmap`), and none of the
    paths that must stay on GSPMD —
    residual-trace capture (``log``), reverse-AD unrolling
    (``fixed_iters``), the implicit-diff step (its adjoint solve lives in
    `ops.multigrid`'s custom_vjp)."""
    fine = levels[0]
    return (WHOLE_STEP_REGION and fine.mesh is not None and not cfg.log
            and cfg.fixed_iters is None and not cfg.implicit_diff
            and can_shardmap(fine.mesh, fine.D.shape, fine.perdir))


def _gidx(mesh: Mesh, S, loc_shape, d, lead=0):
    """Global index along axis d for every cell of a local block."""
    ax = _axis_shards(mesh, len(S))
    name, k = ax[d]
    base = (jax.lax.axis_index(name) * (S[d] // k) if k > 1 else 0)
    return jax.lax.broadcasted_iota(jnp.int32, loc_shape, lead + d) + base


def bc_vector_local(mesh: Mesh, S, u_l, A, save_exit=False,
                    perdir: tuple = ()):
    """Reference ``BC!`` (util.jl:192-210) on a local block.

    The same sequential stage semantics as the DUS chain (component-major,
    direction-minor; each stage reads the previous stage's values) as
    global-index where-selects, with `jnp.roll` providing the one-cell
    sources (ghost and source always share a shard — blocks are ≥2 cells
    wide — and rolled wrap garbage is never selected); periodic directions
    fill ghost planes with `per_fill_local` ppermutes in the same stage
    position as the dense chain's periodic branch.  Bitwise-equal to
    `ops.bc.bc_vector`'s chain."""
    D = u_l.shape[0]
    loc = u_l.shape[1:]
    comps = []
    for i in range(D):
        v = u_l[i]
        Ai = jnp.asarray(A[i], u_l.dtype)
        for j in range(D):
            if j in perdir:
                v = per_fill_local(v, mesh, S, (j,))
                continue
            g = _gidx(mesh, S, loc, j)
            if i == j:
                hi = (g == S[j] - 1)
                if save_exit and i == 0:
                    hi = jnp.zeros_like(hi)
                v = jnp.where((g <= 1) | hi, Ai, v)
            else:
                up = jnp.roll(v, -1, axis=j)   # source at +1 (for ghost 0)
                dn = jnp.roll(v, +1, axis=j)   # source at -1 (for ghost S-1)
                v = jnp.where(g == 0, up,
                              jnp.where(g == S[j] - 1, dn, v))
        comps.append(v)
    return jnp.stack(comps, axis=0)


def exit_bc_local(mesh: Mesh, S, u_l, u0_l, U, dt):
    """Reference ``exitBC!`` (util.jl:216-222) on a local block: 1D
    convective outlet on the high-x ghost plane of component 0, shifted so
    the mean outflow equals ``U[0]`` (the mean is a psum)."""
    D = u_l.shape[0]
    loc = u_l.shape[1:]
    names = _spatial_names(mesh)
    g0 = _gidx(mesh, S, loc, 0)
    m = (g0 == S[0] - 1)
    cnt = 1.0
    for d in range(1, D):
        gd = _gidx(mesh, S, loc, d)
        m = m & (gd >= 1) & (gd <= S[d] - 2)
        cnt = cnt * (S[d] - 2)
    u0c = u0_l[0]
    um = jnp.roll(u0c, +1, axis=0)             # u0 at x-1 (same shard)
    new = u0c - U[0] * dt * (u0c - um)
    flux = jax.lax.psum(jnp.sum(jnp.where(m, new, 0.0)), names) / cnt - U[0]
    out0 = jnp.where(m, new - flux, u_l[0])
    return jnp.concatenate([out0[None], u_l[1:]], axis=0)


def _bdim_blend_local(mesh, S, u0_l, r_l, V_l, mu0_l, mu1_l, dt):
    """BDIM blend value on every local cell (reference src/Flow.jl:18-24,
    131-135): ``f = u⁰ + dt·r − V``; ``μ₁·∂f/∂n + V + μ₀∘f`` with the
    first-moment term from one halo exchange of ``f``."""
    D = u0_l.shape[0]
    f = u0_l + dt * r_l - V_l
    fh = halo_exchange(f, mesh, D)
    loc = u0_l.shape[1:]

    def sl(a, d, off):
        return a[(slice(None),) + tuple(
            slice(1 + (off if k == d else 0),
                  1 + (off if k == d else 0) + loc[k]) for k in range(D))]

    m = None
    for j in range(D):
        t = mu1_l[:, j] * (sl(fh, j, +1) - sl(fh, j, -1))
        m = t if m is None else m + t
    return 0.5 * m + V_l + mu0_l * f


def _div_local(mesh, S, u_l):
    """Cell divergence on the local block, global-ghost-zero (Flow.jl:11-17)."""
    D = u_l.shape[0]
    loc = u_l.shape[1:]
    uh = halo_exchange(u_l, mesh, D)
    s = None
    for i in range(D):
        c = tuple(slice(1, 1 + loc[k]) if k != i else slice(2, 2 + loc[k])
                  for k in range(D))
        t = uh[(i,) + c] - u_l[i]
        s = t if s is None else s + t
    mask = ghost_mask_local(mesh, S, loc)
    return jnp.where(mask, s, 0.0)


def _pressure_correct_local(mesh, S, fL, x_l, u_l):
    """u -= L∘∇x on the interior (the `project!` tail, src/Flow.jl:141-145)."""
    D = u_l.shape[0]
    loc = u_l.shape[1:]
    xh = halo_exchange(x_l, mesh, D)

    def slx(d, off):
        return xh[tuple(
            slice(1 + (off if k == d else 0),
                  1 + (off if k == d else 0) + loc[k]) for k in range(D))]

    upd = jnp.stack([fL[i] * (x_l - slx(i, -1)) for i in range(D)], axis=0)
    mask = ghost_mask_local(mesh, S, loc)
    return jnp.where(mask[None], u_l - upd, u_l)


def _cfl_local(mesh, S, u_l, nu, dt_max=10.0):
    """Adaptive time step (reference `CFL`, src/Flow.jl:172-182): local
    interior max + pmax."""
    D = u_l.shape[0]
    loc = u_l.shape[1:]
    names = _spatial_names(mesh)
    uh = halo_exchange(u_l, mesh, D)
    s = None
    for i in range(D):
        c = tuple(slice(1, 1 + loc[k]) if k != i else slice(2, 2 + loc[k])
                  for k in range(D))
        t = jnp.maximum(0.0, uh[(i,) + c]) + jnp.maximum(0.0, -u_l[i])
        s = t if s is None else s + t
    mask = ghost_mask_local(mesh, S, loc)
    mx = jax.lax.pmax(jnp.max(jnp.where(mask, s, -jnp.inf)), names)
    return jnp.minimum(jnp.asarray(dt_max, u_l.dtype), 1.0 / (mx + 5 * nu))


def shardmap_mom_step(cfg, levels, state):
    """One predictor/corrector time step (reference `mom_step!`,
    src/Flow.jl:153-169) in ONE shard_map region.  Same phase order and
    time conventions as `flow.mom_step`; returns ``(state, aux)``."""
    from ..flow import bc_tuple
    from ..ops.convect import accelerate

    fine = levels[0]
    mesh = fine.mesh
    D, S, dtype = cfg.D, cfg.S, cfg.dtype
    sc, vec = spatial_specs(mesh, D)
    ten = P(*([None, None] + list(vec[1:])))
    rep = P()
    coarse = tuple(replicate_level(l) for l in levels[1:])
    coarse_specs = jax.tree_util.tree_map(lambda _: rep, coarse)

    def local(u, p, V, mu0, mu1, dt, t, fL, fD, fiD, coarse_l):
        from .shard_smooth import prep_local_op
        U = bc_tuple(cfg.U, t + dt, D, dtype)
        gmask = ghost_mask_local(mesh, S, u.shape[1:])
        op = prep_local_op(mesh, fL, D)

        def solve_project(u, p, dt_eff):
            z = _div_local(mesh, S, u)
            x, _r, n = ml_solve_local(mesh, S, fL, fD, fiD, coarse_l,
                                      p * dt_eff, z, tol=cfg.tol,
                                      itmx=cfg.itmx, op=op,
                                      perdir=cfg.perdir)
            u = _pressure_correct_local(mesh, S, fL, x, u)
            return u, x / dt_eff, n

        # predictor u -> u'
        r = conv_diff_local(mesh, S, u, cfg.nu, cfg.limiter, cfg.perdir)
        r = accelerate(r, t, cfg.g, cfg.U, dtype)
        blend = _bdim_blend_local(mesh, S, u, r, V, mu0, mu1, dt)
        u1 = jnp.where(gmask[None], blend, u)      # scale_u!(a,0) + BDIM!
        u1 = bc_vector_local(mesh, S, u1, U, cfg.exitBC, perdir=cfg.perdir)
        if cfg.exitBC:
            u1 = exit_bc_local(mesh, S, u1, u, U, dt)
        u1, p, n1 = solve_project(u1, p, dt)
        u1 = bc_vector_local(mesh, S, u1, U, cfg.exitBC, perdir=cfg.perdir)

        # corrector u -> u¹
        r = conv_diff_local(mesh, S, u1, cfg.nu, cfg.limiter, cfg.perdir)
        r = accelerate(r, t + dt, cfg.g, cfg.U, dtype)
        blend = _bdim_blend_local(mesh, S, u, r, V, mu0, mu1, dt)
        u2 = jnp.where(gmask[None], 0.5 * (u1 + blend), u1)
        u2 = bc_vector_local(mesh, S, u2, U, cfg.exitBC, perdir=cfg.perdir)
        u2, p, n2 = solve_project(u2, p, 0.5 * dt)
        u2 = bc_vector_local(mesh, S, u2, U, cfg.exitBC, perdir=cfg.perdir)

        dt_new = _cfl_local(mesh, S, u2, cfg.nu)
        return u2, p, dt_new, jnp.stack([n1, n2])

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(vec, sc, vec, vec, ten, rep, rep, vec, sc, sc,
                  coarse_specs),
        out_specs=(vec, sc, rep, rep), check_vma=False)
    u2, p, dt_new, pois = fn(state.u, state.p, state.V, state.mu0,
                             state.mu1, state.dt, state.t,
                             fine.L, fine.D, fine.iD, coarse)
    new = state._replace(u=u2, p=p, dt=dt_new, t=state.t + state.dt)
    aux = {"pois_n": pois, "dt": dt_new}
    return new, aux
