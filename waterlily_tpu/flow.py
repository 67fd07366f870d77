"""Flow state and the momentum step (predictor/corrector + projection).

Re-design of src/Flow.jl.  The mutable `Flow` struct becomes an
immutable pytree `FlowState`; `mom_step!` becomes the pure function
`mom_step(cfg, levels, state) -> (state, aux)` which is jitted *whole* —
both pressure solves, the BDIM updates and the CFL reduction compile into a
single XLA program with no host round-trips.

Scratch arrays (`f`, `σ`, `u⁰`) from the reference are not part of the
state: XLA's buffer allocator reuses them across the fused program.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from .grid import (interior_view, interior_mask, apply_field,
                   pad_interior)
from .ops.bc import bc_vector, exit_bc
from .ops.convect import conv_diff, accelerate, quick
from .ops.multigrid import ml_solve

__all__ = ["FlowState", "FlowConfig", "bc_tuple", "div", "bdim", "bdim_banded",
           "project", "cfl", "mom_step", "flow_init"]


class FlowState(NamedTuple):
    """Simulation state pytree (reference `Flow` fields, src/Flow.jl:92-122)."""
    u: jax.Array     # (D, *S) velocity
    p: jax.Array     # (*S)   pressure
    V: jax.Array     # (D, *S) body velocity (BDIM)
    mu0: jax.Array   # (D, *S) zeroth kernel moment (= Poisson face coeffs)
    mu1: jax.Array   # (D, D, *S) first kernel moment × normal
    dt: jax.Array    # scalar: the time step to take next
    t: jax.Array     # scalar: accumulated time (= sum of completed dts)
    bbox: jax.Array = None  # (D,) int32 body-band window corner (banded path)


class FlowConfig(NamedTuple):
    """Static configuration closed over by the jitted step."""
    D: int
    S: tuple                       # ghost-padded spatial shape
    nu: float = 0.0
    U: Any = None                  # tuple of BC velocities or callable (i,t)->u_i
    g: Callable | None = None      # body force g(i,t)
    perdir: tuple = ()
    exitBC: bool = False
    dtype: Any = jnp.float32
    limiter: Callable = quick
    tol: float = 1e-4
    itmx: int = 32
    log: bool = False              # capture per-iteration solver residual traces
    sharded: bool = False          # GSPMD layout: SPMD-partitionable forms
    mesh: Any = None               # device mesh: explicit shard_map fast paths
    bbox_shape: tuple | None = None  # static body-band box extents (banded BDIM)
    fixed_iters: int | None = None   # unroll exactly k pressure iterations:
    # reverse-mode differentiable step (jax.grad through mom_step)
    implicit_diff: bool = False      # adjoint (implicit-function) gradients:
    # reverse-mode via ONE extra Poisson solve instead of unrolling —
    # memory-feasible at scale (see ops.multigrid.ml_solve_implicit)


def bc_tuple(U, t, D, dtype):
    """Evaluate the BC velocity at time ``t`` (reference `BCTuple`, Flow.jl:79-80)."""
    if callable(U):
        return tuple(jnp.asarray(U(i, t), dtype) for i in range(D))
    return tuple(jnp.asarray(Ui, dtype) for Ui in U)


def _off(D, i, v):
    return tuple(v if d == i else 0 for d in range(D))


def div(u: jax.Array) -> jax.Array:
    """Cell divergence Σᵢ u[I+δᵢ,i]-u[I,i] on the interior, zero ghosts
    (reference `div`, src/Flow.jl:11-17).  All-slice form: XLA fuses the
    stencil into a single pass (ghost cells supply every neighbour)."""
    D = u.shape[0]
    s = None
    for i in range(D):
        t = interior_view(u[i], D, _off(D, i, +1)) - interior_view(u[i], D)
        s = t if s is None else s + t
    return pad_interior(s)


def _bdim_blend(u0, r, V, mu0, mu1, dt):
    """Interior BDIM update on a halo'd window (or the whole padded array).

    ``f = u⁰ + dt·r - V``, then ``μ₁·∂f/∂n + V + μ₀∘f`` on the interior,
    where the first-moment term is the central difference
    ``½Σⱼ μ₁[i,j](f[+δⱼ]-f[-δⱼ])`` (`μddn`, reference src/Flow.jl:18-24).
    """
    D = u0.shape[0]
    f = u0 + dt * r - V
    iv = lambda a, off=None: interior_view(a, D, off)
    m = None
    for j in range(D):
        # vectorized over components; slices of f (ghosts are valid reads)
        t = iv(mu1[:, j]) * (iv(f, _off(D, j, +1)) - iv(f, _off(D, j, -1)))
        m = t if m is None else m + t
    return 0.5 * m + iv(V) + iv(mu0) * iv(f)


def bdim(u, u0, r, V, mu0, mu1, dt):
    """BDIM velocity blend (reference `BDIM!`, src/Flow.jl:131-135)."""
    D = u.shape[0]
    upd = _bdim_blend(u0, r, V, mu0, mu1, dt)
    return u + pad_interior(upd, lead=1)


def bdim_banded(cfg, bbox, u, u0, r, V, mu0, mu1, dt, scale=None):
    """Band-windowed BDIM: the sparse immersed-boundary update.

    The body terms are spatially local: outside the kernel band
    ``μ₁ ≡ 0``, ``V ≡ 0`` and ``μ₀ ≡ 1`` *exactly* (measure_fields writes
    far cells with those constants), so the reference's whole-grid blend
    (src/Flow.jl:131-135) reduces to ``u += u⁰ + dt·r`` except inside a
    small box around the body.  The full blend runs only on a static-shape
    window (``cfg.bbox_shape + 2`` halo'd, dynamically positioned at
    ``bbox``), cutting BDIM's memory traffic ~8x at 256³.  Bitwise-equal to
    the dense path (up to the sign of zero).

    ``u=None`` selects the predictor form: interior from the blend alone,
    ghosts from ``u0`` (fuses the reference's ``scale_u!(a,0)``).
    """
    D, S = cfg.D, cfg.S
    W = tuple(w + 2 for w in cfg.bbox_shape)
    start = tuple(bbox[d] for d in range(D))
    sl = lambda a, lead: jax.lax.dynamic_slice(
        a, (jnp.int32(0),) * lead + start, a.shape[:lead] + W)
    blend = _bdim_blend(sl(u0, 1), sl(r, 1), sl(V, 1), sl(mu0, 1),
                        sl(mu1, 2), dt)
    f_far = u0 + dt * r                        # V ≡ 0 away from the body
    istart = (jnp.int32(0),) + tuple(s + 1 for s in start)
    if u is None:   # predictor: interior from the blend alone, ghosts u0
        out = jnp.where(interior_mask(S), f_far, u0)
        return jax.lax.dynamic_update_slice(out, blend, istart)
    upd_far = u + f_far
    w_val = interior_view(sl(u, 1), D) + blend
    if scale is not None:  # fuses the reference's post-BDIM scale_u!(a, 0.5)
        upd_far, w_val = scale * upd_far, scale * w_val
    out = jnp.where(interior_mask(S), upd_far, u)
    return jax.lax.dynamic_update_slice(out, w_val, istart)


def project(levels, u, p, dt_eff, cfg):
    """Pressure projection (reference `project!`, src/Flow.jl:137-145).

    The Poisson solution variable is the dt-scaled pressure (warm-started
    from the previous step); the velocity correction subtracts the
    μ₀-weighted pressure gradient.  Note the Poisson face coefficients are
    exactly ``flow.mu0`` (src/WaterLily.jl:77) — ``levels[0].L is mu0``.
    """
    from .ops.poisson import pressure_grad_interior
    lev = levels[0]
    with jax.named_scope("div_project"):
        z = div(u)
        x = p * dt_eff
    with jax.named_scope("pressure_solve"):
        if cfg.implicit_diff:
            # adjoint gradients: one extra Poisson solve under jax.grad
            # instead of transposing an unrolled solver
            from .ops.multigrid import ml_solve_implicit
            x, n = ml_solve_implicit(levels, x, z, tol=cfg.tol,
                                     itmx=cfg.itmx)
            tr = None
        else:
            out = ml_solve(levels, x, z, tol=cfg.tol, itmx=cfg.itmx,
                           trace=cfg.log, fixed=cfg.fixed_iters)
            x, r, n = out[:3]
            tr = out[3] if cfg.log else None
    with jax.named_scope("div_project"):
        upd = pressure_grad_interior(lev, x)
        u = u - pad_interior(upd, lead=1)
        p = x / dt_eff
    return u, p, (n, tr)


CONV_BDIM_REGION = True  # sharded conv+BDIM one-region path (A/B knob)
# Folding the post-BDIM BC into the conv+BDIM region: measured a loss on
# the previous accelerator (a global-index where-select cascade against
# GSPMD's DUS chains); re-measure on the card before turning it on.
BC_IN_REGION = False


def cfl(u, nu, dt_max=10.0):
    """Adaptive time step (reference `CFL`/`flux_out`, src/Flow.jl:172-182)."""
    D = u.shape[0]
    s = None
    for i in range(D):
        t = (jnp.maximum(0.0, interior_view(u[i], D, _off(D, i, +1)))
             + jnp.maximum(0.0, -interior_view(u[i], D)))
        s = t if s is None else s + t
    mx = jnp.max(s)
    return jnp.minimum(jnp.asarray(dt_max, u.dtype), 1.0 / (mx + 5 * nu))


def mom_step(cfg: FlowConfig, levels, state: FlowState):
    """One predictor/corrector time step (reference `mom_step!`, Flow.jl:153-169).

    Returns the advanced state and an aux dict with the pressure-solver
    iteration counts ``(predictor, corrector)`` for observability.
    """
    D, dtype = cfg.D, cfg.dtype
    u0, p, dt, t = state.u, state.p, state.dt, state.t
    U = bc_tuple(cfg.U, t + dt, D, dtype)

    imask = interior_mask(cfg.S)
    banded = cfg.bbox_shape is not None

    # sharded fast path: conv + accelerate + BDIM as ONE shard_map region
    # (the blend as per-shard local slices of one halo-exchanged ``f``
    # avoids GSPMD resharding the μ₁ contraction's shifted operands)
    shard_cb = False
    if CONV_BDIM_REGION and cfg.sharded and cfg.mesh is not None \
            and not banded:
        from .parallel.shard_smooth import can_shardmap
        shard_cb = can_shardmap(cfg.mesh, cfg.S, cfg.perdir)

    # predictor u -> u'
    with jax.named_scope("conv_diff"):
        if shard_cb:
            from .parallel.shard_step import shardmap_conv_bdim
            u = shardmap_conv_bdim(cfg, u0, u0, state.V, state.mu0,
                                   state.mu1, dt, t, None,
                                   bc=U if BC_IN_REGION else None)
        else:
            r = conv_diff(u0, cfg.nu, cfg.perdir, cfg.limiter, cfg.sharded,
                          cfg.mesh)
            r = accelerate(r, t, cfg.g, cfg.U, dtype)
    if not shard_cb:
        with jax.named_scope("bdim"):
            if banded:
                u = bdim_banded(cfg, state.bbox, None, u0, r,
                                state.V, state.mu0, state.mu1, dt)
            else:
                u = jnp.where(imask, 0.0, u0)            # scale_u!(a, 0)
                u = bdim(u, u0, r, state.V, state.mu0, state.mu1, dt)
    with jax.named_scope("bc"):
        if not (shard_cb and BC_IN_REGION):
            u = bc_vector(u, U, cfg.exitBC, cfg.perdir)
            if cfg.exitBC:
                u = exit_bc(u, u0, U, dt)
    u, p, (n1, tr1) = project(levels, u, p, dt, cfg)
    with jax.named_scope("bc"):
        u = bc_vector(u, U, cfg.exitBC, cfg.perdir)

    # corrector u -> u¹
    with jax.named_scope("conv_diff"):
        if shard_cb:
            u = shardmap_conv_bdim(cfg, u, u0, state.V, state.mu0,
                                   state.mu1, dt, t + dt, 0.5,
                                   bc=U if BC_IN_REGION else None)
        else:
            r = conv_diff(u, cfg.nu, cfg.perdir, cfg.limiter, cfg.sharded,
                          cfg.mesh)
            r = accelerate(r, t + dt, cfg.g, cfg.U, dtype)
    if not shard_cb:
        with jax.named_scope("bdim"):
            if banded:
                u = bdim_banded(cfg, state.bbox, u, u0, r, state.V,
                                state.mu0, state.mu1, dt, scale=0.5)
            else:
                u = bdim(u, u0, r, state.V, state.mu0, state.mu1, dt)
                u = jnp.where(imask, 0.5 * u, u)         # scale_u!(a, 0.5)
    with jax.named_scope("bc"):
        if not (shard_cb and BC_IN_REGION):
            u = bc_vector(u, U, cfg.exitBC, cfg.perdir)
    u, p, (n2, tr2) = project(levels, u, p, 0.5 * dt, cfg)
    with jax.named_scope("bc"):
        u = bc_vector(u, U, cfg.exitBC, cfg.perdir)

    with jax.named_scope("cfl"):
        dt_new = cfl(u, cfg.nu)
    new = state._replace(u=u, p=p, dt=dt_new, t=t + dt)
    aux = {"pois_n": jnp.stack([n1, n2]), "dt": dt_new}
    if cfg.log:
        aux["res_trace"] = jnp.stack([tr1, tr2])
    return new, aux


def flow_init(cfg: FlowConfig, ulam=None, dt0=0.25):
    """Initial state (reference `Flow` constructor, src/Flow.jl:110-121)."""
    D, S, dtype = cfg.D, cfg.S, cfg.dtype
    if ulam is None:
        if callable(cfg.U):
            ulam = lambda i, x: jnp.asarray(cfg.U(i, 0.0), dtype)
        else:
            ulam = lambda i, x: jnp.asarray(cfg.U[i], dtype)
    u = apply_field(ulam, (D,) + S, dtype, vector=True)
    U0 = bc_tuple(cfg.U, jnp.zeros((), dtype), D, dtype)
    u = bc_vector(u, U0, cfg.exitBC, cfg.perdir)
    u = exit_bc(u, u, U0, jnp.zeros((), dtype))   # always applied at init (Flow.jl:115)
    p = jnp.zeros(S, dtype)
    V = jnp.zeros((D,) + S, dtype)
    mu0 = bc_vector(jnp.ones((D,) + S, dtype), (0.0,) * D, False, cfg.perdir)
    mu1 = jnp.zeros((D, D) + S, dtype)
    return FlowState(u=u, p=p, V=V, mu0=mu0, mu1=mu1,
                     dt=jnp.asarray(dt0, dtype), t=jnp.zeros((), dtype),
                     bbox=jnp.zeros((D,), jnp.int32))
