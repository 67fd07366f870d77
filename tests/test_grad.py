"""Reverse-mode differentiability through the whole solver.

The reference is forward-mode only (ForwardDiff duals, maintests.jl:254-278);
`FlowConfig(fixed_iters=k)` statically unrolls the pressure solve so
`jax.grad` flows through the full predictor/corrector step — this build's
beyond-parity differentiator (adjoint optimization, flow control, shape
gradients).

All differentiated parameters enter as *traced* jit arguments so the
value/grad programs compile once each (re-used across the finite-difference
probes) — compile time dominates on the 1-core CI box.
"""
import jax
import jax.numpy as jnp
import numpy as np

from waterlily_tpu.flow import FlowConfig, flow_init, mom_step
from waterlily_tpu.ops.multigrid import build_levels, ml_solve

f64 = jnp.float64
# one TGV period on the smallest 2-MG-level grid: the grad==FD==jvp oracle
# is grid-size-invariant.  Measured: these tests are trace/transpose-bound
# (~30 s each on the 1-core CI box) and nearly size-INDEPENDENT — 16^2 with
# 3 MG levels costs within 2 s of 8^2 with 2 — so this is their floor.
L = 8
KAPPA = 2 * np.pi / L


def _tgv_ulam(i, x):
    xs, ys = x[0] * KAPPA, x[1] * KAPPA
    return jnp.where(i == 0, -jnp.sin(xs) * jnp.cos(ys),
                     jnp.cos(xs) * jnp.sin(ys))


def _ke_after(nu, n_steps=2, fixed=1):
    # fixed_iters=1: the oracle (grad == FD == jvp of the SAME program) is
    # invariant to solver depth, while the traced/transposed program — the
    # dominant wall time on the 1-core CI box — halves vs fixed=2.
    cfg = FlowConfig(D=2, S=(L + 2, L + 2), nu=nu, U=(0.0, 0.0),
                     perdir=(0, 1), dtype=f64, fixed_iters=fixed)
    state = flow_init(cfg, _tgv_ulam)
    levels = build_levels(state.mu0, cfg.perdir)

    def body(s, _):
        s, _aux = mom_step(cfg, levels, s)
        return s, None

    state, _ = jax.lax.scan(body, state, None, length=n_steps)
    from waterlily_tpu.metrics import ke
    return jnp.sum(ke(state.u))


def test_fixed_iters_matches_adaptive():
    """The statically-unrolled solve reaches the same answer as the
    while_loop solve when given the iterations the adaptive path used."""
    cfg = FlowConfig(D=2, S=(L + 2, L + 2), nu=0.01, U=(0.0, 0.0),
                     perdir=(0, 1), dtype=f64)
    state = flow_init(cfg, _tgv_ulam)
    levels = build_levels(state.mu0, cfg.perdir)
    from waterlily_tpu.flow import div
    z = div(state.u)
    x0 = jnp.zeros_like(state.p)
    xa, ra, na = jax.jit(lambda: ml_solve(levels, x0, z))()
    n = int(na)
    xf, rf, nf = jax.jit(lambda: ml_solve(levels, x0, z, fixed=n))()
    assert int(nf) == n
    assert np.allclose(np.asarray(xa), np.asarray(xf), atol=1e-12)


def test_reverse_grad_ke_wrt_nu():
    """d(KE)/d(nu) by jax.grad through 2 full steps (scan + unrolled
    multigrid) matches central finite differences, and equals the
    forward-mode (jvp) directional derivative."""
    nu0 = 1.0 / (KAPPA * 100.0)
    # ONE compiled program serves both the gradient and the FD value probes
    # (value_and_grad; the probes discard the grad output) — each distinct
    # program costs seconds of trace+lower+AOT-load on the 1-core CI box.
    vg = jax.jit(jax.value_and_grad(_ke_after))
    g = float(vg(jnp.asarray(nu0, f64))[1])
    h = nu0 * 1e-3
    fd = float((vg(jnp.asarray(nu0 + h, f64))[0] -
                vg(jnp.asarray(nu0 - h, f64))[0]) / (2 * h))
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-4), (g, fd)
    # reverse == forward on the identical fixed-trip program (jitted: an
    # eager jvp would execute thousands of ops one-by-one on the CI box)
    jv_fn = jax.jit(lambda nu: jax.jvp(_ke_after, (nu,),
                                       (jnp.ones((), f64),))[1])
    assert np.isclose(g, float(jv_fn(jnp.asarray(nu0, f64))), rtol=1e-9)


def test_reverse_grad_through_body_measurement():
    """jax.grad w.r.t. a body-map parameter (cylinder spin ratio) flows
    through measure_fields (vmapped sdf gradients + map Jacobians),
    build_levels re-restriction, and the fixed-trip momentum step —
    the reverse-mode analog of the reference's spinning-cylinder
    ForwardDiff test (maintests.jl:263-277)."""
    from waterlily_tpu.body import AutoBody, measure_fields
    from waterlily_tpu.metrics import total_force

    # Dm=8 -> S=18^2 (4 MG levels) and fixed_iters=1: the oracle (reverse
    # grad == FD of the SAME program) is invariant to solver depth, while
    # the traced/AD'd program — the dominant wall-time on the 1-core CI
    # box — shrinks ~2x (70 -> ~35 s warm)
    Dm, Re, U = 8, 500, 1.0
    R = Dm // 2
    S = (2 * Dm + 2, 2 * Dm + 2)

    def lift(xi):
        xi = jnp.asarray(xi, f64)

        def sdf(x, t):
            return jnp.sqrt(jnp.sum(x * x)) - R

        def mp(x, t):
            a = xi * U * t / R
            s, c = jnp.sin(a), jnp.cos(a)
            Rm = jnp.array([[c, -s], [s, c]], x.dtype)
            return Rm @ (x - Dm)

        body = AutoBody(sdf, mp)
        cfg = FlowConfig(D=2, S=S, nu=U * Dm / Re, U=(U, 0.0), dtype=f64,
                         fixed_iters=1)
        state = flow_init(cfg)
        V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, f64)
        state = state._replace(V=V, mu0=m0, mu1=m1)
        levels = build_levels(m0)

        def step(s, _):
            s, _aux = mom_step(cfg, levels, s)
            return s, None

        state, _ = jax.lax.scan(step, state, None, length=3)
        f = total_force(state.u, state.p, cfg.nu, body, state.t)
        return f[1] / (xi ** 2 * U ** 2 * Dm)

    xi0 = 2.0
    # one value_and_grad program serves the gradient and both FD probes
    vg = jax.jit(jax.value_and_grad(lift))
    g = float(vg(jnp.asarray(xi0, f64))[1])
    h = 1e-5
    fd = float((vg(jnp.asarray(xi0 + h, f64))[0] -
                vg(jnp.asarray(xi0 - h, f64))[0]) / (2 * h))
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-3), (g, fd)


# --- implicit differentiation (adjoint pressure solve) ----------------------


def test_implicit_solve_grad_matches_fd():
    """Implicit-function gradients of the multigrid solve (custom_vjp: one
    adjoint solve + one operator vjp) match central FD of the SAME adaptive
    program, including the coefficient chain dL/dθ -> build_levels -> D and
    a dead-cell (immersed-body) block exercising the z̄ mask."""
    from waterlily_tpu.ops.multigrid import ml_solve_implicit
    from waterlily_tpu.ops.bc import bc_vector
    from waterlily_tpu.grid import pad_interior, field_dot, inside_count

    S = (10, 10)
    D = 2
    gx = jax.lax.broadcasted_iota(f64, S, 0)
    gy = jax.lax.broadcasted_iota(f64, S, 1)
    dead = (gx >= 4) & (gx <= 7) & (gy >= 4) & (gy <= 7)  # faces to zero
    # cells 5..6 per axis lose all four faces -> D == 0 -> masked dead

    def mu0_of(th):
        mod = 1.0 + 0.25 * th * jnp.sin(0.7 * gx) * jnp.cos(0.5 * gy)
        m = jnp.where(dead, 0.0, mod)[None] * jnp.ones((D,) + S, f64)
        return bc_vector(m, (0.0,) * D, save_exit=False, perdir=())

    imask = pad_interior(jnp.ones((S[0] - 2, S[1] - 2), f64)) > 0
    live = imask & ~dead  # solvability: zero on dead cells AND zero mean
    # over LIVE cells (the operator's null space is constants-on-live)

    def interior_zero_mean(a):
        v = jnp.where(live, a, 0.0)
        return jnp.where(live, v - jnp.sum(v) / jnp.sum(live), 0.0)

    z = interior_zero_mean(jnp.sin(1.3 * gx) * jnp.sin(0.9 * gy))
    w = interior_zero_mean(jnp.cos(0.8 * gx + 0.3) * jnp.cos(1.1 * gy))

    def loss(th):
        levels = build_levels(mu0_of(th))
        x, _n = ml_solve_implicit(levels, jnp.zeros(S, f64), z,
                                  tol=1e-24, itmx=200)
        return field_dot(x, w)

    vg = jax.jit(jax.value_and_grad(loss))
    th0 = 0.8
    g = float(vg(jnp.asarray(th0, f64))[1])
    h = 1e-6
    fd = float((vg(jnp.asarray(th0 + h, f64))[0] -
                vg(jnp.asarray(th0 - h, f64))[0]) / (2 * h))
    assert np.isfinite(g) and abs(g) > 1e-12
    assert np.isclose(g, fd, rtol=1e-5), (g, fd)


def test_implicit_full_step_grad_matches_fd():
    """d(KE)/d(nu) by jax.grad through 2 full steps with the ADAPTIVE
    pressure solve (implicit_diff: the while_loop stays; reverse-mode costs
    one adjoint solve per projection) matches central finite differences —
    the memory-feasible alternative to the fixed_iters unroll."""

    def ke_after(nu):
        cfg = FlowConfig(D=2, S=(L + 2, L + 2), nu=nu, U=(0.0, 0.0),
                         perdir=(0, 1), dtype=f64, tol=1e-12, itmx=64,
                         implicit_diff=True)
        state = flow_init(cfg, _tgv_ulam)
        levels = build_levels(state.mu0, cfg.perdir)

        def body(s, _):
            s, _aux = mom_step(cfg, levels, s)
            return s, None

        state, _ = jax.lax.scan(body, state, None, length=2)
        from waterlily_tpu.metrics import ke
        return jnp.sum(ke(state.u))

    nu0 = 1.0 / (KAPPA * 100.0)
    vg = jax.jit(jax.value_and_grad(ke_after))
    g = float(vg(jnp.asarray(nu0, f64))[1])
    h = nu0 * 1e-3
    fd = float((vg(jnp.asarray(nu0 + h, f64))[0] -
                vg(jnp.asarray(nu0 - h, f64))[0]) / (2 * h))
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-4), (g, fd)


def test_simulation_implicit_diff_plumbs_and_validates():
    """`Simulation(implicit_diff=True)` steps normally (the custom_vjp
    wrapper is primal-transparent) and rejects conflicting AD modes."""
    import pytest
    from waterlily_tpu import Simulation

    with pytest.raises(ValueError):
        Simulation((8, 8), (1.0, 0.0), 8, implicit_diff=True, fixed_iters=1)
    with pytest.raises(ValueError):
        Simulation((8, 8), (1.0, 0.0), 8, implicit_diff=True, log=True)
    with pytest.raises(TypeError):
        # the bf16 operator shadows are gone: the adjoint always transposes
        # the same f32 operator the primal solve used
        Simulation((8, 8), (1.0, 0.0), 8, implicit_diff=True, op_bf16=True)

    sim = Simulation((8, 8), (1.0, 0.0), 8, nu=0.1, implicit_diff=True)
    sim.step()
    assert np.isfinite(float(jnp.sum(sim.flow.u)))
    assert len(sim.pois_n) == 1 and len(sim.dts) == 2


def test_implicit_grad_through_body_measurement():
    """Implicit-diff reverse gradient through the MOVING-BODY chain — map
    parameter -> jax.grad measurement -> BDIM fields -> level coefficients
    -> converged adaptive solve (custom_vjp) -> surface force — matches
    central FD of the same program (the body-chain analog of the nu
    oracle; the solve-level test pins the coefficient vjp in isolation)."""
    from waterlily_tpu.body import AutoBody, measure_fields
    from waterlily_tpu.metrics import total_force

    Dm, Re, U = 8, 500, 1.0
    R = Dm // 2
    S = (2 * Dm + 2, 2 * Dm + 2)

    def lift(xi):
        xi = jnp.asarray(xi, f64)

        def sdf(x, t):
            return jnp.sqrt(jnp.sum(x * x)) - R

        def mp(x, t):
            a = xi * U * t / R
            s, c = jnp.sin(a), jnp.cos(a)
            Rm = jnp.array([[c, -s], [s, c]], x.dtype)
            return Rm @ (x - Dm)

        body = AutoBody(sdf, mp)
        cfg = FlowConfig(D=2, S=S, nu=U * Dm / Re, U=(U, 0.0), dtype=f64,
                         implicit_diff=True, tol=1e-12, itmx=64)
        state = flow_init(cfg)
        V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, f64)
        state = state._replace(V=V, mu0=m0, mu1=m1)
        levels = build_levels(m0)

        def step(s, _):
            s, _aux = mom_step(cfg, levels, s)
            return s, None

        state, _ = jax.lax.scan(step, state, None, length=3)
        f = total_force(state.u, state.p, cfg.nu, body, state.t)
        return 2 * f[1] / (U ** 2 * Dm)

    vg = jax.jit(jax.value_and_grad(lift))
    xi0 = 1.0
    g = float(vg(jnp.asarray(xi0, f64))[1])
    h = 1e-6
    fd = float((vg(jnp.asarray(xi0 + h, f64))[0] -
                vg(jnp.asarray(xi0 - h, f64))[0]) / (2 * h))
    assert np.isfinite(g)
    assert np.isclose(g, fd, rtol=1e-4), (g, fd)

def test_implicit_grad_linear_in_loss_scale():
    """The adjoint solve's stopping test is absolute (r.r >= tol) while the
    cotangent's scale follows the loss's: without RHS normalization a loss
    scaled by 1e-6 makes ||xbar||^2 < tol, the adjoint solve exits after
    one forced iteration, and AD linearity grad(c*f) == c*grad(f) breaks
    at the DEFAULT tol (the FD oracles all use tol<=1e-12 and hide it)."""
    from waterlily_tpu.ops.multigrid import ml_solve_implicit
    from waterlily_tpu.ops.bc import bc_vector
    from waterlily_tpu.grid import field_dot

    S = (34, 34)  # variable coefficients at this size: the truncated
    # adjoint (pre-fix) is 3.3% wrong here, ~2x wrong at 66^2
    gx = jax.lax.broadcasted_iota(f64, S, 0)
    gy = jax.lax.broadcasted_iota(f64, S, 1)
    mod = 1.0 + 0.9 * jnp.sin(0.7 * gx) * jnp.cos(0.5 * gy)
    mu0 = bc_vector(mod[None] * jnp.ones((2,) + S, f64), (0.0, 0.0),
                    save_exit=False)
    z = jnp.sin(1.3 * gx) * jnp.sin(0.9 * gy)
    z = z - jnp.mean(z)
    w = jnp.cos(0.8 * gx + 0.3) * jnp.cos(1.1 * gy)

    def loss(th, c):
        levels = build_levels(mu0)
        x, _n = ml_solve_implicit(levels, jnp.zeros(S, f64), th * z,
                                  tol=1e-4, itmx=64)  # the DEFAULT tol
        return c * field_dot(x, w)

    g1 = float(jax.grad(loss)(jnp.asarray(1.0, f64), 1.0))
    g2 = float(jax.grad(loss)(jnp.asarray(1.0, f64), 1e-6))
    assert np.isfinite(g1) and abs(g1) > 1e-12
    assert np.isclose(g2, 1e-6 * g1, rtol=1e-6), (g1, g2)
    # zero cotangent stays exactly zero (the normalization guard)
    g0 = float(jax.grad(loss)(jnp.asarray(1.0, f64), 0.0))
    assert g0 == 0.0
