"""Gradient-based design: find the spin ratio of a rotating cylinder that
hits a target lift, by differentiating THROUGH the whole solver.

End-to-end reverse-mode AD — body map -> BDIM measurement -> momentum
step -> multigrid pressure solve (fixed-trip, so the transpose is exact)
-> surface force — is a capability the Julia reference does not have
(its ForwardDiff scope stops at sdf/map derivatives, src/AutoBody.jl);
here the entire `mom_step` chain is one differentiable jit program.

Run:  python examples/optimize_spin.py [--implicit]

``--implicit`` switches the adjoint from the fixed-trip unroll to the
implicit-function-theorem path (``implicit_diff=True``): the pressure
solve stays adaptive/converged and reverse-mode costs ONE adjoint
Poisson solve per projection instead of storing every smoother iterate —
the memory-feasible mode at 256³-class grids (FD-pinned in
tests/test_grad.py::test_implicit_grad_through_body_measurement).

Runs on the default device in f64 (tests/test_grad.py pins gradient ==
finite differences on the same configuration).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

from waterlily_tpu.body import AutoBody, measure_fields
from waterlily_tpu.flow import FlowConfig, flow_init, mom_step
from waterlily_tpu.metrics import total_force
from waterlily_tpu.ops.multigrid import build_levels

f64 = jnp.float64
Dm, Re, U = 8, 500, 1.0          # cylinder diameter (cells), Reynolds, speed
R = Dm // 2
S = (2 * Dm + 2, 2 * Dm + 2)
CL_TARGET = -2.0                 # target lift coefficient after 3 steps


def lift_coeff(xi):
    """Lift coefficient of a cylinder spinning at tip-speed ratio ``xi``
    after 3 impulsive-start steps (a short, fully differentiable horizon)."""
    xi = jnp.asarray(xi, f64)

    def sdf(x, t):
        return jnp.sqrt(jnp.sum(x * x)) - R

    def mp(x, t):                # rotate the body frame at rate xi*U/R
        a = xi * U * t / R
        s, c = jnp.sin(a), jnp.cos(a)
        Rm = jnp.array([[c, -s], [s, c]], x.dtype)
        return Rm @ (x - Dm)

    body = AutoBody(sdf, mp)
    if "--implicit" in sys.argv:
        ad = dict(implicit_diff=True, tol=1e-12, itmx=64)
    else:
        ad = dict(fixed_iters=1)
    cfg = FlowConfig(D=2, S=S, nu=U * Dm / Re, U=(U, 0.0), dtype=f64, **ad)
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


def main():
    def loss_fn(xi):
        cl = lift_coeff(xi)
        return (cl - CL_TARGET) ** 2, cl

    loss = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    xi = jnp.asarray(1.0, f64)
    print("it   xi       Cl        loss      dloss/dxi")
    for it in range(12):
        (val, cl), g = loss(xi)
        print(f"{it:2d}  {float(xi):6.3f}  {float(cl):8.4f}  "
              f"{float(val):9.2e}  {float(g):+9.2e}")
        if float(val) < 1e-6:
            break
        xi = xi - 0.25 * g       # plain gradient descent
    print(f"\noptimized spin ratio xi = {float(xi):.4f} "
          f"(Cl = {float(cl):.4f}, target {CL_TARGET})")


if __name__ == "__main__":
    main()
