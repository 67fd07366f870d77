"""Ensemble design sweep: N spinning-cylinder simulations in ONE program.

The whole pipeline (BDIM measurement -> multigrid levels -> momentum
steps -> force) is a pure function of the spin ratio, so `jax.vmap`
batches the entire simulation over a parameter vector and XLA compiles
one program that runs every ensemble member concurrently on the chip —
a design-sweep idiom the reference's mutate-in-place architecture has no
analog for (and the basis for batched Bayesian optimization / UQ loops).

Run:  python examples/ensemble_sweep.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from waterlily_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

from waterlily_tpu.flow import FlowConfig, flow_init, mom_step
from waterlily_tpu.body import AutoBody, measure_fields
from waterlily_tpu.metrics import total_force
from waterlily_tpu.ops.multigrid import build_levels

f32 = jnp.float32


def make_force_fn(Dm=16, Re=500, U=1.0, n_steps=20):
    """Time-averaged force on a spinning cylinder as a pure fn of xi."""
    R = Dm // 2
    S = (6 * Dm + 2, 4 * Dm + 2)
    c = jnp.asarray([2.0 * Dm, 2.0 * Dm])

    def force(xi):
        xi = jnp.asarray(xi, f32)

        def sdf(x, t):
            return jnp.sqrt(jnp.sum(x * x)) - R

        def mp(x, t):
            a = xi * U * t / R
            s, cs = jnp.sin(a), jnp.cos(a)
            Rm = jnp.array([[cs, -s], [s, cs]], x.dtype)
            return Rm @ (x - c)

        body = AutoBody(sdf, mp)
        cfg = FlowConfig(D=2, S=S, nu=U * Dm / Re, U=(U, 0.0), dtype=f32,
                         fixed_iters=2)
        state = flow_init(cfg)
        V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, f32)
        state = state._replace(V=V, mu0=m0, mu1=m1)
        levels = build_levels(m0)

        def step(s, _):
            s, _aux = mom_step(cfg, levels, s)
            return s, total_force(s.u, s.p, cfg.nu, body, s.t)

        _, forces = jax.lax.scan(step, state, None, length=n_steps)
        # average the back half (transient discarded)
        return jnp.mean(forces[n_steps // 2:], axis=0) / (0.5 * U * U * Dm)

    return force


def main():
    # defaults are sized for a CPU CI box (compile-bound there); on a GPU,
    # Dm=32+ and dozens of members compile in similar time and the members
    # run concurrently on the card
    xis = jnp.linspace(0.5, 4.0, 8)
    sweep = jax.jit(jax.vmap(make_force_fn()))
    coeffs = jax.block_until_ready(sweep(xis))
    print(f"{'xi':>5} {'Cd':>8} {'Cl':>8}")
    for xi, (cd, cl) in zip(xis, coeffs):
        print(f"{float(xi):5.2f} {float(cd):8.3f} {float(cl):8.3f}")


if __name__ == "__main__":
    main()
