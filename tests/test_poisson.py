"""Poisson and multigrid tests — oracles from reference maintests.jl:68-117."""
import jax.numpy as jnp
import numpy as np
import pytest

import waterlily_tpu as wl
from waterlily_tpu.grid import l2, loc_grid, interior
from waterlily_tpu.ops.bc import bc_vector
from waterlily_tpu.ops.poisson import make_level, mult, poisson_solve
from waterlily_tpu.ops.multigrid import build_levels, ml_solve, n_levels, restrict_L

f32 = jnp.float32


def poisson_setup(N, ml=False):
    """Manufactured-solution setup (reference Poisson_setup, maintests.jl:68-79).

    Unit face coefficients with walled BCs; exact solution = x-index; solve
    A x = A soln from zero and return the relative (squared) L2 error."""
    D = len(N)
    L = bc_vector(jnp.ones((D,) + N, f32), (0.0,) * D)
    x = jnp.zeros(N, f32)
    soln = jnp.broadcast_to(
        jnp.arange(1, N[0] + 1, dtype=f32).reshape((-1,) + (1,) * (D - 1)), N)
    soln = soln - soln[tuple([1] * D)]
    if ml:
        levels = build_levels(L)
        z = mult(levels[0], soln)
        xs, r, n = ml_solve(levels, x, z)
        lev = levels
    else:
        lev = make_level(L)
        z = mult(lev, soln)
        xs, r, n = poisson_solve(lev, x, z)
    xs = xs - xs[tuple([1] * D)]
    err = float(l2(xs - soln) / l2(soln))
    return err, int(n), lev


def test_poisson_level_pytree_static_fields():
    """`PoissonLevel` is a JAX-only pytree: L/D/iD are its leaves, the
    static fields are metadata (part of the jit cache key, never traced),
    and `.replace` returns a new level without touching the old one."""
    import dataclasses
    import jax

    lev = make_level(jnp.ones((2, 6, 6), f32), perdir=(1,))
    assert len(jax.tree_util.tree_leaves(lev)) == 3
    traces = []

    @jax.jit
    def f(lv):
        traces.append((lv.perdir, lv.sharded))
        assert isinstance(lv.perdir, tuple) and isinstance(lv.c, float)
        return jnp.sum(lv.D) * lv.c

    f(lev)
    f(lev.replace(L=lev.L * 2))             # new leaf values: no retrace
    assert len(traces) == 1
    lev2 = lev.replace(sharded=True, c=2.0)
    assert float(f(lev2)) == pytest.approx(2 * float(jnp.sum(lev.D)))
    assert traces == [((1,), False), ((1,), True)]
    assert lev.sharded is False and lev.c == 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        lev.c = 3.0


def test_diag_oracle():
    # maintests.jl:84-85: exact D and iD on a 5x5 grid
    L = bc_vector(jnp.ones((2, 5, 5), f32), (0.0, 0.0))
    lev = make_level(L)
    Dref = np.array([[0, 0, 0, 0, 0], [0, -2, -3, -2, 0], [0, -3, -4, -3, 0],
                     [0, -2, -3, -2, 0], [0, 0, 0, 0, 0]], np.float32)
    assert np.array_equal(np.asarray(lev.D), Dref)
    with np.errstate(divide="ignore"):
        iDref = np.where(Dref == 0, 0, 1.0 / Dref)
    assert np.allclose(np.asarray(lev.iD), iDref)


def test_poisson_2d_small():
    err, n, _ = poisson_setup((5, 5))
    assert err < 1e-5


def test_poisson_2d():
    # maintests.jl:87-89
    err, n, _ = poisson_setup((2 ** 6 + 2, 2 ** 6 + 2))
    assert err < 1e-6
    assert n < 310


def test_poisson_3d():
    # maintests.jl:90-92
    err, n, _ = poisson_setup((2 ** 4 + 2, 2 ** 4 + 2, 2 ** 4 + 2))
    assert err < 1e-6
    assert n < 35


def test_mg_level_count_throws():
    # maintests.jl:99: size=a2^n with n>2 required
    with pytest.raises(ValueError):
        n_levels((15 + 2, 3 ** 4 + 2))


def test_mg_coarse_diag_and_update():
    # maintests.jl:101-107 on a (10,10) stack
    err, n, levels = poisson_setup((10, 10), ml=True)
    assert err < 1e-5
    Dref = np.array([[0, 0, 0, 0], [0, -2, -2, 0], [0, -2, -2, 0], [0, 0, 0, 0]],
                    np.float32)
    assert np.array_equal(np.asarray(levels[2].D), Dref)
    # coefficient change propagates through update (reference update!)
    L0 = levels[0].L.at[0, 4:6, :].set(0.0)
    levels = wl.build_levels(L0)
    Dref2 = np.array([[0, 0, 0, 0], [0, -1, -1, 0], [0, -1, -1, 0], [0, 0, 0, 0]],
                     np.float32)
    assert np.array_equal(np.asarray(levels[2].D), Dref2)


def test_mg_2d():
    # maintests.jl:110-112
    err, n, _ = poisson_setup((2 ** 6 + 2, 2 ** 6 + 2), ml=True)
    assert err < 1e-6
    assert n <= 3


def test_mg_3d():
    # maintests.jl:113-115
    err, n, _ = poisson_setup((2 ** 4 + 2, 2 ** 4 + 2, 2 ** 4 + 2), ml=True)
    assert err < 1e-6
    assert n <= 3


def test_solver_divergence_safeguard():
    """The adaptive solve loops exit when an iteration doubles r·r instead
    of amplifying a diverging/floored smoother to NaN over the remaining
    itmx trips (the runaway seen when a solve's convergence floor sits
    above tol)."""
    D = 2
    N = (10, 10)
    L = bc_vector(jnp.ones((D,) + N, f32), (0.0,) * D)
    lev = make_level(L)
    soln = jnp.broadcast_to(jnp.arange(1, 11, dtype=f32).reshape(-1, 1), N)
    z = mult(lev, soln)

    def inflating(lev_, x, r):
        return x, 3.0 * r

    x, r, n = poisson_solve(lev, jnp.zeros(N, f32), z, itmx=50,
                            smoother=inflating)
    assert int(n) == 1  # r2 grew 9x on the first trip: stop immediately
    assert np.all(np.isfinite(np.asarray(r)))

    # the multigrid loop has the same guard (monkeypatched diverging body)
    import waterlily_tpu.ops.multigrid as MG
    levels = build_levels(L)
    orig_v, orig_s = MG.vcycle, MG.smooth
    try:
        MG.vcycle = lambda lv, l, x, r: (x, r)
        MG.smooth = lambda lv, x, r, it=6: (x, 3.0 * r)
        x, r, n = ml_solve(levels, jnp.zeros(N, f32), z, itmx=50)
    finally:
        MG.vcycle, MG.smooth = orig_v, orig_s
    assert int(n) == 1
    assert np.all(np.isfinite(np.asarray(r)))
