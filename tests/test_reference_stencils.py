"""The XLA stencil forms against an independent NumPy float64 transcription
of the reference's per-cell loops.

Each ``ref_*`` function below walks the cells the way the reference's
``@loop``/``@inside`` kernels do (0-based indices on the ghost-padded grid
of size ``S``), in float64, with no code shared with the package:

- ``mult``, ``residual!``, ``increment!``, ``pcg!``   src/Poisson.jl:62-143
- ``conv_diff!`` with its boundary building blocks   src/Flow.jl:4-60
- ``div``, the ``project!`` update, ``CFL``           src/Flow.jl:11-17,137-182
- ``BC!``, ``exitBC!``, ``perBC!``                    src/util.jl:192-231

Interiors are anisotropic and not powers of two.  Tolerances: results are
compared in the package's dtype — float64 to 1e-12 relative (only the
summation order differs), float32 to 2e-5 relative to the field's scale
(f32 rounding of a few dozen operations).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from waterlily_tpu.ops.bc import bc_vector, bc_scalar_periodic, exit_bc
from waterlily_tpu.ops.convect import conv_diff, quick, vanleer
from waterlily_tpu.ops.poisson import (make_level, mult, residual, increment,
                                       pcg, pressure_grad_interior)
from waterlily_tpu.flow import div, cfl

SHAPES = [(10, 14), (18, 12), (10, 12, 14), (8, 18, 10)]
DTYPES = [np.float32, np.float64]
TOL = {np.float32: 2e-5, np.float64: 1e-12}


def _cells(S, lo=1, hi_off=1):
    """Index tuples of the interior (``inside``) of a padded shape."""
    return itertools.product(*[range(lo, s - hi_off) for s in S])


def _d(D, i, v=1):
    return tuple(v if k == i else 0 for k in range(D))


def _add(I, o):
    return tuple(a + b for a, b in zip(I, o))


def _close(got, want, dtype):
    got = np.asarray(got, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * scale)


# --- reference transcriptions -----------------------------------------------

def ref_per_fill(a, perdir):
    """perBC!: ghost plane 0 := plane S-2, ghost plane S-1 := plane 1."""
    a = np.array(a, np.float64)
    for j in perdir:
        n = a.shape[j]
        idx = [slice(None)] * a.ndim
        src = list(idx)
        idx[j], src[j] = 0, n - 2
        a[tuple(idx)] = a[tuple(src)]
        idx[j], src[j] = n - 1, 1
        a[tuple(idx)] = a[tuple(src)]
    return a


def ref_diag(L):
    D = L.shape[0]
    S = L.shape[1:]
    Dd = np.zeros(S)
    for I in _cells(S):
        Dd[I] = -sum(L[i][I] + L[i][_add(I, _d(D, i))] for i in range(D))
    return Dd


def ref_iD(Dd, dtype):
    eps = np.finfo(dtype).eps
    return np.where(Dd * Dd < 2 * eps, 0.0,
                    1.0 / np.where(Dd * Dd < 2 * eps, 1.0, Dd))


def ref_mult(L, Dd, x, perdir=()):
    """z[I] = D[I]x[I] + Σᵢ L[I,i]x[I-δᵢ] + L[I+δᵢ,i]x[I+δᵢ] on the inside."""
    D = L.shape[0]
    x = ref_per_fill(x, perdir)
    z = np.zeros(x.shape)
    for I in _cells(x.shape):
        s = Dd[I] * x[I]
        for i in range(D):
            dn, up = _add(I, _d(D, i, -1)), _add(I, _d(D, i))
            s += L[i][I] * x[dn] + L[i][up] * x[up]
        z[I] = s
    return z


def ref_residual(L, Dd, iD, x, z, dtype, perdir=()):
    ax = ref_mult(L, Dd, x, perdir)
    r = np.zeros(x.shape)
    cells = list(_cells(x.shape))
    for I in cells:
        r[I] = 0.0 if iD[I] == 0 else z[I] - ax[I]
    s = sum(r[I] for I in cells) / len(cells)
    if abs(s) > 2 * np.finfo(dtype).eps:
        for I in cells:
            r[I] -= s
    return r


def ref_increment(L, Dd, x, r, eps, perdir=()):
    ae = ref_mult(L, Dd, eps, perdir)
    x, r = np.array(x, np.float64), np.array(r, np.float64)
    for I in _cells(x.shape):
        r[I] -= ae[I]
        x[I] += eps[I]
    return x, r


def ref_pcg(L, Dd, iD, x, r, dtype, perdir=(), it=6):
    """pcg! with its early exits (Poisson.jl:123-143)."""
    x, r = np.array(x, np.float64), np.array(r, np.float64)
    cells = list(_cells(x.shape))
    teneps = 10 * np.finfo(dtype).eps
    dot = lambda a, b: sum(a[I] * b[I] for I in cells)
    eps = np.zeros(x.shape)
    z = np.zeros(x.shape)
    for I in cells:
        z[I] = eps[I] = r[I] * iD[I]
    rho = dot(r, z)
    if abs(rho) < teneps:
        return x, r
    for i in range(1, it + 1):
        eps = ref_per_fill(eps, perdir)
        z = ref_mult(L, Dd, eps)
        alpha = rho / dot(z, eps)
        if abs(alpha) < 1e-2 or abs(alpha) > 1e2:
            return x, r
        for I in cells:
            x[I] += alpha * eps[I]
            r[I] -= alpha * z[I]
        if i == it:
            return x, r
        for I in cells:
            z[I] = r[I] * iD[I]
        rho2 = dot(r, z)
        if abs(rho2) < teneps:
            return x, r
        beta = rho2 / rho
        for I in cells:
            eps[I] = beta * eps[I] + z[I]
        rho = rho2
    return x, r


def _median(a, b, c):
    return max(min(a, b), min(max(a, b), c))


def ref_quick(u, c, d):
    return _median((5 * c + 2 * d - u) / 6, c, _median(10 * c - 9 * u, c, d))


def ref_vanleer(u, c, d):
    if c <= min(u, d) or c >= max(u, d):
        return c
    return c + (d - c) * (c - u) / (d - u)


def ref_conv_diff(u, nu, perdir, lam):
    """conv_diff! (Flow.jl:36-60) with its lower/upper boundary blocks:
    face k along j carries the flux between cells k-1 and k."""
    n = u.shape[0]
    S = u.shape[1:]
    r = np.zeros(u.shape)
    for i in range(n):
        f = u[i]
        for j in range(n):
            dj = lambda I, v: _add(I, _d(n, j, v))

            def w(I):           # ϕ(i, CI(I,j), u)
                return 0.5 * (u[j][I] + u[j][_add(I, _d(n, i, -1))])

            def phiu(I, wv):    # ϕu
                if wv > 0:
                    return wv * lam(f[dj(I, -2)], f[dj(I, -1)], f[I])
                return wv * lam(f[dj(I, 1)], f[I], f[dj(I, -1)])

            def cd(I, wv):
                return wv * 0.5 * (f[I] + f[dj(I, -1)])

            def diff(I):
                return nu * (f[I] - f[dj(I, -1)])

            # transverse support 1..S-1, faces along j as listed
            def faces(k):
                rng = [range(1, S[d]) if d != j else [k] for d in range(n)]
                return itertools.product(*rng)

            face1 = {}
            for I in faces(1):                       # lowerBoundary!
                wv = w(I)
                if j in perdir:
                    Ip = tuple(S[j] - 3 if d == j else I[d] for d in range(n))
                    if wv > 0:
                        phi = wv * lam(f[Ip], f[dj(I, -1)], f[I])
                    else:
                        phi = phiu(I, wv)
                    face1[I] = phi - diff(I)
                    r[i][I] += face1[I]
                else:
                    phi = cd(I, wv) if wv > 0 else phiu(I, wv)
                    r[i][I] += phi - diff(I)
            for k in range(2, S[j] - 1):             # inner faces
                for I in faces(k):
                    Phi = phiu(I, w(I)) - diff(I)
                    r[i][I] += Phi
                    r[i][dj(I, -1)] -= Phi
            for I in faces(S[j] - 1):                # upperBoundary!
                if j in perdir:
                    I1 = tuple(1 if d == j else I[d] for d in range(n))
                    r[i][dj(I, -1)] -= face1[I1]
                else:
                    wv = w(I)               # ϕuR: upwind from below if wv ≥ 0
                    phi = cd(I, wv) if wv < 0 else wv * lam(
                        f[dj(I, -2)], f[dj(I, -1)], f[I])
                    r[i][dj(I, -1)] += -phi + diff(I)
    return r


def ref_bc_vector(u, A, save_exit, perdir):
    """BC! (util.jl:192-210): component-major, direction-minor."""
    u = np.array(u, np.float64)
    n = u.shape[0]
    S = u.shape[1:]

    def pl(i, j, k):
        return (i,) + tuple(k if d == j else slice(None) for d in range(n))

    for i in range(n):
        for j in range(n):
            N = S[j]
            if j in perdir:
                u[pl(i, j, 0)] = u[pl(i, j, N - 2)]
                u[pl(i, j, N - 1)] = u[pl(i, j, 1)]
            elif i == j:
                u[pl(i, j, 0)] = A[i]
                u[pl(i, j, 1)] = A[i]
                if not save_exit or i > 0:
                    u[pl(i, j, N - 1)] = A[i]
            else:
                u[pl(i, j, 0)] = u[pl(i, j, 1)]
                u[pl(i, j, N - 1)] = u[pl(i, j, N - 2)]
    return u


def ref_exit_bc(u, u0, U, dt):
    """exitBC! (util.jl:216-222) on the exit slice x=S-1, transverse inside."""
    u = np.array(u, np.float64)
    S = u.shape[1:]
    n = len(S)
    exit_cells = [(S[0] - 1,) + J for J in _cells(S[1:])]
    for I in exit_cells:
        Im = _add(I, _d(n, 0, -1))
        u[0][I] = u0[0][I] - U[0] * dt * (u0[0][I] - u0[0][Im])
    flux = sum(u[0][I] for I in exit_cells) / len(exit_cells) - U[0]
    for I in exit_cells:
        u[0][I] -= flux
    return u


def ref_div(u):
    n = u.shape[0]
    s = np.zeros(u.shape[1:])
    for I in _cells(s.shape):
        s[I] = sum(u[i][_add(I, _d(n, i))] - u[i][I] for i in range(n))
    return s


def ref_project_update(L, x, u):
    """The project! tail: u[I,i] -= L[I,i]·(x[I]-x[I-δᵢ]) on the inside."""
    u = np.array(u, np.float64)
    n = u.shape[0]
    for I in _cells(x.shape):
        for i in range(n):
            u[i][I] -= L[i][I] * (x[I] - x[_add(I, _d(n, i, -1))])
    return u


def ref_cfl(u, nu, dt_max=10.0):
    n = u.shape[0]
    mx = max(sum(max(0.0, u[i][_add(I, _d(n, i))]) + max(0.0, -u[i][I])
                 for i in range(n)) for I in _cells(u.shape[1:]))
    return min(dt_max, 1.0 / (mx + 5 * nu))


# --- inputs -------------------------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _coeffs(S, dtype, perdir=(), seed=0, dead=True):
    """Positive face coefficients with wall-normal ghost zeros (the vector
    BC of μ₀) and, optionally, a dead (all-zero) cell block."""
    D = len(S)
    L = 0.5 + 0.5 * _rng(seed).random((D,) + S)
    L = ref_bc_vector(L, (0.0,) * D, False, perdir)
    if dead:
        blk = tuple(slice(2, 4) for _ in range(D))
        for i in range(D):
            L[(i,) + blk] = 0.0
            L[(i,) + tuple(slice(b.start + (k == i), b.stop + (k == i))
                           for k, b in enumerate(blk))] = 0.0
    return L.astype(dtype)


def _ghost_zero(a):
    out = np.zeros_like(a)
    sl = tuple(slice(1, -1) for _ in range(a.ndim))
    out[sl] = a[sl]
    return out


def _level(L, perdir):
    return make_level(jnp.asarray(L), perdir)


# --- tests --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("perdir", [(), "all"])
@pytest.mark.parametrize("S", SHAPES)
def test_mult_matches_reference(S, perdir, dtype):
    perdir = tuple(range(len(S))) if perdir == "all" else perdir
    L = _coeffs(S, dtype, perdir)
    x = _rng(1).standard_normal(S).astype(dtype)
    lev = _level(L, perdir)
    Dd = ref_diag(L.astype(np.float64))
    _close(lev.D, Dd, dtype)
    _close(lev.iD, ref_iD(Dd, dtype), dtype)
    z = jax.jit(mult)(lev, jnp.asarray(x))
    _close(z, ref_mult(L.astype(np.float64), Dd, x, perdir), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHAPES)
def test_residual_matches_reference(S, dtype):
    L = _coeffs(S, dtype)
    x = _rng(2).standard_normal(S).astype(dtype)
    z = _ghost_zero(_rng(3).standard_normal(S)).astype(dtype)
    lev = _level(L, ())
    Dd = ref_diag(L.astype(np.float64))
    r = jax.jit(residual)(lev, jnp.asarray(x), jnp.asarray(z))
    _close(r, ref_residual(L.astype(np.float64), Dd, ref_iD(Dd, dtype), x, z,
                           dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHAPES)
def test_increment_matches_reference(S, dtype):
    L = _coeffs(S, dtype)
    x = _rng(4).standard_normal(S).astype(dtype)
    r = _ghost_zero(_rng(5).standard_normal(S)).astype(dtype)
    eps = _ghost_zero(_rng(6).standard_normal(S)).astype(dtype)
    lev = _level(L, ())
    xn, rn = jax.jit(increment)(lev, jnp.asarray(x), jnp.asarray(r),
                                jnp.asarray(eps))
    xr, rr = ref_increment(L.astype(np.float64), ref_diag(L.astype(np.float64)),
                           x, r, eps)
    _close(xn, xr, dtype)
    _close(rn, rr, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,perdir", [((18, 18), ()), ((10, 14), (1,)),
                                          ((10, 10, 10), ())])
def test_pcg_matches_reference(shape, perdir, dtype):
    """Six PCG iterations from a residual, early exits included."""
    D = len(shape)
    L = _coeffs(shape, dtype, perdir, seed=7, dead=False)
    z = (0.1 * _rng(8).standard_normal(shape)).astype(dtype)
    lev = _level(L, perdir)
    x0 = np.zeros(shape, dtype)
    r = np.asarray(residual(lev, jnp.asarray(x0), jnp.asarray(z)))
    xs, rs = jax.jit(pcg)(lev, jnp.asarray(x0), jnp.asarray(r))
    Dd = ref_diag(L.astype(np.float64))
    xr, rr = ref_pcg(L.astype(np.float64), Dd, ref_iD(Dd, dtype), x0,
                     r.astype(np.float64), dtype, perdir)
    inner = (slice(1, -1),) * D
    _close(np.asarray(xs)[inner], xr[inner], dtype)
    _close(np.asarray(rs)[inner], rr[inner], dtype)


def test_pcg_exits_on_degenerate_rho():
    """|rho| < 10eps before the first iteration: x and r are returned as is
    (a zero residual is the degenerate case)."""
    L = _coeffs((10, 12), np.float64, dead=False)
    lev = _level(L, ())
    x = jnp.asarray(_rng(9).standard_normal((10, 12)))
    r = jnp.zeros((10, 12))
    xs, rs = pcg(lev, x, r)
    assert np.array_equal(np.asarray(xs), np.asarray(x))
    assert np.array_equal(np.asarray(rs), np.asarray(r))


_CONV_CASES = ([(S, lim, p, np.float64) for S in SHAPES
                for lim in ("quick", "vanleer") for p in ((), "all")]
               + [((10, 12, 14), "quick", p, np.float64)
                  for p in ((0,), (1,), (2,), (0, 2))]
               + [(S, "quick", (), np.float32) for S in SHAPES])


@pytest.mark.parametrize("S,limiter,perdir,dtype", _CONV_CASES)
def test_conv_diff_matches_reference(S, limiter, perdir, dtype):
    D = len(S)
    perdir = tuple(range(D)) if perdir == "all" else perdir
    u = _rng(10).standard_normal((D,) + S)
    # the step's contract: ghosts are BC-filled before conv_diff reads them
    u = ref_bc_vector(u, (0.3,) + (0.0,) * (D - 1), False, perdir)
    u = u.astype(dtype)
    lam_x, lam_r = {"quick": (quick, ref_quick),
                    "vanleer": (vanleer, ref_vanleer)}[limiter]
    r = jax.jit(lambda u: conv_diff(u, 0.05, perdir, lam_x))(jnp.asarray(u))
    _close(r, ref_conv_diff(u.astype(np.float64), 0.05, perdir, lam_r), dtype)


@pytest.mark.parametrize("save_exit", [False, True])
@pytest.mark.parametrize("perdir", [(), (1,), (0, 2), "all"])
@pytest.mark.parametrize("S", SHAPES)
def test_bc_vector_matches_reference(S, perdir, save_exit):
    D = len(S)
    perdir = tuple(range(D)) if perdir == "all" else tuple(
        p for p in perdir if p < D)
    u = _rng(11).standard_normal((D,) + S).astype(np.float32)
    A = tuple(0.25 * i + 1.0 for i in range(D))
    got = jax.jit(lambda u: bc_vector(u, A, save_exit, perdir))(
        jnp.asarray(u))
    want = ref_bc_vector(u.astype(np.float64), A, save_exit, perdir)
    assert np.array_equal(np.asarray(got, np.float64), want)


@pytest.mark.parametrize("S", SHAPES)
def test_exit_bc_matches_reference(S):
    D = len(S)
    u = _rng(12).standard_normal((D,) + S)
    u0 = _rng(13).standard_normal((D,) + S)
    U = (1.0,) + (0.0,) * (D - 1)
    got = jax.jit(lambda u, u0: exit_bc(u, u0, U, 0.3))(jnp.asarray(u),
                                                          jnp.asarray(u0))
    _close(got, ref_exit_bc(u, u0, U, 0.3), np.float64)


@pytest.mark.parametrize("perdir", [(0,), "all"])
@pytest.mark.parametrize("S", SHAPES)
def test_periodic_fill_matches_reference(S, perdir):
    perdir = tuple(range(len(S))) if perdir == "all" else perdir
    a = _rng(14).standard_normal(S)
    got = bc_scalar_periodic(jnp.asarray(a), perdir)
    assert np.array_equal(np.asarray(got), ref_per_fill(a, perdir))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHAPES)
def test_div_matches_reference(S, dtype):
    u = _rng(15).standard_normal((len(S),) + S).astype(dtype)
    _close(jax.jit(div)(jnp.asarray(u)), ref_div(u.astype(np.float64)),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHAPES)
def test_projection_update_matches_reference(S, dtype):
    from waterlily_tpu.grid import pad_interior
    D = len(S)
    L = _coeffs(S, dtype)
    x = _rng(16).standard_normal(S).astype(dtype)
    u = _rng(17).standard_normal((D,) + S).astype(dtype)
    lev = _level(L, ())

    def update(lev, x, u):
        return u - pad_interior(pressure_grad_interior(lev, x), lead=1)

    got = jax.jit(update)(lev, jnp.asarray(x), jnp.asarray(u))
    _close(got, ref_project_update(L.astype(np.float64), x, u), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHAPES)
def test_cfl_matches_reference(S, dtype):
    u = _rng(18).standard_normal((len(S),) + S).astype(dtype)
    got = float(jax.jit(lambda u: cfl(u, 0.01))(jnp.asarray(u)))
    want = ref_cfl(u.astype(np.float64), 0.01)
    assert abs(got - want) <= TOL[dtype] * want
