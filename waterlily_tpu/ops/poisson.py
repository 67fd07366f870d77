"""Matrix-free variable-coefficient Poisson operator and smoothers.

Re-design of the reference solver (src/Poisson.jl).  The linear
system is ``Ax = [L+D+L']x = z`` where ``L`` holds the face coefficients
(these *are* the BDIM zeroth moments — src/WaterLily.jl:77) and the diagonal
is derived: ``D[I] = -Σᵢ(L[I,i]+L[I+δᵢ,i])``.

Design notes, driven by XLA semantics:
- The reference's PCG exits early on degenerate ``rho``/``alpha``
  (src/Poisson.jl:127,132,137).  Data-dependent returns don't exist under
  `jit`, so the smoother carries a boolean ``dead`` flag and masks all state
  updates once tripped — same control flow, fixed trip count.
- Ghost-zeroing uses fused ``where(interior_mask, ., 0)`` forms, never
  slice assignments; every smoother iteration compiles to a handful of
  fused loop passes.  Residual/solution invariants: ``r``, ``z`` and all
  ``mult`` outputs are identically zero in ghost cells, so full-array
  `vdot`s equal the reference's interior dot products.
- All dot products stay on device; nothing syncs to the host.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..grid import (interior_view, mask_interior,
                    inside_count, field_dot, pad_interior)
from .bc import bc_scalar_periodic


def _off(D, i, v):
    return tuple(v if d == i else 0 for d in range(D))

__all__ = ["PoissonLevel", "make_level", "mult", "residual", "jacobi", "pcg",
           "smooth", "increment", "poisson_solve"]

def _static(default):
    """A dataclass field kept as static pytree metadata (part of the jit
    cache key, never traced)."""
    return dataclasses.field(default=default, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoissonLevel:
    """One multigrid level: face coefficients + derived (inverse) diagonal.

    ``sharded`` (static) marks spatially-decomposed layouts (it selects the
    SPMD-partitionable grid-transfer forms); ``perdir`` is static pytree
    metadata (it selects program structure).

    ``banded`` (static) selects the sparse immersed-boundary path: away from
    the body band the face coefficients are *exactly* the constant ``c``
    (2^level — μ₀ is exactly 1 outside the kernel band and restriction
    doubles it per level) with index-determined wall-face zeros, so the
    operator needs no coefficient reads at all except inside a small window
    (``box_shape`` static extents, ``box_start`` dynamic corner) that tracks
    the body.  Bitwise-identical to the dense path by construction."""
    L: jax.Array      # (D, *S) lower-diagonal face coefficients
    D: jax.Array      # (*S) diagonal, zero in ghosts
    iD: jax.Array     # (*S) guarded inverse diagonal (0 inside bodies)
    perdir: tuple = _static(())
    sharded: bool = _static(False)
    banded: bool = _static(False)
    # the device mesh for spatially-decomposed levels whose shape the mesh
    # divides evenly: routes the smoother through `parallel.shard_smooth`
    # (shard_map + ppermute halos + psum dots).  Set by
    # `parallel.mesh.constrain_levels`.
    mesh: object = _static(None)
    c: float = _static(1.0)
    box_shape: tuple | None = _static(None)
    box_start: jax.Array | None = None  # (D,) int32, dynamic

    def replace(self, **changes) -> "PoissonLevel":
        """A copy with ``changes`` applied (fields by name)."""
        return dataclasses.replace(self, **changes)


def _diag(L: jax.Array) -> jax.Array:
    """D[I] = -Σᵢ (L[I,i] + L[I+δᵢ,i]) on the interior (src/Poisson.jl:48-54).

    Ghost-padded grids make every stencil neighbour of an interior cell a
    valid array position, so all reads are pure slices — XLA fuses the whole
    expression into one pass (rolls would materialise shifted copies)."""
    D = L.shape[0]
    s = None
    for i in range(D):
        t = interior_view(L[i], D) + interior_view(L[i], D, _off(D, i, +1))
        s = t if s is None else s + t
    return pad_interior(-s)


def make_level(L: jax.Array, perdir: tuple = (), sharded: bool = False,
               banded: bool = False, c: float = 1.0, box_shape=None,
               box_start=None) -> PoissonLevel:
    """Build a level from face coefficients (reference ``set_diag!``)."""
    Dd = _diag(L)
    eps = jnp.finfo(L.dtype).eps
    guard = Dd * Dd < 2 * eps
    iD = jnp.where(guard, 0.0, 1.0 / jnp.where(guard, 1.0, Dd)).astype(L.dtype)
    if banded and box_shape is not None:
        box_start = jnp.asarray(box_start, jnp.int32)
    else:
        banded, box_shape, box_start = False, None, None
    return PoissonLevel(L=L, D=Dd, iD=iD, perdir=perdir, sharded=sharded,
                        banded=banded, c=float(c), box_shape=box_shape,
                        box_start=box_start)


def _mult_interior_arrays(L, Dd, x) -> jax.Array:
    """Interior of A·x from coefficient arrays (window or full grid)."""
    D = L.shape[0]
    s = interior_view(x, D) * interior_view(Dd, D)
    for i in range(D):
        lo, hi = _off(D, i, -1), _off(D, i, +1)
        s = (s + interior_view(x, D, lo) * interior_view(L[i], D)
             + interior_view(x, D, hi) * interior_view(L[i], D, hi))
    return s


def _mult_interior(lev: PoissonLevel, x: jax.Array) -> jax.Array:
    """Interior of A·x, all-slice form (caller handles periodic ghosts)."""
    return _mult_interior_arrays(lev.L, lev.D, x)


# --- banded (sparse immersed-boundary) operator -----------------------------
#
# Outside the body band μ₀ is exactly 1 and restriction exactly doubles it,
# so a level's far-field face coefficient is the constant ``c`` with zeros on
# non-periodic wall faces at index-determined positions, and the diagonal is
# the negated face count.  The expressions below reproduce the dense
# expression tree with those constants (bitwise-identical results) and then
# overwrite the body window with the true coefficient compute.


def _wall_coeffs(S, i, perdir, dtype, c):
    """(lower, upper) face-coefficient fields on the interior along axis i."""
    Si = tuple(s - 2 for s in S)
    cc = jnp.asarray(c, dtype)
    if i in perdir:
        return cc, cc
    k = jax.lax.broadcasted_iota(jnp.int32, Si, i)
    lo = jnp.where(k != 0, cc, 0).astype(dtype)
    hi = jnp.where(k != Si[i] - 1, cc, 0).astype(dtype)
    return lo, hi


def _ana_D_interior(S, perdir, dtype, c):
    """Interior of the far-field diagonal −Σ(face coeffs), dense add order."""
    s = None
    for i in range(len(S)):
        lo, hi = _wall_coeffs(S, i, perdir, dtype, c)
        t = lo + hi
        s = t if s is None else s + t
    return -s


def _win(lev: PoissonLevel, a: jax.Array, lead: int = 0):
    """Dynamic body-window slice (box + 1-cell halo per side)."""
    D = len(lev.box_shape)
    W = tuple(w + 2 for w in lev.box_shape)
    start = (jnp.int32(0),) * lead + tuple(lev.box_start[d] for d in range(D))
    return jax.lax.dynamic_slice(a, start, a.shape[:lead] + W)


def _box_update(lev: PoissonLevel, interior_field, box_values):
    """Overwrite the box cells of an interior-shaped field."""
    start = tuple(lev.box_start[d] for d in range(len(lev.box_shape)))
    return jax.lax.dynamic_update_slice(interior_field, box_values, start)


def _box_ax(lev: PoissonLevel, x: jax.Array) -> jax.Array:
    """True-coefficient A·x on the body window's box cells."""
    return _mult_interior_arrays(_win(lev, lev.L, 1), _win(lev, lev.D),
                                 _win(lev, x))


def _banded_mult_interior(lev: PoissonLevel, x: jax.Array) -> jax.Array:
    S = x.shape
    D = len(S)
    dt_ = x.dtype
    s = interior_view(x, D) * _ana_D_interior(S, lev.perdir, dt_, lev.c)
    for i in range(D):
        clo, chi = _wall_coeffs(S, i, lev.perdir, dt_, lev.c)
        s = (s + interior_view(x, D, _off(D, i, -1)) * clo
             + interior_view(x, D, _off(D, i, +1)) * chi)
    return _box_update(lev, s, _box_ax(lev, x))


def _banded_ax(lev: PoissonLevel, x: jax.Array) -> jax.Array:
    """Full-grid ghost-zero A·x for a banded level: the far-field constant
    expression with the true-coefficient body window written over it."""
    return pad_interior(_banded_mult_interior(lev, x))


def _rid(lev: PoissonLevel, r: jax.Array) -> jax.Array:
    """r * iD (the Jacobi-preconditioned residual), banded-aware.

    Far field: iD = 1/D with the analytic diagonal (no body guard needed —
    the guard only trips inside the body, which lies in the box)."""
    if not lev.banded:
        return r * lev.iD
    D = len(r.shape)
    iD_far = 1.0 / _ana_D_interior(r.shape, lev.perdir, r.dtype, lev.c)
    s = interior_view(r, D) * iD_far.astype(r.dtype)
    ew = interior_view(_win(lev, r), D) * interior_view(_win(lev, lev.iD), D)
    return pad_interior(_box_update(lev, s, ew))


def mult(lev: PoissonLevel, x: jax.Array) -> jax.Array:
    """z = A x with zero ghosts (reference ``mult!``, src/Poisson.jl:62-75)."""
    x = bc_scalar_periodic(x, lev.perdir)
    if lev.banded:
        return _banded_ax(lev, x)
    return pad_interior(_mult_interior(lev, x))


def residual(lev: PoissonLevel, x: jax.Array, z: jax.Array) -> jax.Array:
    """r = z - Ax, zeroed inside bodies and mean-corrected for solvability
    (reference ``residual!``, src/Poisson.jl:91-97)."""
    if lev.mesh is not None:
        from ..parallel.shard_smooth import shardmap_residual, can_shardmap
        if can_shardmap(lev.mesh, x.shape, lev.perdir):
            return shardmap_residual(lev, x, z)
    D = len(x.shape)
    xb = bc_scalar_periodic(x, lev.perdir)
    if lev.banded:
        ax = interior_view(_banded_ax(lev, xb), D)
        # the iD==0 dead-cell mask only trips inside the body (in the box)
        r_int = interior_view(z, D) - ax
        rw = jnp.where(interior_view(_win(lev, lev.iD), D) == 0, 0.0,
                       interior_view(_win(lev, z), D) - _box_ax(lev, xb))
        r_int = _box_update(lev, r_int, rw)
    else:
        r_int = jnp.where(interior_view(lev.iD, D) == 0, 0.0,
                          interior_view(z, D) - _mult_interior(lev, xb))
    s = jnp.sum(r_int) / inside_count(x.shape)
    eps = jnp.finfo(x.dtype).eps
    corr = jnp.where(jnp.abs(s) <= 2 * eps, 0.0, s).astype(x.dtype)
    return pad_interior(r_int - corr)


def increment(lev: PoissonLevel, x, r, eps):
    """Fused r -= A eps; x += eps on the interior (src/Poisson.jl:99-103).

    ``eps`` must be zero in (non-periodic) ghosts; ``mult`` output is
    ghost-zero so ``r`` stays ghost-zero.  Periodic-ghost pollution of ``x``
    is benign: every read of ``x`` ghosts goes through ``perBC`` first.
    """
    if lev.mesh is not None:
        from ..parallel.shard_smooth import shardmap_increment, can_shardmap
        if can_shardmap(lev.mesh, x.shape, lev.perdir):
            return shardmap_increment(lev, x, r, eps)
    ae = mult(lev, eps)
    return x + eps, r - ae


def pressure_grad_interior(lev: PoissonLevel, x: jax.Array) -> jax.Array:
    """Interior of the μ₀-weighted pressure gradient ``L∘∇x`` (stacked over
    components) used by the projection step (reference src/Flow.jl:141-143).
    Banded-aware: far-field L is the analytic wall-masked constant."""
    D = lev.L.shape[0]
    iv = lambda a, off=None: interior_view(a, D, off)
    if not lev.banded:
        return jnp.stack([iv(lev.L[i]) * (iv(x) - iv(x, _off(D, i, -1)))
                          for i in range(D)], axis=0)
    dt_ = x.dtype
    comps = []
    xw = _win(lev, x)
    Lw = _win(lev, lev.L, 1)
    for i in range(D):
        clo, _ = _wall_coeffs(x.shape, i, lev.perdir, dt_, lev.c)
        far = clo * (iv(x) - iv(x, _off(D, i, -1)))
        w = iv(Lw[i]) * (iv(xw) - iv(xw, _off(D, i, -1)))
        comps.append(_box_update(lev, far, w))
    return jnp.stack(comps, axis=0)


def jacobi(lev: PoissonLevel, x, r, it: int = 1):
    """Jacobi smoother (src/Poisson.jl:110-113); the MG pre-smoother.

    ``iD`` is ghost-zero, so ``eps = r*iD`` needs no explicit masking."""
    for _ in range(it):
        x, r = increment(lev, x, r, _rid(lev, r))
    return x, r


def pcg(lev: PoissonLevel, x, r, it: int = 6):
    """Jacobi-preconditioned conjugate gradient smoother.

    Faithful port of src/Poisson.jl:123-143 with the early exits
    (|rho|<10eps before start, alpha outside [1e-2,1e2], |rho2|<10eps)
    expressed as a monotone ``dead`` mask so the trip count is static.
    """
    dt = x.dtype
    teneps = 10 * jnp.finfo(dt).eps

    z = _rid(lev, r)
    eps = z
    rho = field_dot(r, z)
    dead = jnp.abs(rho) < teneps

    for i in range(it):
        eps = bc_scalar_periodic(eps, lev.perdir)
        with jax.named_scope("pcg_matvec"):   # read by chip_trace.py
            z = mult(lev, eps)
            denom = field_dot(z, eps)
        alpha = jnp.where(dead | (denom == 0), 0.0,
                          rho / jnp.where(denom == 0, 1.0, denom)).astype(dt)
        dead = dead | (jnp.abs(alpha) < 1e-2) | (jnp.abs(alpha) > 1e2)
        upd = jnp.where(dead, 0.0, alpha).astype(dt)
        x = x + upd * eps
        r = r - upd * z
        if i == it - 1:
            break
        z2 = _rid(lev, r)
        rho2 = field_dot(r, z2)
        dead = dead | (jnp.abs(rho2) < teneps)
        beta = jnp.where(dead, 0.0, rho2 / jnp.where(rho == 0, 1.0, rho)).astype(dt)
        # no full-array freeze of eps/z is needed once dead: the scalar
        # ``upd`` guard already freezes x and r (the only outputs), beta=0
        # keeps eps finite, and z is overwritten by mult next iteration —
        # dropping the selects saves a whole pass per iteration.
        eps = mask_interior(beta * eps + z2)
        rho = jnp.where(dead, rho, rho2)
    return x, r


def smooth(lev: PoissonLevel, x, r, it: int = 6):
    """Default smoother (reference ``smooth! = pcg!``).  Sharded levels with
    an evenly-dividing mesh route through the shard_map + ppermute
    explicit-collective smoother — the multi-chip fast path."""
    if lev.mesh is not None:
        from ..parallel.shard_smooth import shardmap_pcg, can_shardmap
        if can_shardmap(lev.mesh, x.shape, lev.perdir):
            return shardmap_pcg(lev, x, r, it)
    return pcg(lev, x, r, it)


def poisson_solve(lev: PoissonLevel, x, z, tol=1e-4, itmx=1000, smoother=smooth):
    """Single-level iterative solve (reference ``solver!``, src/Poisson.jl:162-172).

    Runs at least one smoothing pass (the reference's loop tests the
    tolerance only *after* smoothing), with an on-device `while_loop`.
    Returns ``(x, r, n_iters)``.
    """
    r = residual(lev, x, z)

    def cond(c):
        x, r, n, r2, stop = c
        return (n == 0) | ((r2 >= tol) & (n < itmx) & ~stop)

    def body(c):
        x, r, n, r2p, _ = c
        x, r = smoother(lev, x, r)
        r2 = field_dot(r, r)
        # divergence safeguard (see ml_solve): exit when an iteration
        # doubles r·r instead of amplifying to NaN when tol is unattainable
        return (x, r, n + 1, r2, r2 > 2.0 * r2p)

    x, r, n, r2, _ = jax.lax.while_loop(
        cond, body, (x, r, jnp.int32(0), field_dot(r, r), False))
    x = bc_scalar_periodic(x, lev.perdir)
    return x, r, n
