"""Geometric multigrid over nested Poisson levels.

Re-design of src/MultiLevelPoisson.jl.  The level stack is static
at trace time (derived from the grid shape), the V-cycle recursion is
unrolled in Python, and restriction/prolongation are reshape-sum / repeat
ops that XLA lowers to cheap on-chip data movement.

Grid transfer index maps (reference :1-2, 0-based here):
- coarse interior cell ``c`` has fine children ``{2c-1, 2c}`` per axis;
- fine cell ``f`` maps down to coarse ``(f+1)//2``.

Level sizes: a level of ghost-padded size ``S`` coarsens to ``1 + S//2``
while every ``S`` is even and >4, with at most 10 coarsenings and at least
3 levels (reference :36-57, "size = a·2ⁿ, n>2").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..grid import interior_view, field_dot, pad_interior
from .bc import bc_vector, bc_scalar_periodic
from .poisson import make_level, residual, jacobi, smooth, increment

__all__ = ["n_levels", "coarse_shape", "restrict", "restrict_L", "prolongate",
           "build_levels", "update_levels", "vcycle", "ml_solve",
           "ml_solve_implicit"]

MAX_LEVELS = 10


def _divisible(s: int) -> bool:
    return s % 2 == 0 and s > 4


def coarse_shape(S: tuple) -> tuple:
    return tuple(1 + s // 2 for s in S)


def n_levels(S: tuple) -> int:
    """Static level count for ghost-padded shape S (reference :51-57)."""
    n = 1
    while all(_divisible(s) for s in S) and n <= MAX_LEVELS:
        S = coarse_shape(S)
        n += 1
    if n <= 2:
        raise ValueError(
            "MultiLevelPoisson requires interior size = a*2^n with n>2 "
            f"(got ghost-padded shape {S})")
    return n


def restrict(b: jax.Array, sharded: bool = False) -> jax.Array:
    """Sum-of-children restriction of a scalar (reference ``restrict``, :3-9).

    Fine interior (2M per axis) -> coarse interior (M per axis); coarse
    ghosts are zero (residuals live on the interior only).

    ``sharded`` selects a `reduce_window` form: a (2,…)-window stride-2 sum
    has an SPMD partitioning rule (halo exchange), whereas the reshape-sum
    on an unevenly-sharded axis forces GSPMD to all-gather that axis.
    """
    D = b.ndim
    S = b.shape
    v = interior_view(b, D)
    if sharded:
        r = jax.lax.reduce_window(v, b.dtype.type(0), jax.lax.add,
                                  (2,) * D, (2,) * D, "VALID")
        return pad_interior(r)
    for d in range(D):
        M = (S[d] - 2) // 2
        sh = v.shape[:d] + (M, 2) + v.shape[d + 1:]
        v = v.reshape(sh).sum(axis=d + 1)
    return pad_interior(v)


def restrict_L(L: jax.Array, perdir: tuple = (), sharded: bool = False) -> jax.Array:
    """Face-coefficient restriction (reference ``restrictL``, :10-16,26-32).

    Component ``i`` sums the 2^(D-1) transverse children of the lower child
    face and scales by 0.5; then the vector BC zeroes the wall-normal ghosts.
    ``sharded``: window (1 along i, 2 transverse) stride-2 `reduce_window`
    replaces the strided-slice + reshape-sum (see `restrict`).
    """
    D = L.shape[0]
    S = L.shape[1:]
    comps = []
    for i in range(D):
        v = interior_view(L[i], D)
        if sharded:
            w = tuple(1 if d == i else 2 for d in range(D))
            v = jax.lax.reduce_window(v, L.dtype.type(0), jax.lax.add,
                                      w, (2,) * D, "VALID")
        else:
            for d in range(D):
                M = (S[d] - 2) // 2
                if d == i:
                    # lower child only: fine interior indices 0,2,4,...
                    v = jax.lax.slice_in_dim(v, 0, 2 * M, stride=2, axis=d)
                else:
                    sh = v.shape[:d] + (M, 2) + v.shape[d + 1:]
                    v = v.reshape(sh).sum(axis=d + 1)
        comps.append(pad_interior(0.5 * v))
    a = jnp.stack(comps, axis=0)
    return bc_vector(a, (0.0,) * D, save_exit=False, perdir=perdir)


def prolongate(x_coarse: jax.Array, S_fine: tuple, sharded: bool = False) -> jax.Array:
    """Piecewise-constant injection coarse->fine (reference :34).

    Fine ghosts are zero — the correction ``ϵ`` is an interior field.
    ``sharded``: a stride-2 ones-kernel `conv_transpose` (SPMD-partitionable)
    replaces `jnp.repeat`, whose reshape lowering all-gathers uneven axes.
    """
    D = x_coarse.ndim
    v = interior_view(x_coarse, D)
    if sharded:
        k = jnp.ones((2,) * D + (1, 1), x_coarse.dtype)
        spatial = "DHW"[3 - D:]
        dn = ("N" + spatial + "C", spatial + "IO", "N" + spatial + "C")
        out = jax.lax.conv_transpose(v[None, ..., None], k, (2,) * D,
                                     "VALID", dimension_numbers=dn)
        return pad_interior(out[0, ..., 0])
    for d in range(D):
        v = jnp.repeat(v, 2, axis=d)
    return pad_interior(v)


def _band_ok(S, box_shape):
    """Banded dispatch pays only while the box is a small fraction of the
    level and its halo'd window fits."""
    import math
    return (all(b + 2 <= s for b, s in zip(box_shape, S))
            and 4 * math.prod(box_shape) <= math.prod(S))


def _coarsen_box(box_start, box_shape, S_coarse):
    """Map a band box down one level (fine cell f -> coarse (f+1)//2).

    The fine band lies in ``[start+2, ...]`` (one in-box margin cell below
    it); the coarse corner keeps that contract.  Shapes stay static.
    """
    shape_c = tuple(b // 2 + 4 for b in box_shape)
    lim = jnp.asarray([s - b - 2 for s, b in zip(S_coarse, shape_c)], jnp.int32)
    start_c = jnp.clip((box_start + 3) // 2 - 2, 0, lim)
    return start_c, shape_c


def build_levels(mu0: jax.Array, perdir: tuple = (), sharded: bool = False,
                 box_shape=None, box_start=None) -> tuple:
    """Build the static level stack from the fine face coefficients.

    The fine ``L`` *is* the BDIM zeroth moment ``μ₀`` (src/WaterLily.jl:77);
    each coarse ``L`` is its restriction (reference ``restrictML``, :18-25).
    ``sharded`` marks GSPMD layouts (SPMD-partitionable transfer forms).
    ``box_shape``/``box_start`` (the body band window) enable the banded
    sparse-coefficient operator on levels where it pays; the box coarsens
    with the grid.
    """
    S = mu0.shape[1:]
    nlev = n_levels(S)
    have_box = box_shape is not None and box_start is not None and not sharded
    if have_box:
        box_start = jnp.asarray(box_start, jnp.int32)
    levels = []
    L, c = mu0, 1.0
    for li in range(nlev):
        Sl = L.shape[1:]
        banded = have_box and _band_ok(Sl, box_shape)
        levels.append(make_level(L, perdir, sharded, banded=banded, c=c,
                                 box_shape=box_shape if banded else None,
                                 box_start=box_start if banded else None))
        if li == nlev - 1:
            break
        L = restrict_L(L, perdir, sharded)
        # restrict_L sums the 2^(D-1) transverse children and halves: the
        # far-field constant scales by 2^(D-2) per level (doubles in 3D,
        # stays 1 in 2D)
        c *= 2.0 ** (len(S) - 2)
        if have_box:
            box_start, box_shape = _coarsen_box(box_start, box_shape,
                                                L.shape[1:])
    return tuple(levels)


def update_levels(levels: tuple, mu0: jax.Array, box_start=None) -> tuple:
    """Re-restrict coefficients after body motion (reference ``update!``, :62-68)."""
    fine = levels[0]
    return build_levels(mu0, fine.perdir, fine.sharded,
                        fine.box_shape, box_start if box_start is not None
                        else fine.box_start)


def vcycle(levels: tuple, l: int, x, r):
    """One V-cycle from level ``l`` (reference ``Vcycle!``, :70-82):
    Jacobi pre-smooth, restrict residual, recurse, PCG-smooth coarse,
    prolongate and increment.  Unrolled over the static level stack."""
    fine, coarse = levels[l], levels[l + 1]
    x, r = jacobi(fine, x, r)
    rc = restrict(r, fine.sharded)
    xc = jnp.zeros_like(coarse.D)
    if l + 1 < len(levels) - 1:
        xc, rc = vcycle(levels, l + 1, xc, rc)
    xc, rc = smooth(coarse, xc, rc)
    eps = prolongate(xc, x.shape, fine.sharded)
    x, r = increment(fine, x, r, eps)
    return x, r


def ml_solve(levels: tuple, x, z, tol=1e-4, itmx=32, trace=False, fixed=None):
    """Multigrid pressure solve (reference ``solver!``, :87-99).

    V-cycle + fine-level PCG per outer iteration, at least one iteration,
    convergence test ``r·r < tol`` fully on device.  Returns ``(x, r, n)``,
    plus a ``(itmx+1, 2)`` array of per-iteration ``(r∞, r·r)`` rows when
    ``trace`` (the reference's ``@log`` pressure-solver observability,
    src/util.jl:4-24).

    ``fixed=k`` statically unrolls exactly ``k`` outer iterations instead of
    the `while_loop` — same math, but reverse-mode differentiable: `jax.grad`
    flows through the whole pressure solve (the reference is forward-mode
    only via ForwardDiff duals, maintests.jl:254-278; this is this
    build's beyond-parity differentiator).  The reference's own oracles show
    ≤2-3 iterations suffice, so small ``fixed`` matches the adaptive count.
    """
    fine = levels[0]
    if fine.mesh is not None:
        from ..parallel.shard_solve import can_shard_solve, shardmap_ml_solve
        if can_shard_solve(levels, trace):
            # the whole solve as ONE shard_map region (fine level local,
            # coarse levels replicated) — the multi-chip fast path
            return shardmap_ml_solve(levels, x, z, tol=tol, itmx=itmx,
                                     fixed=fixed)
    r = residual(fine, x, z)

    def log_row(r):
        return jnp.stack([jnp.max(jnp.abs(r)), field_dot(r, r)]).astype(x.dtype)

    if fixed is not None:
        tr = jnp.zeros((fixed + 1, 2), x.dtype)
        if trace:
            tr = tr.at[0].set(log_row(r))
        for k in range(fixed):
            x, r = vcycle(levels, 0, x, r)
            x, r = smooth(fine, x, r)
            if trace:
                tr = tr.at[k + 1].set(log_row(r))
        x = bc_scalar_periodic(x, fine.perdir)
        n = jnp.int32(fixed)
        return (x, r, n, tr) if trace else (x, r, n)

    tr = jnp.zeros((itmx + 1, 2), x.dtype)
    if trace:
        tr = tr.at[0].set(log_row(r))

    def cond(c):
        _, _, n, r2, stop, _ = c
        return (n == 0) | ((r2 >= tol) & (n < itmx) & ~stop)

    def body(c):
        x, r, n, r2p, _, tr = c
        x, r = vcycle(levels, 0, x, r)
        x, r = smooth(fine, x, r)
        r2 = field_dot(r, r)
        # divergence safeguard: a healthy outer iteration never doubles
        # r·r (floored solves bounce ≤1.2×; runaway smoothing jumps ≥49×).
        # Exiting here bounds the damage to one bad iteration instead of
        # amplifying to NaN over the remaining itmx trips when tol is
        # unattainable (e.g. a user-tightened tol below the f32 floor).
        stop = r2 > 2.0 * r2p
        if trace:
            tr = tr.at[n + 1].set(log_row(r))
        return (x, r, n + 1, r2, stop, tr)

    x, r, n, r2, _, tr = jax.lax.while_loop(
        cond, body, (x, r, jnp.int32(0), field_dot(r, r), False, tr))
    x = bc_scalar_periodic(x, fine.perdir)
    if trace:
        return x, r, n, tr
    return x, r, n


# --- implicit differentiation (adjoint pressure solve) -----------------------
#
# Reverse-mode AD through `ml_solve(fixed=k)` stores every smoother iterate
# of every level for the transpose — memory ∝ k·(V-cycle depth), prohibitive
# at 256³-class grids.  The implicit-function theorem needs none of that: at
# convergence the solution satisfies A(L)·x = P z (P = the residual's
# dead-cell mask + mean correction), so the cotangent of the *solution map*
# is one more Poisson solve with the SAME operator (A is symmetric) plus a
# vjp of the operator application:
#
#   λ = A⁻¹ P x̄          (the adjoint solve — reuses the multigrid stack)
#   z̄ = mask(λ)          (x* is exactly independent of z in dead cells)
#   (L̄, D̄) = ∂(−A·x*)ᵀ λ  (linear in L/D: one slice-stencil vjp pass)
#   x̄₀ = 0               (the warm start does not move a converged solve)
#
# The forward pass runs the normal adaptive `while_loop` solve — shard_map
# smoothers and all — because custom_vjp hides it from the transpose.  Gauge caveat: with immersed bodies the residual's mean
# correction makes the solution-map projector slightly non-symmetric (a
# rank-1 mean coupling); gradients of gauge-invariant outputs (anything
# built from ∇p or velocities — forces, KE, lift) are unaffected, which the
# FD oracles in tests/test_grad.py pin.


def _zeros_cotangent(tree):
    """A zero cotangent matching ``tree`` (float0 for integer leaves)."""
    import numpy as np

    def z(p):
        if jnp.issubdtype(jnp.result_type(p), jnp.inexact):
            return jnp.zeros_like(p)
        return np.zeros(jnp.shape(p), dtype=jax.dtypes.float0)

    return jax.tree_util.tree_map(z, tree)


def _implicit_solve(levels, x, z, tol, itmx):
    xs, _r, n = ml_solve(levels, x, z, tol=tol, itmx=itmx)
    return xs, n


def _implicit_fwd(levels, x, z, tol, itmx):
    xs, _r, n = ml_solve(levels, x, z, tol=tol, itmx=itmx)
    return (xs, n), (levels, xs)


def _implicit_bwd(tol, itmx, res, ct):
    from .poisson import _mult_interior_arrays
    levels, xs = res
    xbar, _nbar = ct
    fine = levels[0]
    D = xs.ndim
    # the solve returns its solution with periodic ghosts filled
    # (`bc_scalar_periodic`), and downstream stencils read them: fold the
    # ghost cotangents back onto their source interior cells (the transpose
    # of the ghost fill) before treating x̄ as an interior-dof cotangent.
    _, bcp_vjp = jax.vjp(lambda v: bc_scalar_periodic(v, fine.perdir), xs)
    (xbar,) = bcp_vjp(xbar)
    # adjoint solve: A symmetric, so the transposed system reuses the same
    # level stack; ml_solve's residual projects the RHS (mean correction +
    # dead mask) exactly as the primal solve does.  The RHS is normalized
    # first: ml_solve's stopping test is ABSOLUTE (r·r >= tol) while the
    # cotangent's scale follows the loss's — an unscaled solve would quit
    # after the single forced iteration whenever ||x̄||² < tol (silently
    # wrong gradients, and AD linearity grad(c·f) == c·grad(f) would break).
    s = jnp.sqrt(field_dot(xbar, xbar))
    safe = jnp.where(s > 0, s, 1.0).astype(xbar.dtype)
    lam, _r, _n = ml_solve(levels, jnp.zeros_like(xs), xbar / safe,
                           tol=tol, itmx=itmx)
    lam = jnp.where(s > 0, lam * safe, jnp.zeros_like(lam))
    lam_int = jnp.where(interior_view(fine.iD, D) == 0, 0.0,
                        interior_view(lam, D))
    zbar = pad_interior(lam_int)
    # operator cotangents: A(L,D)·x* is linear in (L, D); vjp of the dense
    # slice-form stencil (bitwise-equal to the banded form by the
    # dispatch invariants) against −λ.
    xb = bc_scalar_periodic(xs, fine.perdir)

    def _ax(Lf, Df):
        return _mult_interior_arrays(Lf, Df, xb)

    _, ax_vjp = jax.vjp(_ax, fine.L, fine.D)
    Lbar, Dbar = ax_vjp(-lam_int)
    lev_bar = _zeros_cotangent(levels)
    lev_bar = (lev_bar[0].replace(L=Lbar, D=Dbar),) + lev_bar[1:]
    return lev_bar, jnp.zeros_like(xs), zbar


_implicit_solve = jax.custom_vjp(_implicit_solve, nondiff_argnums=(3, 4))
_implicit_solve.defvjp(_implicit_fwd, _implicit_bwd)


def ml_solve_implicit(levels, x, z, tol=1e-4, itmx=32):
    """Multigrid pressure solve with implicit-differentiation gradients.

    Same primal as `ml_solve` (adaptive `while_loop`, same dispatch)
    but `jax.grad` costs ONE adjoint Poisson solve instead of transposing an
    unrolled solver — the memory-feasible reverse-AD path at scale (the
    `fixed=` unroll stores every smoother iterate).  Returns ``(x, n)``.

    Gradients assume a *converged* solve (use a tight ``tol`` when the loss
    is sensitive); forward-mode (`jax.jvp`) is not supported through this
    wrapper — use `fixed=`/the adaptive solve for jvp.  Beyond-parity: the
    reference is forward-mode only (maintests.jl:254-278).
    """
    return _implicit_solve(levels, x, z, float(tol), int(itmx))
