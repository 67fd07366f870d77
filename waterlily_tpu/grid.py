"""Staggered-grid index algebra and whole-array stencil primitives.

Whole-array replacement for the reference's per-cell kernel layer
(`/root/reference/src/util.jl:26-61,119-141`).  Instead of macro-generated
per-`CartesianIndex` kernels, every operation here is a pure function over
whole arrays that XLA fuses into a handful of device-memory passes.

Conventions (all 0-based):

- A *scalar* field has shape ``S = tuple(N_d + 2)`` — the physical interior
  ``N`` plus one ghost cell on each side (reference ``Ng = N .+ 2``,
  src/Flow.jl:113).
- A *vector* field has shape ``(D, *S)`` — component axis first so each
  component is a contiguous block.
- A *tensor* field (BDIM first moment) has shape ``(D, D, *S)`` with
  ``mu1[i, j]`` matching the reference's ``μ₁[I,i,j]``.
- The interior of a field is the slice ``[1:-1]`` along every spatial axis
  (reference `inside`, src/util.jl:47).
- The physical location of the center of cell ``I`` (0-based) is ``I - 0.5``;
  face ``i`` of that cell sits at ``I - 0.5 - 0.5*e_i`` (reference `loc`,
  src/util.jl:160 — shifted by the 1-based offset).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = [
    "shift", "plane", "interior", "interior_view", "set_interior",
    "axis_coord", "interior_mask", "mask_interior", "loc_grid", "l2", "linf",
    "apply_field", "interp", "inside_count", "band_box_start",
]


def shift(f: jax.Array, axis: int, off: int) -> jax.Array:
    """Return ``g`` with ``g[I] = f[I + off*e_axis]`` (circular wrap).

    Implemented with a roll so periodic directions are handled for free;
    for non-periodic uses the wrapped planes must be masked/overwritten by
    the caller (every caller in this package does).
    """
    if off == 0:
        return f
    return jnp.roll(f, -off, axis=axis)


def plane(ndim: int, axis: int, idx) -> tuple:
    """Index tuple selecting the hyperplane ``axis == idx`` of an ndim array."""
    return tuple(idx if a == axis else slice(None) for a in range(ndim))


def interior(ndim: int, off=None, lead: int = 0) -> tuple:
    """Index tuple for the interior ``[1:-1]`` of the ``ndim`` spatial axes.

    ``off`` optionally shifts the window by an integer per axis (used to read
    stencil neighbours of interior cells).  ``lead`` prepends full slices for
    leading (component) axes.
    """
    off = (0,) * ndim if off is None else off
    assert all(abs(o) <= 1 for o in off), (
        f"interior offset {off} exceeds the 1-cell ghost ring")
    return (slice(None),) * lead + tuple(
        slice(1 + o, None if (-1 + o) == 0 else -1 + o) for o in off
    )


def interior_view(a: jax.Array, D: int, off=None) -> jax.Array:
    """Interior of the trailing ``D`` spatial axes of ``a`` (any lead axes)."""
    return a[interior(D, off, lead=a.ndim - D)]


def set_interior(a: jax.Array, D: int, value) -> jax.Array:
    """Functional write of ``value`` into the interior of ``a``."""
    return a.at[interior(D, lead=a.ndim - D)].set(value)


def axis_coord(shape: tuple, axis: int, dtype=jnp.int32) -> jax.Array:
    """Broadcasted integer coordinate along ``axis`` (for boundary masks)."""
    return jax.lax.broadcasted_iota(dtype, shape, axis)


def interior_mask(S: tuple) -> jax.Array:
    """Boolean mask of the interior cells of a ghost-padded shape.

    Built from iotas so XLA folds it into consumers as computed values —
    ``where(interior_mask(S), expr, 0)`` fuses into one pass, unlike a
    slice-assignment which materialises a scatter/concat."""
    m = None
    for d in range(len(S)):
        k = axis_coord(S, d)
        md = (k >= 1) & (k <= S[d] - 2)
        m = md if m is None else m & md
    return m


def mask_interior(a: jax.Array, D: int | None = None) -> jax.Array:
    """Zero the ghost cells of ``a`` (trailing ``D`` spatial axes)."""
    D = a.ndim if D is None else D
    return jnp.where(interior_mask(a.shape[a.ndim - D:]), a, 0)


def inside_count(S: tuple) -> int:
    """Number of interior cells of a ghost-padded scalar shape."""
    return math.prod(s - 2 for s in S)


def field_dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """⟨a, b⟩ over whole (real) fields as multiply + reduce.

    Equivalent to ``jnp.vdot`` but without its flattening reshape: a reshape
    of a spatially-sharded field forces GSPMD to all-gather the uneven axes,
    while multiply+reduce partitions to a local reduction + all-reduce.
    """
    return jnp.sum(a * b)


def pad_interior(v: jax.Array, lead: int = 0) -> jax.Array:
    """Zero-ghost pad of an interior-shaped array.

    One canonical spelling for all ghost write-backs: on an *evenly*
    sharded axis (see `parallel.mesh.mesh_for`) GSPMD lowers this pad to
    boundary `collective-permute`s with zero all-gathers, whereas
    `dynamic_update_slice` / `.at[].set` (scatter) re-shard the update via
    all-gathers even when the sharding divides evenly.
    """
    D = v.ndim - lead
    return jnp.pad(v, [(0, 0)] * lead + [(1, 1)] * D)


def band_box_start(mask: jax.Array, box_shape: tuple) -> jax.Array:
    """Lower corner of a static-shape window covering the True cells of ``mask``.

    The window convention is: ``start`` addresses a ``box_shape + 2`` halo'd
    window whose *box* cells are ``[start+1, start+1+box_shape)`` per axis, so
    stencil reads of box cells stay inside the window.  The band is placed
    with one in-box margin cell below it (``start+2``) because the Poisson
    row of the cell *under* the band reads the band's face coefficient.
    ``start`` is clamped to keep the halo'd window in-bounds; the caller
    guarantees ``box_shape`` exceeds the band extent (chosen with margin at
    build time).  Empty masks give ``start = 0``.  Fully traceable
    (argmax + clip), so the box follows a moving body inside ``jit`` at zero
    host syncs.
    """
    D = mask.ndim
    starts = []
    for d in range(D):
        proj = jnp.any(mask, axis=tuple(i for i in range(D) if i != d))
        lo = jnp.argmax(proj)          # index of the first banded cell (0 if none)
        starts.append(jnp.clip(lo - 2, 0, mask.shape[d] - box_shape[d] - 2))
    return jnp.stack(starts).astype(jnp.int32)


def loc_grid(S: tuple, i: int | None, dtype=jnp.float32) -> jax.Array:
    """Physical coordinates of every cell of a ghost-padded grid.

    Returns shape ``(*S, D)``.  ``i=None`` gives cell centers
    (``x_d = I_d - 0.5``); ``i=d`` shifts component ``d`` to the lower face
    (extra ``-0.5``), matching reference ``loc(i,I)`` src/util.jl:160.
    """
    D = len(S)
    axes = []
    for d in range(D):
        c = jnp.arange(S[d], dtype=dtype) - 0.5
        if i == d:
            c = c - 0.5
        axes.append(c)
    mesh = jnp.meshgrid(*axes, indexing="ij")
    return jnp.stack(mesh, axis=-1)


def l2(a: jax.Array, D: int | None = None) -> jax.Array:
    """Squared L2 norm over the interior (reference ``L₂``, src/util.jl:68).

    Note the reference's ``L₂`` is the *squared* norm; tests and solver
    tolerances rely on that.
    """
    D = a.ndim if D is None else D
    v = interior_view(a, D)
    return jnp.sum(v * v)


def linf(a: jax.Array) -> jax.Array:
    """Max-abs over the full array (reference ``L∞``, src/Poisson.jl:147)."""
    return jnp.max(jnp.abs(a))


def apply_field(f, c_shape: tuple, dtype=jnp.float32, vector: bool | None = None):
    """Evaluate a pointwise field function onto a (ghost-padded) array.

    Mirrors reference ``apply!`` (src/util.jl:170-172): for a vector target
    (shape ``(D, *S)``) calls ``f(i, x)`` at the face-``i`` location of every
    cell; for a scalar target calls ``f(x)`` at cell centers.  ``f`` is
    vmapped over the grid, so it can be written point-wise like the
    reference's closures.
    """
    if vector is None:
        vector = False
    if vector:
        D, S = c_shape[0], c_shape[1:]
        comps = []
        for i in range(D):
            pts = loc_grid(S, i, dtype).reshape(-1, D)
            vals = jax.vmap(lambda x, i=i: f(i, x))(pts)
            comps.append(jnp.asarray(vals, dtype).reshape(S))
        return jnp.stack(comps, axis=0)
    S = c_shape
    D = len(S)
    pts = loc_grid(S, None, dtype).reshape(-1, D)
    vals = jax.vmap(f)(pts)
    return jnp.asarray(vals, dtype).reshape(S)


def _interp_scalar(coord: jax.Array, arr: jax.Array) -> jax.Array:
    """Multilinear interpolation of ``arr`` at 0-based index coordinate."""
    D = arr.ndim
    i = jnp.floor(coord).astype(jnp.int32)
    y = coord - i
    out = jnp.zeros((), arr.dtype)
    for corner in range(2 ** D):
        offs = jnp.array([(corner >> d) & 1 for d in range(D)])
        w = jnp.prod(jnp.where(offs == 0, 1.0 - y, y))
        idx = tuple(i[d] + offs[d] for d in range(D))
        out = out + arr[idx] * w.astype(arr.dtype)
    return out


def interp(x: jax.Array, arr: jax.Array, vector: bool = False) -> jax.Array:
    """Linear interpolation at *physical* position ``x``.

    Scalar fields are sampled at cell centers (physical ``I-0.5``); vector
    fields (shape ``(D,*S)``) sample each staggered component at its face
    location.  Mirrors reference ``interp`` (src/util.jl:238-257) with the
    coordinate measured in the frame of ``loc``.
    """
    if vector:
        D = arr.shape[0]
        comps = []
        for i in range(D):
            off = jnp.array([0.5 + (0.5 if j == i else 0.0) for j in range(D)],
                            dtype=x.dtype)
            comps.append(_interp_scalar(x + off, arr[i]))
        return jnp.stack(comps)
    return _interp_scalar(x + 0.5, arr)
