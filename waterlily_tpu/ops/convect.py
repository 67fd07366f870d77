"""Convection-diffusion fluxes in gather form, all-slice stencils.

Re-design of the reference's `conv_diff!` (src/Flow.jl:36-60).
The reference computes a face flux `Φ` and *scatters* `r[I]+=Φ; r[I-δ]-=Φ`.
Whole-array scatters serialize, so each direction sweep builds the whole
face-flux window with boundary variants selected by index masks, and the
momentum tendency is the gathered flux difference ``r = Φ - Φ(+δj)``.

Memory layout: the QUICK stencil reads up to two cells beyond the ghost
ring, so ``u`` is edge-padded by 2 ONCE per call; after that every shifted
read in all D sweeps is a pure slice of that one buffer, which XLA fuses
into single-pass loop fusions (rolls would materialise a copy per shift).

Flux-face layout along sweep axis j (0-based, ghost-padded size S):
face k carries the flux through the lower face of cell k, defined for
k = 1..S-1.  Cell tendencies live on k = 1..S-2:  ``r[k] = F[k] - F[k+1]``.
The reference's write support (cells 1..S-2 along j, 1..S-1 transverse —
src/util.jl:180 `low=2`) is realised by zero-padding the gathered window,
so no masks are needed for the scatter support at all.

Boundary variants (reference src/Flow.jl:6-9,54-60):
- interior face: QUICK upwind with median limiter;
- lower wall face (k=1): central difference for incoming (w>0) flux (ϕuL);
- upper wall face (k=S-1): central difference for incoming (w<0) flux (ϕuR);
- periodic: face k=1 wraps its far-upwind point to plane S-3 (ϕuP) and the
  top face flux is a copy of face 1's flux.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..grid import axis_coord

__all__ = ["quick", "vanleer", "median3", "conv_diff", "accelerate"]


def median3(a, b, c):
    """Median of three arrays, elementwise (reference `median`, src/Flow.jl:25)."""
    return jnp.maximum(jnp.minimum(a, b), jnp.minimum(jnp.maximum(a, b), c))


def quick(u, c, d):
    """QUICK upwind interpolation with median limiter (src/Flow.jl:4).

    ``u`` = far upwind, ``c`` = upwind, ``d`` = downwind value.
    """
    return median3((5.0 * c + 2.0 * d - u) / 6.0, c, median3(10.0 * c - 9.0 * u, c, d))


def vanleer(u, c, d):
    """van Leer flux limiter (src/Flow.jl:5), division-guarded for AD."""
    denom = jnp.where(d == u, 1.0, d - u)
    lim = c + (d - c) * (c - u) / denom
    keep = (c <= jnp.minimum(u, d)) | (c >= jnp.maximum(u, d))
    return jnp.where(keep, c, lim)


def conv_core(up, S_out: tuple, S_glob: tuple, base, nu, perdir: tuple,
              limiter, u_wrap=None, modular: bool = False) -> jax.Array:
    """Gather-form conv_diff tendency on a window of the global grid.

    ``up`` is the (component-lead) velocity window padded by 2 on every
    spatial axis; the output covers the unpadded ``S_out`` cells, whose
    global index along axis d is ``base[d] + local index`` (``base`` may be
    traced — the shard_map path derives it from `axis_index`).  The global
    path calls this with ``S_out == S_glob`` and ``base = 0``.  ``u_wrap``
    supplies the unpadded global array for periodic far-upwind wraps
    (global path).

    ``modular`` (shard_map path): ``up``'s pad planes hold MODULAR wrap
    values on periodic axes (`parallel.halo.halo_exchange` perdir= — global
    position ``-m`` ≡ interior plane ``S-2-m``, ``S-1+m`` ≡ ``1+m``) and
    the in-array ghost planes hold periodic copies, so periodic fluxes are
    the UNIFORM periodic formula with no index switches: the face-1
    far-upwind tap at position -1 IS plane S-3 (ϕuP), and the top face's
    flux evaluated from {S-3, S-2, S-1≡1, S≡2} is bitwise face 1's flux
    (identical values, identical expression — reference src/Flow.jl:7,60).
    """
    D = len(S_out)

    def cells(c, offs=None):
        """Component(s) ``c`` of ``u`` on the output cell grid, offset by
        ``offs[d]`` along axis d.  Pure slice of ``up`` (|off| <= 2)."""
        offs = offs or {}
        sl = tuple(slice(2 + offs.get(d, 0), 2 + S_out[d] + offs.get(d, 0))
                   for d in range(D))
        return up[(c,) + sl]

    A = slice(None)

    def gidx(d):
        k = axis_coord(S_out, d)
        return k if base is None else k + base[d]

    def face_flux(j, s, periodic):
        """Flux through face ``k+s`` of every cell ``k`` (s in {0,1}),
        for all momentum components, as an unmaterialised expression."""
        f = cells(A, {j: s})
        fm1 = cells(A, {j: s - 1})
        fm2 = cells(A, {j: s - 2})
        fp1 = cells(A, {j: s + 1})
        w = jnp.stack([0.5 * (cells(j, {j: s}) + cells(j, {j: s, i: -1}))
                       if i != j else 0.5 * (cells(j, {j: s}) + cells(j, {j: s - 1}))
                       for i in range(D)], axis=0)
        kf = gidx(j) + s   # global face index at each cell position
        cd = 0.5 * (f + fm1)
        if periodic and modular:
            # modular pad planes already hold the wrap values (see the
            # docstring): the plain periodic formula needs no switches
            pos = limiter(fm2, fm1, f)
            neg = limiter(fp1, f, fm1)
        elif periodic:
            # ϕuP: face 1's far-upwind point wraps to interior plane S-3
            wrap_sl = tuple(slice(S_glob[d] - 3, S_glob[d] - 2) if d == j
                            else slice(None) for d in range(D))
            fm2 = jnp.where(kf == 1, u_wrap[(A,) + wrap_sl], fm2)
            pos = limiter(fm2, fm1, f)
            neg = limiter(fp1, f, fm1)
        else:
            pos = jnp.where(kf == 1, cd, limiter(fm2, fm1, f))          # ϕuL
            neg = jnp.where(kf == S_glob[j] - 1, cd, limiter(fp1, f, fm1))  # ϕuR
        return jnp.where(w > 0, w * pos, w * neg) - nu * (f - fm1)

    r = jnp.zeros(up.shape[:1] + S_out, up.dtype)
    for j in range(D):
        periodic = j in perdir
        Fk = face_flux(j, 0, periodic)
        Fk1 = face_flux(j, 1, periodic)
        if periodic and not modular:
            # upperBoundary! Val{true}: the top face flux (face S-1, seen as
            # face k+1 of cell S-2) copies face 1's flux (Flow.jl:60).
            # The modular path needs no copy: Fk1 at cell S-2 already
            # evaluates the same expression on the same wrapped values.
            k = gidx(j)
            face1 = tuple(slice(1, 2) if d == j else slice(None)
                          for d in range(D))
            Fk1 = jnp.where(k + 1 == S_glob[j] - 1, Fk[(A,) + face1], Fk1)
        # reference write support: cells 1..S-2 along j, 1..S-1 transverse
        m = None
        for d in range(D):
            kd = gidx(d)
            md = (kd >= 1) & (kd <= S_glob[d] - 2) if d == j else (kd >= 1)
            m = md if m is None else m & md
        r = r + jnp.where(m, Fk - Fk1, 0.0)
    return r


def conv_diff(u: jax.Array, nu, perdir: tuple = (), limiter=quick,
              sharded: bool = False, mesh=None) -> jax.Array:
    """Momentum tendency r = -div(convective flux) + nu*laplacian, gather form.

    Faithful to reference `conv_diff!` (src/Flow.jl:36-51) including which
    ghost cells are (not) written: the returned array is zero wherever the
    reference never writes, so the BDIM first-moment stencil sees identical
    neighbour values.

    Performance shape: the flux expression is *inlined twice* (at face k and
    face k+1 of every cell) instead of materialising a face array — the
    whole tendency, all D sweeps included, becomes ONE elementwise fusion
    over slices of a single edge-padded buffer.  This doubles the limiter
    FLOPs but reads ``u`` once and writes ``r`` once.

    ``mesh``: sharded programs on an evenly-dividing mesh route through the
    explicit shard_map path (width-2 ppermute halos, per-shard compute).
    """
    D = u.shape[0]
    S = u.shape[1:]
    if sharded and mesh is not None:
        from ..parallel.shard_smooth import can_shardmap, shardmap_conv_diff
        if can_shardmap(mesh, S, perdir):
            return shardmap_conv_diff(mesh, u, nu, limiter, perdir=perdir)
    # single zero-padded buffer: every stencil read below is a slice of
    # this.  The pad planes are never *selected* (boundary faces take the
    # cd / periodic-wrap branches and the write mask clips the rest), so a
    # constant-0 pad replaces the original edge pad — GSPMD lowers it to
    # collective-permutes on evenly-sharded axes, while mode="edge"
    # (concatenated edge slices) all-gathers.
    up = jnp.pad(u, [(0, 0)] + [(2, 2)] * D)
    return conv_core(up, S, S, None, nu, perdir, limiter, u_wrap=u)


def accelerate(r: jax.Array, t, g, U, dtype) -> jax.Array:
    """Add uniform body-force + frame acceleration to every cell.

    Mirrors reference `accelerate!` (src/Flow.jl:68-73): ``g(i,t)`` plus
    ``dU_i/dt`` when the domain BC ``U`` is a time function (the reference
    uses ForwardDiff.derivative; here `jax.grad` of the scalar map).
    """
    D = r.shape[0]
    terms = []
    if g is None and not callable(U):
        return r
    for i in range(D):
        a = jnp.zeros((), dtype)
        if g is not None:
            a = a + g(i, t)
        if callable(U):
            a = a + jax.grad(lambda tau: jnp.asarray(U(i, tau), dtype))(jnp.asarray(t, dtype))
        terms.append(a)
    return r + jnp.stack(terms).reshape((D,) + (1,) * (r.ndim - 1)).astype(r.dtype)
