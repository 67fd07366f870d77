"""Spatial domain decomposition tests on the virtual 8-device CPU mesh.

The sharded step must (a) compile and execute under GSPMD and (b) produce
bitwise/close results to the single-device step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from waterlily_tpu.flow import FlowConfig, flow_init, mom_step
from waterlily_tpu.ops.multigrid import build_levels
from waterlily_tpu.parallel.mesh import make_mesh, sharded_step_fn

f32 = jnp.float32


def test_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    mesh2 = make_mesh(8, axes=("x", "y"))
    assert mesh2.devices.size == 8 and len(mesh2.axis_names) == 2


@pytest.mark.parametrize("axes,perdir", [(("x",), ()), (("x", "y"), ()),
                                         (("x",), (0, 1))])
def test_sharded_step_matches_single(axes, perdir):
    # 34² keeps the GSPMD compiles cheap; the (2,4) mesh still exercises
    # uneven 4-way sharding of the padded axis
    cfg = FlowConfig(D=2, S=(34, 34), U=(1.0, 0.0), nu=0.01, dtype=f32,
                     perdir=perdir)

    def ulam(i, x):
        return jnp.where(i == 0, 1.0 + 0.05 * jnp.sin(x[1] / 4), 0.0)

    state = flow_init(cfg, ulam)
    levels = build_levels(state.mu0, perdir)

    ref, aux_ref = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)

    mesh = make_mesh(8, axes=axes)
    step = sharded_step_fn(cfg, mesh)
    out, aux = step(state, levels)

    assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-5)
    assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-4)
    assert int(aux["pois_n"][0]) == int(aux_ref["pois_n"][0])


def test_sharded_scan_fn_matches_single():
    """Multi-step `lax.scan` under GSPMD (`sharded_scan_fn`) tracks the
    single-device trajectory step-for-step."""
    from waterlily_tpu.parallel.mesh import sharded_scan_fn
    cfg = FlowConfig(D=2, S=(34, 34), U=(1.0, 0.0), nu=0.05, dtype=f32)

    def ulam(i, x):
        return jnp.where(i == 0, 1.0 + 0.1 * jnp.sin(x[1] / 3), 0.0)

    state = flow_init(cfg, ulam)
    levels = build_levels(state.mu0)

    ref = state
    step = jax.jit(lambda s, l: mom_step(cfg, l, s))
    pois_ref = []
    for _ in range(5):
        ref, aux = step(ref, levels)
        pois_ref.append(np.asarray(aux["pois_n"]))

    mesh = make_mesh(8, axes=("x", "y"))
    out, pois = sharded_scan_fn(cfg, mesh)(state, levels, 5)
    assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-4)
    assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-3)
    assert np.array_equal(np.stack(pois_ref), np.asarray(pois))


def test_sharded_exitbc_matches_single():
    """exitBC's convective outlet + global mass-flux mean is a reduction over
    one shard-boundary plane — it must agree under spatial decomposition."""
    cfg = FlowConfig(D=2, S=(66, 34), U=(1.0, 0.0), nu=0.02, dtype=f32,
                     exitBC=True)

    def ulam(i, x):
        return jnp.where(i == 0, 1.0 + 0.1 * jnp.cos(x[1] / 5), 0.0)

    state = flow_init(cfg, ulam)
    levels = build_levels(state.mu0)
    ref, _ = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)

    for axes in [("x",), ("x", "y")]:
        mesh = make_mesh(8, axes=axes)
        out, _ = sharded_step_fn(cfg, mesh)(state, levels)
        assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-5)
        assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-4)


def test_sharded_grid_transfers_match_dense():
    """The SPMD-friendly reduce_window/conv_transpose grid transfers equal
    the reshape/repeat forms exactly (same sums, same order per output)."""
    from waterlily_tpu.ops.multigrid import restrict, restrict_L, prolongate
    key = jax.random.PRNGKey(0)
    for S in [(34, 18), (18, 10, 10)]:
        D = len(S)
        b = jax.random.normal(key, S, jnp.float32)
        # summation order inside the 2^D child sums may differ -> ulp noise
        assert np.allclose(np.asarray(restrict(b)),
                           np.asarray(restrict(b, sharded=True)),
                           rtol=1e-5, atol=1e-6)
        L = jax.random.normal(key, (D,) + S, jnp.float32)
        assert np.allclose(np.asarray(restrict_L(L)),
                           np.asarray(restrict_L(L, sharded=True)),
                           rtol=1e-5, atol=1e-6)
        xc = jax.random.normal(key, tuple(1 + s // 2 for s in S), jnp.float32)
        assert np.allclose(np.asarray(prolongate(xc, S)),
                           np.asarray(prolongate(xc, S, sharded=True)),
                           atol=0)


def test_mesh_for_divides_axes():
    """mesh_for only shards axes it divides evenly; remainder replicates."""
    from waterlily_tpu.parallel.mesh import mesh_for
    m = mesh_for((34, 34, 34), 8)
    assert dict(zip(m.axis_names, m.devices.shape)) == {"x": 2, "y": 2, "z": 2}
    m = mesh_for((66, 34), 8)   # 66 % 2 == 0, 34 % 2 == 0, remainder 2 -> "r"
    assert dict(zip(m.axis_names, m.devices.shape)) == {"x": 2, "y": 2, "r": 2}
    m = mesh_for((36, 34), 8)   # 36 % 4 == 0 -> x gets 4
    assert dict(zip(m.axis_names, m.devices.shape)) == {"x": 4, "y": 2}


@pytest.mark.parametrize("S,axes", [
    ((32, 32), None),            # mesh_for -> single 8-way axis
    ((16, 32), ("x", "y")),      # 2-axis (2,4) mesh
    ((26, 18, 18), None),        # mesh_for -> (2,2,2): 3 sharded axes
])
def test_shardmap_mult_matches_dense(S, axes):
    """The explicit shard_map + ppermute halo-exchange operator equals the
    dense Poisson mult (the source-visible alternative to the GSPMD path) —
    including multi-axis meshes (corner propagation + per-axis offsets)."""
    from waterlily_tpu.parallel.halo import shardmap_mult
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.ops.poisson import make_level, mult
    key = jax.random.PRNGKey(3)
    D = len(S)
    L = jnp.abs(jax.random.normal(key, (D,) + S, f32))
    lev = make_level(L)
    x = jax.random.normal(key, S, f32)
    z_ref = mult(lev, x)
    mesh = mesh_for(S, 8) if axes is None else make_mesh(8, axes=axes)
    if axes is None and len(S) == 3:
        assert len([n for n in mesh.axis_names if n != "r"]) == 3
    z = shardmap_mult(mesh, lev.L, lev.D, x)
    assert np.allclose(np.asarray(z_ref), np.asarray(z), atol=1e-5)


def test_replica_axis_mesh_matches_single():
    """A mesh with a non-dividing remainder gets a replica axis "r" that is
    never assigned to a spatial dim; the step still matches single-device."""
    from waterlily_tpu.parallel.mesh import mesh_for
    cfg = FlowConfig(D=2, S=(66, 34), U=(1.0, 0.0), nu=0.02, dtype=f32)

    def ulam(i, x):
        return jnp.where(i == 0, 1.0 + 0.1 * jnp.sin(x[1] / 5), 0.0)

    state = flow_init(cfg, ulam)
    levels = build_levels(state.mu0)
    ref, _ = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)

    mesh = mesh_for(cfg.S, 8)
    assert "r" in mesh.axis_names
    out, _ = sharded_step_fn(cfg, mesh)(state, levels)
    assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-5)


def test_sharded_hlo_halos_are_collective_permute():
    """The GSPMD claims, verified on ONE compiled HLO (a single 34³ sharded
    step — compiling it twice would double the heaviest fixture in this
    file): (a) with an evenly-dividing mesh (`mesh_for`), stencil halos and
    ghost write-backs lower to `collective-permute`; the only all-gathers
    are the (tiny) coarse-level replications — a full-field `all-gather` is
    the silent-slowness failure mode of a bad layout; and (b) the total
    collective-permute BYTES stay within a small multiple of the analytic
    halo traffic, so a layout regression that doubles halo exchanges
    (without resorting to a gather) still fails loudly."""
    import re
    from waterlily_tpu.parallel.mesh import mesh_for
    cfg = FlowConfig(D=3, S=(34, 34, 34), U=(1.0, 0.0, 0.0), nu=0.01,
                     dtype=f32)
    state = flow_init(cfg)
    levels = build_levels(state.mu0)
    mesh = mesh_for(cfg.S, 8)
    step = sharded_step_fn(cfg, mesh)
    hlo = step.lower(state, levels).compile().as_text()

    assert "collective-permute" in hlo, "no halo exchange found in HLO"

    # every all-gather must be far smaller than a fine-level field (the
    # legitimate ones replicate coarse multigrid levels): full-field gathers
    # would defeat the spatial decomposition
    field_bytes = 4 * 34 ** 3
    sizes = [int(np.prod([int(d) for d in m.group(1).split(",") if d]))
             for m in re.finditer(r"= f32\[([0-9,]*)\][^ ]* all-gather", hlo)]
    assert all(4 * s < field_bytes / 2 for s in sizes), (
        f"large all-gather outputs found: {sorted(sizes)[-8:]}")

    # per-shard bytes moved by collective-permutes (each op lists its
    # output shape; bytes = 4 * prod(dims))
    cp_bytes = 0
    for m in re.finditer(r"= f32\[([0-9,]*)\][^\n]*collective-permute", hlo):
        dims = [int(d) for d in m.group(1).split(",") if d]
        cp_bytes += 4 * int(np.prod(dims)) if dims else 4
    # Empirical pin: this program currently exchanges ~4.7 MB of planes
    # per shard-step (smoother matvecs + the ghost write-backs GSPMD emits
    # for every pad).  The bound gives ~50% headroom — a layout change
    # that doubles halo traffic (the silent-slowness failure mode the
    # all-gather check above cannot see) fails here.
    budget = 7_000_000
    assert cp_bytes < budget, (
        f"collective-permute bytes {cp_bytes} exceed budget {budget}: "
        "halo traffic regressed")


def test_simulation_mesh_kwarg_matches_single_device():
    """The production GSPMD path — Simulation(mesh=...) — on a 3D sphere with
    per-step remeasure (build_levels under sharding) vs the unsharded sim."""
    from waterlily_tpu.models.cases import sphere_3d
    mesh = make_mesh(8, axes=("x", "y"))
    sim_s = sphere_3d(n=24, m=16, dtype=f32, mesh=mesh)
    sim_r = sphere_3d(n=24, m=16, dtype=f32)
    assert sim_s.cfg.sharded and all(l.sharded for l in sim_s.levels)
    sim_s.steps(3, remeasure=True)
    sim_r.steps(3, remeasure=True)
    assert np.allclose(np.asarray(sim_s.flow.u), np.asarray(sim_r.flow.u),
                       atol=1e-5)
    assert np.allclose(np.asarray(sim_s.flow.p), np.asarray(sim_r.flow.p),
                       atol=1e-4)
    assert [list(r) for r in sim_s.pois_n] == [list(r) for r in sim_r.pois_n]


@pytest.mark.parametrize("S", [(32, 32), (16, 32, 32)])
def test_shardmap_pcg_matches_dense(S):
    """The shard_map + ppermute PCG smoother (the multi-chip fast path,
    ops.poisson.smooth dispatch) equals the dense smoother up to the
    psum partial-sum reduction order."""
    from waterlily_tpu.parallel.shard_smooth import shardmap_pcg, can_shardmap
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.ops.poisson import make_level, pcg, residual
    key = jax.random.PRNGKey(5)
    D = len(S)
    L = jnp.abs(jax.random.normal(key, (D,) + S, f32)) * 0.2 + 0.5
    lev = make_level(L)
    x = jnp.zeros(S, f32)
    z = jax.random.normal(key, S, f32) * 1e-2
    r = residual(lev, x, z)
    x_ref, r_ref = jax.jit(lambda l, x, r: pcg(l, x, r))(lev, x, r)

    mesh = mesh_for(S, 8)
    assert can_shardmap(mesh, S, ())
    lev_s = lev.replace(mesh=mesh, sharded=True)
    x_s, r_s = jax.jit(lambda l, x, r: shardmap_pcg(l, x, r))(lev_s, x, r)
    assert np.allclose(np.asarray(x_ref), np.asarray(x_s), atol=1e-6)
    assert np.allclose(np.asarray(r_ref), np.asarray(r_s), atol=1e-6)


@pytest.mark.parametrize("S", [(32, 32), (16, 16, 32)])
def test_shardmap_increment_residual_match_dense(S):
    """The shard_map increment (jacobi/V-cycle fine stencils) and residual
    (body-masked + psum mean correction) equal the dense forms — the
    remaining fine-level smoother-ladder phases of the multi-chip fast
    path."""
    from waterlily_tpu.parallel.shard_smooth import can_shardmap
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.ops.poisson import make_level, increment, residual
    from waterlily_tpu.grid import mask_interior
    key = jax.random.PRNGKey(11)
    D = len(S)
    L = jnp.abs(jax.random.normal(key, (D,) + S, f32)) * 0.2 + 0.5
    # a dead-cell block exercises the iD==0 mask in residual
    L = L.at[(0,) + tuple(slice(4, 8) for _ in range(D))].set(0.0)
    lev = make_level(L)
    mesh = mesh_for(S, 8)
    assert can_shardmap(mesh, S, ())
    lev_s = lev.replace(mesh=mesh, sharded=True)

    x = jax.random.normal(jax.random.PRNGKey(12), S, f32)
    z = mask_interior(jax.random.normal(jax.random.PRNGKey(13), S, f32))
    r_ref = jax.jit(lambda l, x, z: residual(l, x, z))(lev, x, z)
    r_s = jax.jit(lambda l, x, z: residual(l, x, z))(lev_s, x, z)
    assert np.allclose(np.asarray(r_ref), np.asarray(r_s), atol=1e-5)

    eps = mask_interior(jax.random.normal(jax.random.PRNGKey(14), S, f32))
    x1, r1 = jax.jit(lambda l, x, r, e: increment(l, x, r, e))(
        lev, x, r_ref, eps)
    x1s, r1s = jax.jit(lambda l, x, r, e: increment(l, x, r, e))(
        lev_s, x, r_s, eps)
    assert np.allclose(np.asarray(x1), np.asarray(x1s), atol=1e-6)
    assert np.allclose(np.asarray(r1), np.asarray(r1s), atol=1e-5)


def test_sharded_smoother_dispatch_via_step(monkeypatch):
    """A sharded step on an evenly-dividing mesh routes its smoother through
    the shard_map fast path and still matches the single-device step."""
    from waterlily_tpu.parallel import mesh as pmesh
    from waterlily_tpu.parallel.mesh import mesh_for, constrain_levels
    # force shard_map routing below the production region-budget threshold
    monkeypatch.setattr(pmesh, "SHARDMAP_MIN_CELLS", 0)
    cfg = FlowConfig(D=3, S=(18, 18, 18), U=(1.0, 0.0, 0.0), nu=0.01,
                     dtype=f32)
    state = flow_init(cfg)
    levels = build_levels(state.mu0)
    ref, aux_ref = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)
    mesh = mesh_for(cfg.S, 8)
    with mesh:
        levs = jax.jit(lambda l: constrain_levels(l, mesh))(levels)
    assert any(l.mesh is not None for l in levs)
    step = sharded_step_fn(cfg, mesh)
    out, aux = step(state, levels)
    assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-5)
    assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-4)
    assert int(aux["pois_n"][0]) == int(aux_ref["pois_n"][0])


@pytest.mark.parametrize("S", [(32, 32), (16, 16, 32)])
def test_shardmap_conv_diff_matches_dense(S):
    """conv_diff with explicit width-2 ppermute halos equals the dense
    gather-form tendency (QUICK reads I-2δ — the 2-cell halo case)."""
    from waterlily_tpu.parallel.shard_smooth import shardmap_conv_diff
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.ops.convect import conv_diff, quick
    key = jax.random.PRNGKey(7)
    D = len(S)
    u = jax.random.normal(key, (D,) + S, f32)
    r_ref = jax.jit(lambda u: conv_diff(u, 0.01, (), quick, False))(u)
    mesh = mesh_for(S, 8)
    r_s = jax.jit(lambda u: shardmap_conv_diff(mesh, u, 0.01, quick))(u)
    assert np.allclose(np.asarray(r_ref), np.asarray(r_s), atol=1e-5)


def test_implicit_diff_grad_under_mesh_matches_single():
    """Reverse-mode jax.grad through a SHARDED step via the implicit-diff
    adjoint (custom_vjp around the adaptive solve) matches the
    single-device gradient — multi-chip differentiability, beyond both the
    reference's ForwardDiff scope (maintests.jl:254-278) and its
    single-device limit (README.md:157).  One step keeps the reverse-AD
    trace cost down; the multi-step adjoint is pinned in test_grad."""
    from waterlily_tpu.parallel.mesh import (mesh_for, constrain_state,
                                             constrain_levels)
    from waterlily_tpu.metrics import ke

    f64 = jnp.float64
    L = 16
    kappa = 2 * np.pi / L

    def ulam(i, x):
        return jnp.where(i == 0,
                         -jnp.sin(kappa * x[0]) * jnp.cos(kappa * x[1]),
                         jnp.cos(kappa * x[0]) * jnp.sin(kappa * x[1]))

    def ke_after(nu, mesh=None):
        cfg = FlowConfig(D=2, S=(L + 2, L + 2), nu=nu, U=(0.0, 0.0),
                         perdir=(0, 1), dtype=f64, tol=1e-12, itmx=64,
                         implicit_diff=True, sharded=mesh is not None,
                         mesh=mesh)
        state = flow_init(cfg, ulam)
        levels = build_levels(state.mu0, cfg.perdir)
        if mesh is not None:
            state = constrain_state(state, mesh)
            levels = constrain_levels(levels, mesh)

        def body(s, _):
            s, _aux = mom_step(cfg, levels, s)
            return s, None

        state, _ = jax.lax.scan(body, state, None, length=1)
        return jnp.sum(ke(state.u))

    nu0 = 1.0 / (kappa * 100.0)
    g1 = float(jax.grad(ke_after)(jnp.asarray(nu0, f64)))
    mesh = mesh_for((L + 2, L + 2), 8)
    g8 = float(jax.jit(jax.grad(lambda nu: ke_after(nu, mesh)))(
        jnp.asarray(nu0, f64)))
    # iterative solves under a different reduction order: the adjoint is
    # exact only at convergence, so agreement is tol-limited, not bitwise
    assert np.isfinite(g8) and abs(g8) > 1.0
    assert np.isclose(g1, g8, rtol=1e-6), (g1, g8)

def test_shard_solve_restrict_prolongate_exact():
    """The one-region solve's transfers vs the dense forms: restriction is
    BITWISE the dense reshape-sum (each coarse cell is one shard's dense-
    order pair sum + psum'd zeros); prolongation is an exact copy."""
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.parallel.halo import spatial_specs
    from waterlily_tpu.parallel.shard_solve import (restrict_replicated,
                                                    prolongate_local)
    from waterlily_tpu.ops.multigrid import restrict, prolongate
    from waterlily_tpu.grid import mask_interior
    from jax.sharding import PartitionSpec as P

    for S in [(18, 18, 18), (34, 18, 18), (18, 10)]:
        D = len(S)
        mesh = mesh_for(S, 8)
        sc, _vec = spatial_specs(mesh, D)
        r = mask_interior(jax.random.normal(jax.random.PRNGKey(3), S, f32))
        rc_ref = restrict(r)

        fn = jax.shard_map(lambda r_l: restrict_replicated(mesh, S, r_l),
                             mesh=mesh, in_specs=(sc,), out_specs=P(),
                             check_vma=False)
        rc = jax.jit(fn)(r)
        assert np.array_equal(np.asarray(rc_ref), np.asarray(rc)), S

        Sc = rc_ref.shape
        xc = mask_interior(jax.random.normal(jax.random.PRNGKey(4), Sc, f32))
        eps_ref = prolongate(xc, S)
        pf = jax.shard_map(lambda xc_r: prolongate_local(mesh, S, xc_r),
                             mesh=mesh, in_specs=(P(),), out_specs=sc,
                             check_vma=False)
        eps = jax.jit(pf)(xc)
        assert np.array_equal(np.asarray(eps_ref), np.asarray(eps)), S


def test_shard_solve_matches_dense():
    """shardmap_ml_solve (ONE region: local fine stencils + replicated
    coarse) vs the dense ml_solve: same iteration count, matching fields
    (dots differ only by psum association)."""
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.parallel.shard_solve import shardmap_ml_solve
    from waterlily_tpu.ops.multigrid import ml_solve
    from waterlily_tpu.flow import div
    from waterlily_tpu.grid import mask_interior

    cfg = FlowConfig(D=3, S=(18, 18, 18), U=(1.0, 0.0, 0.0), nu=0.01,
                     dtype=f32)
    state = flow_init(cfg)
    levels = build_levels(state.mu0)
    z = jax.jit(div)(state.u)
    x0 = 0.25 * mask_interior(
        jax.random.normal(jax.random.PRNGKey(5), cfg.S, f32))
    x_ref, r_ref, n_ref = jax.jit(
        lambda l, x, z: ml_solve(l, x, z))(levels, x0, z)

    mesh = mesh_for(cfg.S, 8)
    levs = tuple(l.replace(mesh=mesh, sharded=True) for l in levels)
    x_s, r_s, n_s = jax.jit(
        lambda l, x, z: shardmap_ml_solve(l, x, z))(levs, x0, z)
    assert int(n_s) == int(n_ref)
    assert np.allclose(np.asarray(x_ref), np.asarray(x_s), atol=1e-5)
    assert np.allclose(np.asarray(r_ref), np.asarray(r_s), atol=1e-5)

    # fixed-iteration unroll path
    x_f, r_f, n_f = jax.jit(
        lambda l, x, z: shardmap_ml_solve(l, x, z, fixed=2))(levs, x0, z)
    x_fr, r_fr, n_fr = jax.jit(
        lambda l, x, z: ml_solve(l, x, z, fixed=2))(levels, x0, z)
    assert int(n_f) == 2 and int(n_fr) == 2
    assert np.allclose(np.asarray(x_fr), np.asarray(x_f), atol=1e-5)


def test_shard_solve_dispatch_from_step():
    """A sharded step whose fine level carries the mesh routes its pressure
    solves through the one-region shardmap_ml_solve and matches the dense
    step (pois_n equal)."""
    from waterlily_tpu.parallel import mesh as pmesh
    from waterlily_tpu.parallel.mesh import mesh_for
    cfg = FlowConfig(D=3, S=(18, 18, 18), U=(1.0, 0.0, 0.0), nu=0.01,
                     dtype=f32)
    state = flow_init(cfg)
    levels = build_levels(state.mu0)
    ref, aux_ref = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)
    old = pmesh.SHARDMAP_MIN_CELLS
    try:
        pmesh.SHARDMAP_MIN_CELLS = 0
        mesh = mesh_for(cfg.S, 8)
        step = sharded_step_fn(cfg, mesh)
        out, aux = step(state, levels)
    finally:
        pmesh.SHARDMAP_MIN_CELLS = old
    assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-5)
    assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-4)
    assert list(map(int, aux["pois_n"])) == list(map(int, aux_ref["pois_n"]))


def test_bc_vector_local_bitwise():
    """bc_vector_local (global-index where-selects inside shard_map) is
    bitwise-equal to the reference-ordered DUS chain, save_exit included."""
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.parallel.halo import spatial_specs
    from waterlily_tpu.parallel.shard_step import bc_vector_local
    from waterlily_tpu.ops.bc import bc_vector
    for S, save_exit in [((18, 10, 10), False), ((18, 10, 10), True),
                         ((16, 32), False)]:
        D = len(S)
        u = jax.random.normal(jax.random.PRNGKey(9), (D,) + S, f32)
        A = tuple(0.25 * i + 1.0 for i in range(D))
        ref = bc_vector(u, A, save_exit=save_exit)
        mesh = mesh_for(S, 8)
        sc, vec = spatial_specs(mesh, D)
        fn = jax.shard_map(
            lambda u_l: bc_vector_local(mesh, S, u_l, A, save_exit),
            mesh=mesh, in_specs=(vec,), out_specs=vec, check_vma=False)
        out = jax.jit(fn)(u)
        assert np.array_equal(np.asarray(ref), np.asarray(out)), (S, save_exit)


def test_shard_step_region_matches_dense():
    """The ONE-region whole step (shardmap_mom_step) matches the dense
    mom_step — velocity, pressure, dt, pois_n — including exitBC."""
    from waterlily_tpu.parallel.mesh import mesh_for, constrain_levels
    from waterlily_tpu.parallel import mesh as pmesh
    from waterlily_tpu.parallel.shard_step import (shardmap_mom_step,
                                                   can_shard_step)

    for kw in (dict(), dict(exitBC=True)):
        cfg = FlowConfig(D=3, S=(18, 18, 18), U=(1.0, 0.0, 0.0), nu=0.01,
                         dtype=f32, **kw)

        def ulam(i, x):
            return jnp.where(i == 0, 1.0 + 0.05 * jnp.sin(x[1] / 3), 0.0)

        state = flow_init(cfg, ulam)
        levels = build_levels(state.mu0)
        ref, aux_ref = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)

        mesh = mesh_for(cfg.S, 8)
        from waterlily_tpu.parallel import shard_step as sstep
        old = pmesh.SHARDMAP_MIN_CELLS
        old_flag = sstep.WHOLE_STEP_REGION
        try:
            pmesh.SHARDMAP_MIN_CELLS = 0
            sstep.WHOLE_STEP_REGION = True  # default-off: see shard_step.py
            levs = tuple(l.replace(mesh=mesh, sharded=True) for l in levels)
            assert can_shard_step(cfg._replace(sharded=True), levs)
            out, aux = jax.jit(
                lambda s, l: shardmap_mom_step(cfg._replace(sharded=True),
                                               l, s))(state, levs)
        finally:
            pmesh.SHARDMAP_MIN_CELLS = old
            sstep.WHOLE_STEP_REGION = old_flag
        assert np.allclose(np.asarray(ref.u), np.asarray(out.u),
                           atol=1e-5), kw
        assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-4)
        assert np.isclose(float(ref.dt), float(out.dt), rtol=1e-6)
        assert list(map(int, aux["pois_n"])) == \
            list(map(int, aux_ref["pois_n"])), kw


@pytest.mark.skipif(__import__("os").environ.get("WATERLILY_NIGHTLY") != "1",
                    reason="512^3 AOT compile: nightly tier (several minutes)")
def test_512cubed_sharded_step_compiles_aot():
    """Scale pin: the 512³ sharded step COMPILES (AOT, no execution) on the
    8-device virtual mesh with per-shard live-buffer bytes inside 16 GiB,
    and its HLO contains no full-field all-gather — a check of the scale
    the multi-chip design exists for that needs no devices."""
    from waterlily_tpu.parallel.mesh import (mesh_for, state_specs,
                                             constrain_levels)
    from waterlily_tpu.parallel.mesh import mom_step_auto
    import re

    N = 512
    cfg = FlowConfig(D=3, S=(N + 2,) * 3, U=(1.0, 0.0, 0.0), nu=1e-4,
                     dtype=jnp.float32, sharded=True)
    mesh = mesh_for(cfg.S, 8)
    cfg = cfg._replace(mesh=mesh)

    def step(state, levels):
        from waterlily_tpu.parallel.mesh import constrain_state
        state = constrain_state(state, mesh)
        levels = constrain_levels(levels, mesh)
        new, aux = mom_step_auto(cfg, levels, state)
        return constrain_state(new, mesh), aux["pois_n"]

    # abstract inputs: never materialize 512³ arrays on the CI box
    from waterlily_tpu.flow import FlowState
    S = cfg.S
    f = jax.ShapeDtypeStruct
    state = FlowState(
        u=f((3,) + S, jnp.float32), p=f(S, jnp.float32),
        V=f((3,) + S, jnp.float32), mu0=f((3,) + S, jnp.float32),
        mu1=f((3, 3) + S, jnp.float32), dt=f((), jnp.float32),
        t=f((), jnp.float32), bbox=f((3,), jnp.int32))
    from waterlily_tpu.ops.multigrid import n_levels, coarse_shape
    from waterlily_tpu.ops.poisson import PoissonLevel
    levels = []
    Sl = S
    for _ in range(n_levels(S)):
        levels.append(PoissonLevel(
            L=f((3,) + Sl, jnp.float32), D=f(Sl, jnp.float32),
            iD=f(Sl, jnp.float32)))
        Sl = coarse_shape(Sl)
    lowered = jax.jit(step).lower(state, tuple(levels))
    compiled = lowered.compile()

    # per-shard live bytes within 16 GiB; the state alone is
    # 19 fields x 512^3 x 4B / 8 shards ~ 1.3 GB
    mem = compiled.memory_analysis()
    per_shard = int(getattr(mem, "temp_size_in_bytes", 0)) + \
        int(getattr(mem, "argument_size_in_bytes", 0)) + \
        int(getattr(mem, "output_size_in_bytes", 0))
    assert per_shard < 16 * 2 ** 30, f"{per_shard/2**30:.2f} GiB per shard"

    # no FINE-level all-gathers: any all-gather's output must stay well
    # below a full fine-level field (514^3 x 4B = 543 MB).  The design's
    # one intentional gather is the coarse replication at the solve-region
    # boundary: at 512^3 the first coarse level is 258^3, so its face-
    # coefficient stack (3x258^3 x 4B = 206 MB) is the ceiling — the cost
    # of the replicated-coarse simplification, bounded at 8 devices
    # (coarse work is 1/8 of fine per 3D coarsening); a SHARDED first
    # coarse level (aligned sharded->sharded transfers) is the next
    # scaling step beyond this mesh size.
    hlo = compiled.as_text()
    cap = 210 * 2 ** 20
    total = 0
    for m in re.finditer(r"all-gather[^=]*=\s*\S*?f32\[([0-9,]+)\]", hlo):
        dims = [int(d) for d in m.group(1).split(",") if d]
        byts = 4 * int(np.prod(dims))
        total += byts
        assert byts < cap, f"all-gather of {byts/2**20:.0f} MB in 512^3 HLO"
    # bounded TOTAL: two solve-region entries replicate the coarse level
    # stacks (~400 MB each at 512^3); a growing total is a gather-per-op
    # regression
    assert total < 1200 * 2 ** 20, \
        f"{total/2**20:.0f} MB gathered per 512^3 step"


def test_sharded_moving_body_banded_measure():
    """Sharded moving bodies keep the narrow-band remeasure: under
    a mesh the window fields are built replicated
    and resharded by the step's constraints — no dense D+1-grid autodiff
    sweep.  The sharded heaving-sphere step must match the unsharded one
    and must route through measure_fields_banded."""
    from waterlily_tpu.models.cases import heaving_sphere_3d
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu import body as body_mod
    from waterlily_tpu import simulation as sim_mod

    # radius 12 in the 48³ domain keeps the band window under the
    # max_frac=0.5 gate (smaller bodies decline banding)
    kw = dict(radius=12, amp=4, Re=100, dtype=f32, bbox="force")
    sim_ref = heaving_sphere_3d(**kw)
    assert sim_ref.cfg.bbox_shape is not None  # dense sim: full banded path
    sim_ref.steps(2, remeasure=True)

    calls = {"banded": 0}
    real = body_mod.measure_fields_banded

    def spy(*a, **k):
        calls["banded"] += 1
        return real(*a, **k)

    old = sim_mod.measure_fields_banded
    sim_mod.measure_fields_banded = spy
    try:
        mesh = mesh_for((50, 50, 50), 8)
        sim_s = heaving_sphere_3d(mesh=mesh, **kw)
        # measurement-only banding: BDIM stays dense, measure is windowed
        assert sim_s.cfg.bbox_shape is None
        assert sim_s._measure_box is not None
        sim_s.steps(2, remeasure=True)
    finally:
        sim_mod.measure_fields_banded = old
    assert calls["banded"] >= 1
    assert np.allclose(np.asarray(sim_ref.flow.u), np.asarray(sim_s.flow.u),
                       atol=2e-5)
    # p is defined only up to the iterative solve tolerance (tol=1e-4 on
    # r·r); different dot associations land on different iterates
    assert np.allclose(np.asarray(sim_ref.flow.p), np.asarray(sim_s.flow.p),
                       atol=3e-3)
    assert np.isclose(float(sim_ref.flow.dt), float(sim_s.flow.dt),
                      rtol=1e-5)


# ---------------------------------------------------------------------------
# Periodic directions on the shard_map fast path: modular wrap
# halos (halo_exchange perdir=) + per-shard periodic ghost fills
# (per_fill_local) make every periodic flux/stencil the uniform formula —
# bitwise the reference's phi_uP wrap + top-face flux copy (src/Flow.jl:7,60)
# and perBC! ghost fill (src/util.jl:227-231).
# ---------------------------------------------------------------------------

def test_per_fill_local_matches_bc_scalar_periodic():
    """Per-shard periodic ghost fill (targeted ppermutes) is bitwise the
    dense `bc_scalar_periodic` (reference perBC!, src/util.jl:227-231)."""
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.parallel.halo import per_fill_local, spatial_specs
    from waterlily_tpu.ops.bc import bc_scalar_periodic
    for S, perdir in [((18, 10, 10), (0,)), ((18, 10, 10), (0, 2)),
                      ((16, 32), (0, 1))]:
        D = len(S)
        a = jax.random.normal(jax.random.PRNGKey(21), S, f32)
        ref = bc_scalar_periodic(a, perdir)
        mesh = mesh_for(S, 8)
        sc, _vec = spatial_specs(mesh, D)
        fn = jax.shard_map(
            lambda a_l: per_fill_local(a_l, mesh, S, perdir),
            mesh=mesh, in_specs=(sc,), out_specs=sc, check_vma=False)
        out = jax.jit(fn)(a)
        assert np.array_equal(np.asarray(ref), np.asarray(out)), (S, perdir)


@pytest.mark.parametrize("S,perdir", [((32, 32), (0, 1)), ((16, 16, 32), (2,)),
                                      ((32, 16, 16), (0, 1, 2))])
def test_shardmap_conv_diff_periodic_matches_dense(S, perdir):
    """conv_diff with modular wrap halos equals the dense periodic tendency
    (phi_uP far-upwind wrap + top-face flux copy) on sharded AND unsharded
    periodic axes."""
    from waterlily_tpu.parallel.shard_smooth import (shardmap_conv_diff,
                                                     can_shardmap)
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.ops.convect import conv_diff, quick
    from waterlily_tpu.ops.bc import bc_vector
    D = len(S)
    u = jax.random.normal(jax.random.PRNGKey(22), (D,) + S, f32)
    # both paths share the step's contract: ghosts periodic-filled by BC
    u = bc_vector(u, (0.0,) * D, False, perdir)
    r_ref = jax.jit(lambda u: conv_diff(u, 0.01, perdir, quick, False))(u)
    mesh = mesh_for(S, 8)
    assert can_shardmap(mesh, S, perdir)
    r_s = jax.jit(lambda u: shardmap_conv_diff(mesh, u, 0.01, quick,
                                               perdir=perdir))(u)
    assert np.allclose(np.asarray(r_ref), np.asarray(r_s), atol=1e-5), \
        (S, perdir)


@pytest.mark.parametrize("perdir", [(0,), (0, 1, 2)])
def test_shardmap_pcg_periodic_matches_dense(perdir):
    """The shard_map PCG smoother on periodic levels (per_fill_local ghost
    fill inside the matvec) equals the dense smoother."""
    from waterlily_tpu.parallel.shard_smooth import shardmap_pcg, can_shardmap
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.ops.poisson import make_level, pcg, residual
    S = (32, 16, 16)
    key = jax.random.PRNGKey(24)
    L = jnp.abs(jax.random.normal(key, (3,) + S, f32)) * 0.2 + 0.5
    lev = make_level(L, perdir)
    x = jnp.zeros(S, f32)
    z = jax.random.normal(key, S, f32) * 1e-2
    r = residual(lev, x, z)
    x_ref, r_ref = jax.jit(lambda l, x, r: pcg(l, x, r))(lev, x, r)
    mesh = mesh_for(S, 8)
    assert can_shardmap(mesh, S, perdir)
    lev_s = lev.replace(mesh=mesh, sharded=True)
    x_s, r_s = jax.jit(lambda l, x, r: shardmap_pcg(l, x, r))(lev_s, x, r)
    assert np.allclose(np.asarray(x_ref), np.asarray(x_s), atol=1e-6)
    assert np.allclose(np.asarray(r_ref), np.asarray(r_s), atol=1e-6)


def test_shard_solve_periodic_matches_dense():
    """shardmap_ml_solve on fully-periodic levels: same iteration count,
    matching fields, periodic ghosts of x filled like the dense solve's
    final perBC."""
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.parallel.shard_solve import shardmap_ml_solve
    from waterlily_tpu.ops.multigrid import ml_solve
    from waterlily_tpu.flow import div
    from waterlily_tpu.grid import mask_interior
    perdir = (0, 1, 2)
    cfg = FlowConfig(D=3, S=(18, 18, 18), U=(0.0, 0.0, 0.0), nu=0.01,
                     dtype=f32, perdir=perdir)

    def ulam(i, x):
        k = 2 * jnp.pi / 18
        if i == 0:
            return jnp.sin(k * x[0]) * jnp.cos(k * x[1])
        if i == 1:
            return -jnp.cos(k * x[0]) * jnp.sin(k * x[1])
        return jnp.zeros_like(x[0])

    state = flow_init(cfg, ulam)
    levels = build_levels(state.mu0, perdir)
    z = jax.jit(div)(state.u)
    x0 = 0.25 * mask_interior(
        jax.random.normal(jax.random.PRNGKey(25), cfg.S, f32))
    x_ref, r_ref, n_ref = jax.jit(
        lambda l, x, z: ml_solve(l, x, z))(levels, x0, z)

    mesh = mesh_for(cfg.S, 8)
    levs = tuple(l.replace(mesh=mesh, sharded=True) for l in levels)
    x_s, r_s, n_s = jax.jit(
        lambda l, x, z: shardmap_ml_solve(l, x, z))(levs, x0, z)
    assert int(n_s) == int(n_ref)
    assert np.allclose(np.asarray(x_ref), np.asarray(x_s), atol=1e-5)
    assert np.allclose(np.asarray(r_ref), np.asarray(r_s), atol=1e-5)


def test_shard_step_region_periodic_matches_dense():
    """The ONE-region whole step on a fully-periodic config (3D TGV) matches
    the dense mom_step — the multi-chip fast path for the flagship periodic
    validation case."""
    from waterlily_tpu.parallel.mesh import mesh_for
    from waterlily_tpu.parallel import mesh as pmesh
    from waterlily_tpu.parallel import shard_step as sstep
    from waterlily_tpu.parallel.shard_step import (shardmap_mom_step,
                                                   can_shard_step)
    perdir = (0, 1, 2)
    cfg = FlowConfig(D=3, S=(18, 18, 18), U=(0.0, 0.0, 0.0), nu=0.005,
                     dtype=f32, perdir=perdir)
    k = 2 * jnp.pi / 18

    def ulam(i, x):
        if i == 0:
            return jnp.sin(k * x[0]) * jnp.cos(k * x[1]) * jnp.cos(k * x[2])
        if i == 1:
            return -jnp.cos(k * x[0]) * jnp.sin(k * x[1]) * jnp.cos(k * x[2])
        return jnp.zeros_like(x[0])

    state = flow_init(cfg, ulam)
    levels = build_levels(state.mu0, perdir)
    ref, aux_ref = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)

    mesh = mesh_for(cfg.S, 8)
    old = pmesh.SHARDMAP_MIN_CELLS
    old_flag = sstep.WHOLE_STEP_REGION
    try:
        pmesh.SHARDMAP_MIN_CELLS = 0
        sstep.WHOLE_STEP_REGION = True
        levs = tuple(l.replace(mesh=mesh, sharded=True) for l in levels)
        assert can_shard_step(cfg._replace(sharded=True), levs)
        out, aux = jax.jit(
            lambda s, l: shardmap_mom_step(cfg._replace(sharded=True),
                                           l, s))(state, levs)
    finally:
        pmesh.SHARDMAP_MIN_CELLS = old
        sstep.WHOLE_STEP_REGION = old_flag
    assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-5)
    assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-4)
    assert np.isclose(float(ref.dt), float(out.dt), rtol=1e-6)
    assert list(map(int, aux["pois_n"])) == \
        list(map(int, aux_ref["pois_n"]))


def test_sharded_periodic_step_dispatch():
    """A sharded fully-periodic step routed through the per-phase fast paths
    (shardmap conv_diff + one-region solve) matches the dense step."""
    from waterlily_tpu.parallel import mesh as pmesh
    from waterlily_tpu.parallel.mesh import mesh_for
    perdir = (0, 1, 2)
    cfg = FlowConfig(D=3, S=(18, 18, 18), U=(0.0, 0.0, 0.0), nu=0.01,
                     dtype=f32, perdir=perdir)
    k = 2 * jnp.pi / 18

    def ulam(i, x):
        if i == 0:
            return jnp.sin(k * x[0]) * jnp.cos(k * x[1]) * jnp.cos(k * x[2])
        if i == 1:
            return -jnp.cos(k * x[0]) * jnp.sin(k * x[1]) * jnp.cos(k * x[2])
        return jnp.zeros_like(x[0])

    state = flow_init(cfg, ulam)
    levels = build_levels(state.mu0, perdir)
    ref, aux_ref = jax.jit(lambda s, l: mom_step(cfg, l, s))(state, levels)
    old = pmesh.SHARDMAP_MIN_CELLS
    try:
        pmesh.SHARDMAP_MIN_CELLS = 0
        mesh = mesh_for(cfg.S, 8)
        step = sharded_step_fn(cfg, mesh)
        out, aux = step(state, levels)
    finally:
        pmesh.SHARDMAP_MIN_CELLS = old
    assert np.allclose(np.asarray(ref.u), np.asarray(out.u), atol=1e-5)
    assert np.allclose(np.asarray(ref.p), np.asarray(out.p), atol=1e-4)
    assert list(map(int, aux["pois_n"])) == list(map(int, aux_ref["pois_n"]))
