"""Pytree checkpoint/restore for simulation state.

Equivalent of the reference's VTK-based restart
(ext/WaterLilyReadVTKExt.jl): the full `FlowState` pytree plus host-side
histories are saved, so restart is bit-exact for *every* field (the
reference restores only p/u and re-measures μ₀).  Plain `.npz` container —
no external services, works on any backend.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..flow import FlowState

__all__ = ["save_checkpoint", "load_checkpoint", "restart_sim",
           "save_checkpoint_orbax", "restart_sim_orbax"]

_FIELDS = ("u", "p", "V", "mu0", "mu1", "dt", "t", "bbox")


def save_checkpoint(fname: str, sim) -> None:
    """Save a Simulation's full state + histories to ``fname`` (.npz)."""
    arrays = {f: np.asarray(getattr(sim.flow, f)) for f in _FIELDS}
    arrays["dts"] = np.asarray(sim.dts)
    arrays["pois_n"] = (np.stack(sim.pois_n) if sim.pois_n
                        else np.zeros((0, 2), np.int32))
    np.savez(fname, **arrays)


def load_checkpoint(fname: str):
    """Load arrays saved by `save_checkpoint`."""
    with np.load(fname) as data:
        return {k: data[k] for k in data.files}


def _restored_bbox(sim, data, dtype, D):
    """Band-window corner for a restored state.

    The checkpoint's bbox cannot be trusted into a *banded* sim: it may come
    from pre-banded code or a bbox=False run (zeros), which would park the
    BDIM window at the domain corner while the body sits mid-domain — so for
    banded sims the corner is recomputed from the body at the restored time.
    """
    import jax

    if sim.cfg.bbox_shape is None:
        bbox = data.get("bbox")
        if bbox is None:
            bbox = np.zeros((D,), np.int32)
        return jnp.asarray(bbox, jnp.int32)
    from ..body import sdf as _sdf
    from ..grid import loc_grid, band_box_start
    body, S, eps = sim.body, sim.cfg.S, sim.epsilon

    def _corner(ts):
        pts = loc_grid(S, None, dtype).reshape(-1, D)
        d = jax.vmap(lambda x: _sdf(body, x, ts))(pts).reshape(S)
        return band_box_start(d < (2.0 + eps), sim.cfg.bbox_shape)

    return jax.jit(_corner)(jnp.asarray(data["t"], dtype))


def restart_sim(sim, fname: str):
    """Restore a Simulation in place from a checkpoint.

    The grid shape must match (as the reference asserts on restart,
    ext/WaterLilyReadVTKExt.jl:33)."""
    data = load_checkpoint(fname)
    if tuple(data["p"].shape) != sim.cfg.S:
        raise ValueError(f"checkpoint grid {data['p'].shape} != sim grid {sim.cfg.S}")
    dtype = sim.cfg.dtype
    D = len(sim.cfg.S)
    bbox = _restored_bbox(sim, data, dtype, D)
    sim.flow = FlowState(
        u=jnp.asarray(data["u"], dtype), p=jnp.asarray(data["p"], dtype),
        V=jnp.asarray(data["V"], dtype), mu0=jnp.asarray(data["mu0"], dtype),
        mu1=jnp.asarray(data["mu1"], dtype), dt=jnp.asarray(data["dt"], dtype),
        t=jnp.asarray(data["t"], dtype), bbox=bbox)
    from ..ops.multigrid import build_levels
    # _lv_box (not cfg.bbox_shape): banded Poisson levels are opt-in
    sim.levels = build_levels(sim.flow.mu0, sim.cfg.perdir, sim.cfg.sharded,
                              getattr(sim, "_lv_box", None), sim.flow.bbox)
    sim.dts = [float(x) for x in data["dts"]]
    sim.pois_n = [row for row in data["pois_n"]]
    return sim


# --- optional Orbax backend -------------------------------------------------
#
# The npz container above is dependency-free and bit-exact, but single-host:
# on a multi-chip mesh it would funnel every shard through one process.
# Orbax writes each shard from its owning host (async, OCDBT), which is the
# production checkpointing path for sharded runs — the sharded analog of
# the reference's single-file VTK restart.

def save_checkpoint_orbax(path: str, sim) -> None:
    """Save the full state with Orbax (sharded arrays write in parallel)."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    tree = {f: getattr(sim.flow, f) for f in _FIELDS}
    tree["dts"] = np.asarray(sim.dts)
    tree["pois_n"] = (np.stack(sim.pois_n).astype(np.int32) if sim.pois_n
                      else np.zeros((0, 2), np.int32))
    ckptr.save(path, tree)
    ckptr.wait_until_finished()


def restart_sim_orbax(sim, path: str):
    """Restore a Simulation in place from an Orbax checkpoint.

    For a sharded sim the field leaves are restored *directly onto their
    spatial shardings* (per-shard reads — no full-array materialisation on
    one host), via an abstract target pytree."""
    import jax
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    meta = dict(ckptr.metadata(path).item_metadata)
    # validate the grid BEFORE the (possibly sharded, abstract-target)
    # restore and any banded-bbox sdf recompute — a mismatch should fail
    # with the same up-front ValueError the npz path gives
    if tuple(meta["p"].shape) != sim.cfg.S:
        raise ValueError(
            f"checkpoint grid {tuple(meta['p'].shape)} != sim grid {sim.cfg.S}")
    if sim.cfg.sharded and sim.mesh is not None:
        from ..parallel.mesh import state_specs
        D = len(sim.cfg.S)
        specs = state_specs(sim.mesh, D)._asdict()

        def _abstract(k, m):
            sh = specs.get(k)
            return jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=sh)

        target = {k: _abstract(k, m) for k, m in meta.items()}
        data = ckptr.restore(path, target)
    else:
        data = ckptr.restore(path)
    dtype = sim.cfg.dtype
    D = len(sim.cfg.S)
    sim.flow = FlowState(
        u=jnp.asarray(data["u"], dtype), p=jnp.asarray(data["p"], dtype),
        V=jnp.asarray(data["V"], dtype), mu0=jnp.asarray(data["mu0"], dtype),
        mu1=jnp.asarray(data["mu1"], dtype), dt=jnp.asarray(data["dt"], dtype),
        t=jnp.asarray(data["t"], dtype),
        bbox=_restored_bbox(sim, data, dtype, D))
    from ..ops.multigrid import build_levels
    sim.levels = build_levels(sim.flow.mu0, sim.cfg.perdir, sim.cfg.sharded,
                              getattr(sim, "_lv_box", None), sim.flow.bbox)
    sim.dts = [float(x) for x in data["dts"]]
    sim.pois_n = [row for row in data["pois_n"]]
    return sim
