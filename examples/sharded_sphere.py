"""Spatially-sharded 3D sphere across all available devices.

On a multi-GPU host this decomposes the grid over the cards; without
one it can be tried with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu.

Run:  python examples/sharded_sphere.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp

from waterlily_tpu.models.cases import sphere_3d
from waterlily_tpu.parallel.mesh import mesh_for, sharded_scan_fn


def main():
    n_dev = len(jax.devices())
    sim = sphere_3d(48, 32, dtype=jnp.float32)
    # mesh_for picks per-axis factors that divide the padded grid — ghost
    # write-backs then lower to collective-permutes with no all-gathers
    mesh = mesh_for(sim.cfg.S, n_dev)
    print(f"mesh: {dict(mesh.shape)}")
    scan = sharded_scan_fn(sim.cfg, mesh)
    state, pois = scan(sim.flow, sim.levels, 20)
    jax.block_until_ready(state.u)
    print(f"20 sharded steps done; dt={float(state.dt):.3f}, "
          f"last MG iters={pois[-1].tolist()}")


if __name__ == "__main__":
    main()
