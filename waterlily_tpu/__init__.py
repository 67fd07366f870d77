"""waterlily_tpu — an incompressible-flow framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
WaterLily.jl (reference mounted at /root/reference): unsteady incompressible
2D/3D Navier-Stokes on a staggered Cartesian grid, immersed solid boundaries
via the Boundary Data Immersion Method (BDIM), geometric-multigrid pressure
solves, implicit autodiff geometry, on-device metrics/forces, checkpointing,
VTK I/O, and spatial domain decomposition over device meshes.

The reference is 100% Julia with no native components (SURVEY.md §2); the
equivalent of its KernelAbstractions kernel tier is the XLA-fused
whole-array op layer in `waterlily_tpu.ops`.
"""
from .grid import l2, linf, interp, apply_field, loc_grid, shift, interior
from .flow import FlowState, FlowConfig, mom_step, flow_init, cfl, div
from .ops import (bc_vector, bc_scalar_periodic, exit_bc, conv_diff, quick,
                  vanleer, PoissonLevel, make_level, poisson_solve,
                  build_levels, ml_solve, mult, residual)
from .body import (AbstractBody, AutoBody, Bodies, NoBody, measure, sdf,
                   measure_fields, measure_sdf, kern, kern0, kern1, mu0 as mu0_kern,
                   mu1 as mu1_kern, curvature)
from .metrics import (ke, curl, omega, omega_mag, omega_theta, lambda2,
                      pressure_force, viscous_force, total_force,
                      pressure_moment, nds, grad_tensor, strain_rate)
from .simulation import Simulation, sim_time

__version__ = "0.1.0"
