"""Per-phase device profile of the 3D sphere step on the GPU.

Traces a few steps of the n³ sphere (Re=3700, f32, static body) with
`jax.profiler` and prints device time per `mom_step` phase, plus the
heaviest kernels, using the reducer in chip_trace.py (the same one
chip_smoke.py's trace phase uses).

Usage (on a GPU):  python scripts/profile_trace.py [n [steps]]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import require_gpu, phase_trace  # noqa: E402
from waterlily_tpu.models.cases import sphere_3d  # noqa: E402
from waterlily_tpu.utils.cache import enable_compile_cache  # noqa: E402


def main():
    require_gpu()
    enable_compile_cache()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sim = sphere_3d(n=n, m=n, Re=3700, dtype=jnp.float32)
    hlo = sim._step_static_d.lower(sim.flow, sim.levels).compile().as_text()
    sim.steps(5, remeasure=False)
    jax.block_until_ready(sim.flow.u)
    phase_trace(sim, hlo, steps=steps)


if __name__ == "__main__":
    main()
