"""3D Taylor-Green Re=1600 dissipation-curve validation (DNS anchor).

The classic transition-to-turbulence benchmark (the 3D analog of the
reference's 2D TGV oracle, maintests.jl:232-253): starting from
u = (sin x cos y cos z, -cos x sin y cos z, 0) at Re = U/(kappa nu) = 1600,
the volume-mean kinetic energy decays slowly until vortex stretching
cascades energy to small scales; the dissipation rate eps(t*) = -dKE/dt*
peaks near t* ~ 8-9.  Published DNS anchors (Brachet et al. 1983/1991 and
the HiOCFD workshop C3.5 reference data, 512^3 spectral): peak eps about
0.0117-0.0122 at t* about 8.2-9.0.

Units: the case is built with kappa = 2 pi / L, so one DNS time unit
(1/(kappa U)) is L/(2 pi) grid units; t* = 2 pi t_sim where t_sim is
`Simulation.sim_time` (tU/L).  KE here is the volume-mean 0.5|u|^2 per
unit volume in U^2 units — the DNS normalization (initial value 1/8).

Run on a GPU: python scripts/tgv3d_dissipation.py [L ...]
"""
import math
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, "/root/repo")
from waterlily_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from waterlily_tpu.models.cases import tgv_3d  # noqa: E402
from waterlily_tpu.grid import interior_view  # noqa: E402

T_STAR_END = 12.0
SAMPLES_PER_TSTAR = 4


def mean_ke(u):
    # volume-mean 0.5|u|^2 over interior cells (DNS normalization: 1/8 at t=0)
    ui = interior_view(u, u.ndim - 1)
    return 0.5 * jnp.mean(jnp.sum(ui ** 2, axis=0))


def run(L):
    sim = tgv_3d(L=L, Re=1600, dtype=jnp.float32)
    ke_fn = jax.jit(lambda u: mean_ke(u))
    t_end = T_STAR_END / (2 * math.pi)
    every = 1.0 / (SAMPLES_PER_TSTAR * 2 * math.pi)
    t0 = time.time()
    rec = sim.run_record(t_end, every=every,
                         fields={"ke": lambda s: ke_fn(s.flow.u)})
    tstar = 2 * math.pi * np.array(rec["t"])
    ke = np.array(rec["ke"], dtype=np.float64)
    # centered-difference dissipation rate in DNS units
    eps = -np.gradient(ke, tstar)
    i = int(np.argmax(eps))
    print(f"L={L:4d}  KE(0)={ke[0]:.5f} (exact 0.12500)  "
          f"peak eps={eps[i]:.5f} at t*={tstar[i]:.2f}  "
          f"(DNS 512^3 spectral: ~0.0117-0.0122 at t*~8.2-9.0)  "
          f"[{time.time() - t0:.0f} s, {len(sim.dts)} steps]", flush=True)
    return tstar, ke, eps


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [128, 256]
    for L in sizes:
        tstar, ke, eps = run(L)
        np.savez(f"/tmp/tgv3d_{L}.npz", tstar=tstar, ke=ke, eps=eps)


if __name__ == "__main__":
    main()
