"""Sphere drag resolution convergence at Re=100 (north-star force claim).

Runs the laminar sphere at increasing BDIM resolution (radius in cells)
to a settled drag plateau and reports mean Cd vs the literature value
(Cd ≈ 1.09: Johnson & Patel 1999 / Roos & Willmarth) — the quantitative
statement of how close the solver is to the "force coefficients within
1%" north star at each affordable resolution (BASELINE.md).

Run on a GPU: python scripts/cd_convergence.py
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

from waterlily_tpu.models.cases import sphere_3d  # noqa: E402
from waterlily_tpu.metrics import total_force  # noqa: E402

CD_LIT = 1.09


def run(radius, t_end=14.0):
    m = 8 * radius
    n = 3 * m // 2
    sim = sphere_3d(n=n, m=m, Re=100, dtype=jnp.float32)
    nu = sim.cfg.nu
    tf = jax.jit(lambda u, p: total_force(u, p, nu, sim.body, 0.0))
    area = math.pi * (sim.L / 2) ** 2
    t0 = time.time()
    rec = sim.run_record(t_end, every=1.0,
                         fields={"f": lambda s: tf(s.flow.u, s.flow.p)},
                         remeasure=False)
    t = np.array(rec["t"])
    cd = -2 * np.array(rec["f"])[:, 0] / area
    w = t >= t_end - 4.0
    mean_cd = float(cd[w].mean())
    print(f"radius {radius:3d} cells  grid ({n},{m},{m})  "
          f"Cd = {mean_cd:.4f}  ({100 * (mean_cd / CD_LIT - 1):+.1f}% vs "
          f"literature {CD_LIT})  [{time.time() - t0:.0f} s]", flush=True)
    del sim
    return mean_cd


def main():
    for radius in (6, 8, 12, 16, 24, 32):
        try:
            run(radius)
        except Exception as e:
            print(f"radius {radius}: {e!r}", flush=True)


if __name__ == "__main__":
    main()
