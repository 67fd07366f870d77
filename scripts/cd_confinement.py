"""Sphere drag domain-confinement probe at Re=100 (companion to
cd_convergence.py).

Holds grid resolution fixed (radius = 12 cells, the ladder's third rung)
and widens the domain cross-section: m = 8r/12r/16r = 4/6/8 diameters.
The literature Cd ≈ 1.09 (Johnson & Patel 1999) is an unbounded-domain
value; if the ladder's residual −13% gap is confinement (the ladder runs
a 4-diameter-wide box), Cd must rise toward literature as the box widens
at FIXED h.  Reference analog: the reference's sphere demo
(README.md:118-125) also runs a small box and reports qualitative flow
only — this probe quantifies the box effect.

Run on a GPU: python scripts/cd_confinement.py
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

from waterlily_tpu.simulation import Simulation  # noqa: E402
from waterlily_tpu.body import AutoBody  # noqa: E402
from waterlily_tpu.metrics import total_force  # noqa: E402

CD_LIT = 1.09
RADIUS = 12


def _norm2(x):
    return jnp.sqrt(jnp.sum(x ** 2))


def run(m, t_end=14.0):
    n = 3 * m // 2
    center = m / 2 - 1
    body = AutoBody(lambda x, t: _norm2(x - center) - RADIUS)
    sim = Simulation((n, m, m), (1, 0, 0), 2 * RADIUS,
                     nu=2 * RADIUS / 100, body=body, dtype=jnp.float32)
    tf = jax.jit(lambda u, p: total_force(u, p, sim.cfg.nu, sim.body, 0.0))
    area = math.pi * RADIUS ** 2
    t0 = time.time()
    rec = sim.run_record(t_end, every=1.0,
                         fields={"f": lambda s: tf(s.flow.u, s.flow.p)},
                         remeasure=False)
    t = np.array(rec["t"])
    cd = -2 * np.array(rec["f"])[:, 0] / area
    w = t >= t_end - 4.0
    mean_cd = float(cd[w].mean())
    print(f"width {m / (2 * RADIUS):4.1f} diameters  grid ({n},{m},{m})  "
          f"Cd = {mean_cd:.4f}  ({100 * (mean_cd / CD_LIT - 1):+.1f}% vs "
          f"literature {CD_LIT})  [{time.time() - t0:.0f} s]", flush=True)
    del sim
    return mean_cd


def main():
    for m in (8 * RADIUS, 12 * RADIUS, 16 * RADIUS):
        try:
            run(m)
        except Exception as e:
            print(f"m={m}: {e!r}", flush=True)


if __name__ == "__main__":
    main()
