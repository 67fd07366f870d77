"""Force-estimator study: can a better quadrature close the Cd deficit?

The resolution ladder (docs/assets/cd_ladder.csv) measured the laminar-sphere
drag ~13-20% below literature at affordable resolutions and attributed it
to O(h) BDIM smearing.  That deficit has two possible sources: (a) the
*measurement* — the reference estimator integrates p and the strain rate
at band-cell centers, i.e. up to one cell away from the surface; (b) the
*flow* — BDIM's smeared boundary produces the wrong surface distributions.
Only (a) is fixable by a better estimator.  This script runs ONE sphere
flow and records Cd under four samplings of each force component:

  center  — band-cell centers (reference Metrics.jl:94-120 semantics)
  surf    — multilinear interp at the surface projection x - d*n
  probe1  — interp one cell OUTSIDE the surface (avoids in-body values)
  extrap  — linear extrapolation to the surface from probes at +1h, +2h

All variants share the same kern-weighted band quadrature; only the
sampling location of the integrand changes.

Run: python scripts/cd_estimators.py [radius ...]
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
from waterlily_tpu.metrics import _band_measure, strain_rate  # noqa: E402
from waterlily_tpu.grid import interp, interior_mask, loc_grid  # noqa: E402

CD_LIT = 1.09

VARIANTS = ("center", "surf", "probe1", "extrap")


def build_estimators(sim):
    """Return a jitted fn(u, p) -> dict of x-forces per estimator variant.

    The body is static, so the band geometry (w, n, xs) is computed once and
    reduced to its quadrature support (band cells in the interior) — the
    jitted function then gathers only O(band) samples per variant."""
    S = sim.flow.p.shape
    D = len(S)
    w, n, xs = _band_measure(sim.body, S, 0.0, sim.flow.p.dtype)
    w = np.asarray(w)
    n = np.asarray(n)
    xs = np.asarray(xs)
    im = np.asarray(interior_mask(S)).reshape(-1)
    sel = (w > 1e-9) & im
    wb = jnp.asarray(w[sel])
    nb = jnp.asarray(n[sel])
    centers = np.asarray(loc_grid(S, None, np.float32)).reshape(-1, D)[sel]
    pts = {
        "center": jnp.asarray(centers),
        "surf": jnp.asarray(xs[sel]),
        "probe1": jnp.asarray(xs[sel] + n[sel]),
        "probe2": jnp.asarray(xs[sel] + 2.0 * n[sel]),
    }
    nu = sim.cfg.nu
    print(f"  band cells: {int(sel.sum())} of {w.size}")

    def fx(u, p):
        sr = strain_rate(u)

        def sample_p(key):
            return jax.vmap(lambda x: interp(x, p))(pts[key])

        def sample_sr(key):
            return jnp.stack([jnp.stack(
                [jax.vmap(lambda x: interp(x, sr[i, j]))(pts[key])
                 for j in range(D)]) for i in range(D)])  # (D,D,B)

        ps = {k: sample_p(k) for k in pts}
        ps["extrap"] = 2.0 * ps["probe1"] - ps["probe2"]
        srs = {k: sample_sr(k) for k in pts}
        srs["extrap"] = 2.0 * srs["probe1"] - srs["probe2"]
        out = []
        for k in VARIANTS:
            out.append(jnp.sum(ps[k] * wb * nb[:, 0]))
            tot = jnp.einsum("ijb,bj->bi", srs[k], nb) * wb[:, None]
            out.append(-nu * jnp.sum(tot[:, 0]))
        # flat vector [p_v0, v_v0, p_v1, v_v1, ...] (run_record np.asarray's
        # each sample, so dicts don't survive the recorder)
        return jnp.stack(out)

    return jax.jit(fx)


def run(radius, t_end=14.0, width=4):
    """``width`` is the box cross-section in sphere diameters (ladder: 4)."""
    m = 2 * radius * width
    n = 3 * m // 2
    if width == 4:
        sim = sphere_3d(n=n, m=m, Re=100, dtype=jnp.float32)
    else:  # same setup as cd_confinement.py: radius fixed, box widened
        from waterlily_tpu.simulation import Simulation
        from waterlily_tpu.body import AutoBody
        center = m / 2 - 1
        body = AutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - center) ** 2))
                        - radius)
        sim = Simulation((n, m, m), (1, 0, 0), 2 * radius,
                         nu=2 * radius / 100, body=body, dtype=jnp.float32)
    est = build_estimators(sim)
    area = math.pi * (sim.L / 2) ** 2
    t0 = time.time()
    rec = sim.run_record(t_end, every=1.0,
                         fields={"e": lambda s: est(s.flow.u, s.flow.p)},
                         remeasure=False)
    t = np.array(rec["t"])
    w = t >= t_end - 4.0
    e = np.stack(rec["e"])  # (samples, 2*len(VARIANTS))
    vals = {}
    for i, v in enumerate(VARIANTS):
        vals["p_" + v] = -2 * e[w, 2 * i].mean() / area
        vals["v_" + v] = -2 * e[w, 2 * i + 1].mean() / area
    print(f"radius {radius}  width {width} diam  grid ({n},{m},{m})  [{time.time()-t0:.0f} s]")
    print(f"  {'variant':10s} {'Cp':>8s} {'Cv':>8s} {'Cd':>8s}   vs lit {CD_LIT}")
    for v in VARIANTS:
        cd = vals["p_" + v] + vals["v_" + v]
        print(f"  {v:10s} {vals['p_' + v]:8.4f} {vals['v_' + v]:8.4f} "
              f"{cd:8.4f}   {100 * (cd / CD_LIT - 1):+.1f}%", flush=True)
    return vals


def main():
    # args: radius or radiusxwidth (box width in diameters, default 4)
    specs = sys.argv[1:] or ["6"]
    for s in specs:
        r, _, w = s.partition("x")
        run(int(r), width=int(w) if w else 4)


if __name__ == "__main__":
    main()
