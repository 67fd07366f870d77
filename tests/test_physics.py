"""Physics regressions on the canonical validation flows.

The reference pins added-mass and uses the circle/TGV configs as living
regressions (maintests.jl:304-316, 232-253; README.md:41-51).  These tests
pin the two headline validation flows at CI-affordable resolution:

- 2D circle at Re=100: established vortex shedding with mean drag and
  Strouhal number.  At full resolution (256×128, tU/L→130) this framework
  measures Cd=1.74, St=0.22 — consistent with 25%-blockage literature
  (an f32 run).  At the reduced (96,64) resolution used here the drag
  coefficient is grid-sensitive (coarser sphere ⇒ lower Cd ≈ 1.52) while
  the Strouhal number is already converged; the windows below encode that.
- 3D Taylor-Green vortex at Re=1600: the transition benchmark.  KE must
  decay monotonically, *faster* than the linear-viscous rate once vortex
  stretching amplifies enstrophy, and the enstrophy itself must grow well
  above its initial value — the 3D-specific mechanism a 2D solve cannot
  produce (in 2D, enstrophy is non-increasing).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from waterlily_tpu.models.cases import circle_2d, tgv_3d
from waterlily_tpu.metrics import pressure_force, ke, omega


def test_circle_shedding_cd_st():
    """Mean Cd and Strouhal of the Re=100 circle (reduced res + a transverse
    seed so the wake instability saturates within the test budget)."""
    def ulam(i, x):
        return jnp.where(
            i == 0, 1.0,
            0.15 * jnp.sin(x[0] / 6) * jnp.exp(-((x[1] - 31.0) / 10) ** 2))

    sim = circle_2d(n=96, m=64, Re=100, dtype=jnp.float32, ulam=ulam)
    pf = jax.jit(lambda p: pressure_force(p, sim.body, 0.0))
    rec = sim.run_record(38.0, every=0.25,
                         fields={"f": lambda s: pf(s.flow.p)},
                         remeasure=False)
    t = np.array(rec["t"])
    f = np.array(rec["f"])
    Dc = 16.0  # diameter = 2*radius = m/4
    cd = -2 * f[:, 0] / Dc
    cl = 2 * f[:, 1] / Dc

    w = t >= 25.0
    clw, tw = cl[w], t[w]
    assert 1.40 < cd[w].mean() < 1.70, f"mean Cd {cd[w].mean():.3f}"
    # shedding must be established: finite lift oscillation
    assert np.sqrt((clw ** 2).mean()) > 0.25, "no saturated shedding"
    crossings = np.where(np.diff(np.sign(clw)) != 0)[0]
    assert len(crossings) >= 5, f"only {len(crossings)} Cl zero-crossings"
    st = 1.0 / (2 * np.mean(np.diff(tw[crossings])))
    assert 0.19 < st < 0.25, f"St {st:.3f}"  # 0.22 ± ~12%


def test_tgv3d_energy_decay_and_vortex_stretching():
    """3D TGV at Re=1600: monotone KE decay, super-viscous dissipation, and
    enstrophy growth (vortex stretching)."""
    # 24³ keeps the oracle (monotone decay, super-viscous dissipation,
    # 3D enstrophy growth) at ~half the 32³ wall time; windows re-measured
    # at this resolution (ke ratio 0.623 at t*=1, enstrophy ratio 1.89)
    L, Re = 24, 1600
    sim = tgv_3d(L=L, Re=Re, dtype=jnp.float32)
    ke_fn = jax.jit(lambda u: jnp.sum(ke(u)))
    ens_fn = jax.jit(lambda u: jnp.sum(jnp.sum(omega(u) ** 2, axis=0)))
    ke0 = float(ke_fn(sim.flow.u))
    ens0 = float(ens_fn(sim.flow.u))
    kes, ens, ts = [ke0], [ens0], [0.0]
    while sim.sim_time < 1.1:
        sim.steps(4, remeasure=False)
        kes.append(float(ke_fn(sim.flow.u)))
        ens.append(float(ens_fn(sim.flow.u)))
        ts.append(sim.sim_time)

    kes, ens, ts = np.array(kes), np.array(ens), np.array(ts)
    assert np.all(np.diff(kes) < 0), "KE must decay monotonically"
    # regression window for the transitional decay at this resolution
    # (measured 0.623 at t*=1 on 24^3): well below the linear-viscous
    # bound exp(-6 nu kappa^2 t) ≈ 0.975 — super-viscous dissipation.
    # Pin the first sample past t*=1 (chunked stepping overshoots the end).
    idx = int(np.argmax(ts >= 1.0))
    r_end = kes[idx] / ke0
    assert 0.54 < r_end < 0.72, f"KE(t*={ts[idx]:.2f})/KE0 = {r_end:.3f}"
    # vortex stretching: enstrophy grows far above its initial value
    # (impossible in 2D, where enstrophy is non-increasing; 1.89 measured)
    assert ens.max() / ens0 > 1.5, f"enstrophy ratio {ens.max() / ens0:.2f}"


@pytest.mark.skipif(os.environ.get("WATERLILY_NIGHTLY") != "1",
                    reason="TGV dissipation peak to t*=12: nightly tier")
def test_tgv3d_dissipation_peak_dns():
    """3D TGV Re=1600 dissipation-curve validation against published DNS.

    The volume-mean KE (DNS normalization: 1/8 at t=0) decays with a
    dissipation-rate peak eps(t*) = -dKE/dt* of ~0.0117-0.0122 at
    t* ~ 8.2-9.0 (Brachet et al.; HiOCFD C3.5 512^3 spectral reference).
    At 64^3 this solver measures peak 0.01199 at t*=8.34 in f32
    (scripts/tgv3d_dissipation.py; 128^3/256^3 curves in docs/assets)
    — INSIDE the DNS window.  The windows below bound both the peak value
    and its time; t* = 2*pi*t_sim for this case's kappa = 2*pi/L."""
    import math
    from waterlily_tpu.grid import interior_view

    sim = tgv_3d(L=64, Re=1600, dtype=jnp.float32)
    mke = jax.jit(
        lambda u: 0.5 * jnp.mean(jnp.sum(interior_view(u, 3) ** 2, axis=0)))
    rec = sim.run_record(12.0 / (2 * math.pi), every=1.0 / (8 * math.pi),
                         fields={"ke": lambda s: mke(s.flow.u)})
    tstar = 2 * math.pi * np.array(rec["t"])
    keser = np.array(rec["ke"], dtype=np.float64)
    eps = -np.gradient(keser, tstar)
    i = int(np.argmax(eps))
    assert 0.0110 < eps[i] < 0.0130, f"peak eps {eps[i]:.5f} (calib 0.01199)"
    assert 7.5 < tstar[i] < 9.3, f"peak at t* {tstar[i]:.2f} (calib 8.34)"


@pytest.mark.skipif(os.environ.get("WATERLILY_NIGHTLY") != "1",
                    reason="sphere drag to tU/L=12: nightly tier (~5 min)")
def test_sphere_drag_re100():
    """Laminar-sphere drag regression: Re=100,
    steady axisymmetric wake, literature Cd ≈ 1.09 (Johnson & Patel 1999,
    Roos & Willmarth).  At the radius-6 BDIM resolution used here the
    drag plateaus at Cd = 0.867 (calibrated to tU/L=25: converged to 4
    digits by tU/L≈10) — ~20% below literature, consistent with the 2D
    circle's coarse-grid sensitivity (1.52 at reduced vs 1.74 at full
    resolution).  The window pins the solver against
    regressions; the bench records the radius-8 headline Cd every round
    (bench.py `mean_cd_tU50_55`)."""
    import math
    from waterlily_tpu.models.cases import sphere_3d
    from waterlily_tpu.metrics import total_force

    sim = sphere_3d(n=72, m=48, Re=100, dtype=jnp.float32)
    nu = sim.cfg.nu
    tf = jax.jit(lambda u, p: jnp.stack(
        [total_force(u, p, nu, sim.body, 0.0)[0],
         total_force(u, p, nu, sim.body, 0.0, sampling="extrap")[0]]))
    area = math.pi * (sim.L / 2) ** 2
    rec = sim.run_record(12.0, every=1.0,
                         fields={"f": lambda s: tf(s.flow.u, s.flow.p)},
                         remeasure=False)
    t = np.array(rec["t"])
    f = np.array(rec["f"])
    cd = -2 * f[:, 0] / area
    w = t >= 9.0
    mean_cd = cd[w].mean()
    assert 0.82 < mean_cd < 0.92, f"mean Cd {mean_cd:.4f} (calib 0.867)"
    # the wake is steady at Re=100: the plateau must be flat
    assert abs(cd[-1] - cd[w][0]) < 0.01
    # surface-extrapolated estimator (scripts/cd_estimators.py): calibrated
    # 0.981 at this resolution, i.e. -10% vs literature where the band-center
    # estimator reads -20%
    cd_x = (-2 * f[:, 1] / area)[w].mean()
    assert 0.93 < cd_x < 1.03, f"extrap Cd {cd_x:.4f} (calib 0.981)"
