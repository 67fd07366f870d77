"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: the reference's own GPU benchmark (README.md:118-131) — flow past
a 3D sphere, grid (96,64,64), 1.3M velocity DOF, Float32, static body,
integrated to tU/L = 50.  The reference reports ~40 s on one NVIDIA GPU.

``value`` is MLUPS (million cell-updates per second) over the run;
``vs_baseline`` is reference_wall / our_wall on that exact config
(>1 means faster than the reference's GPU).

``secondary`` holds two scale metrics recorded every round:
- the 256³ sphere (BASELINE north-star config) steady-state step, with
  ns/DOF against the reference's published 1.44 ns/DOF GPU figure
  (README.md:111);
- a 256³ heaving sphere with per-step body re-measurement (the moving-body
  hot path, maintests.jl:372-413 class), as a ratio to the static step.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp

from chip_smoke import card_lines, require_gpu

REFERENCE_WALL_S = 40.0   # README.md:128-131, 1x NVIDIA GPU, CuArray+Float32
REFERENCE_NS_PER_DOF = 1.44  # README.md:111, 2024-paper GPU cost per DOF


def _steady_step_time(sim, warm=15, steps=40, remeasure=False, windows=3):
    """Steady-state sec/step: min over ``windows`` timing windows (the
    ``timeit.repeat`` convention — the min window is the robust estimator
    of the program's actual cost)."""
    sim.steps(warm, remeasure=remeasure)
    jax.block_until_ready(sim.flow.u)
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        sim.steps(steps, remeasure=remeasure)
        jax.block_until_ready(sim.flow.u)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def _timed_horizon(make, t_end, chunk=50, warm_launches=600):
    """Wall-clock over the FULL tU/L horizon, executable pre-warmed.

    Pass 1 replays the horizon on ONE sim object until ``warm_launches``
    step-program executions have run: jitted programs belong to the
    Simulation instance, so a fixed in-trajectory warm-up would either stay
    cold or eat the horizon.  The warm replays start from a
    last-bits-perturbed initial state (a different factor per replay) and
    use the EXACT call pattern of the timed loop so every executable warms
    here, not inside the timing.  (This method predates the card; the
    benchmark's timing method is revisited on its own.)
    Pass 2 restores the pristine state and times the full horizon.
    Returns (wall_s, steps)."""
    sim = make()
    u = getattr(sim, "_unroll", 1)
    copy = lambda tree: jax.tree.map(lambda a: a + 0, tree)
    flow0 = copy(sim.flow)  # fresh buffers: steps() donates sim.flow
    dts0, pois0 = list(sim.dts), list(sim.pois_n)
    per_chunk = chunk // u + chunk % u
    i, lim = 0, warm_launches
    while lim > 0:
        i += 1
        f = copy(flow0)
        sim.flow = f._replace(u=f.u * (1.0 + i * 1e-7))
        while lim > 0 and sim.sim_time < t_end:
            sim.steps(chunk, remeasure=False)
            lim -= per_chunk
        jax.block_until_ready(sim.flow.u)
    sim.flow = copy(flow0)
    sim.dts, sim.pois_n = list(dts0), list(pois0)
    t0 = time.perf_counter()
    sim.run_until(t_end, chunk=chunk, remeasure=False)
    jax.block_until_ready(sim.flow.u)
    return time.perf_counter() - t0, len(sim.pois_n) - len(pois0), sim


def _mean_cd(sim, span=5.0, area=None):
    """Mean drag coefficients over the next ``span`` tU/L of ``sim``.

    ``Cd = -2 Fx / (rho U^2 A)`` with rho=1; ``A`` defaults to the circle
    pi r^2 of a sphere of length scale L=2r.  Sampled every 0.25 tU/L with
    the total (pressure+viscous) force, under BOTH the reference-semantics
    band-center estimator (Metrics.jl:94-127) and the surface-extrapolated
    one (metrics.py sampling="extrap"; scripts/cd_estimators.py study).
    Returns ``(cd_center, cd_extrap)``."""
    import math as _m
    from waterlily_tpu.metrics import total_force
    if area is None:
        area = _m.pi * (sim.L / 2) ** 2
    nu = sim.cfg.nu
    tf = jax.jit(lambda u, p: jnp.stack(
        [total_force(u, p, nu, sim.body, 0.0)[0],
         total_force(u, p, nu, sim.body, 0.0, sampling="extrap")[0]]))
    rec = sim.run_record(sim.sim_time + span, every=0.25,
                         fields={"f": lambda s: tf(s.flow.u, s.flow.p)},
                         remeasure=False)
    import numpy as np
    fx = np.array(rec["f"])
    cds = -2.0 * fx.mean(axis=0) / (sim.U ** 2 * area)
    return float(cds[0]), float(cds[1])


def headline(quick):
    from waterlily_tpu.models.cases import sphere_3d

    n, m = 96, 64
    t_end = 5.0 if quick else 50.0
    wall, steps, sim = _timed_horizon(
        lambda: sphere_3d(n=n, m=m, dtype=jnp.float32), t_end,
        warm_launches=100 if quick else 600)
    cells = n * m * m  # interior cells, matching utils.perf.mlups
    mlups = steps * cells / wall / 1e6
    # pro-rate the reference baseline to the --quick horizon
    scale = t_end / 50.0
    out = {
        "metric": f"3D sphere (96,64,64) f32 to tU/L={t_end:g}: MLUPS"
                  + (" [quick]" if quick else ""),
        "value": round(mlups, 2),
        "unit": "MLUPS",
        "baseline": "reference ~40 s on 1 NVIDIA GPU (README.md:128-131), "
                    "pro-rated to the timed horizon; compile + runtime "
                    "warm phase excluded (two-pass, PERF.md)",
        "vs_baseline": round(REFERENCE_WALL_S * scale / wall, 3),
        "wall_s": round(wall, 2),
        "steps": steps,
        "sec_per_step": round(wall / max(steps, 1), 5),
    }
    if not quick:
        # 3D force validation: mean drag over the
        # 5 tU/L after the benchmark horizon (the wake is developed at
        # tU/L=50).  Re=100 laminar sphere: literature Cd ≈ 1.09
        # (Johnson & Patel 1999); radius-8 BDIM resolution runs high.
        try:
            cd_c, cd_x = _mean_cd(sim)
            out["mean_cd_tU50_55"] = round(cd_c, 4)
            out["mean_cd_extrap_tU50_55"] = round(cd_x, 4)
            out["cd_literature_re100"] = 1.09
        except Exception as e:
            out["mean_cd_tU50_55"] = repr(e)
    return out


def sphere_big(n=256):
    from waterlily_tpu.models.cases import sphere_3d
    sim = sphere_3d(n=n, m=n, Re=3700, dtype=jnp.float32)
    spp = _steady_step_time(sim)
    # Simulation dims ARE the interior (S = dims+2, simulation.py), so the
    # n^3 sphere has n^3 interior cells — the same convention as headline's
    # n*m*m and the reference's per-DOF accounting (its N are interior
    # dims too, src/Flow.jl:113 `Ng = N .+ 2`; DOF = D·prod(N)).
    cells = n ** 3
    ns_dof = spp / (3 * cells) * 1e9
    return spp, {
        "metric": f"3D sphere {n}^3 f32 static: ms/step",
        "value": round(spp * 1e3, 2),
        "unit": "ms/step",
        "mlups": round(cells / spp / 1e6, 1),
        "ns_per_dof": round(ns_dof, 3),
        "baseline": "reference published GPU cost 1.44 ns/DOF (README.md:111)",
        "vs_baseline": round(REFERENCE_NS_PER_DOF / ns_dof, 3),
    }


def sharded_1dev(n, dense_spp):
    """The 256³ sphere on a 1-device mesh runs the production sharded
    config — the ONE-region multigrid solve (`parallel.shard_solve`:
    ppermute halos, psum dots) plus per-phase shard_map conv regions — on
    one card.  Ratio vs the unsharded step from this same run."""
    from waterlily_tpu.models.cases import sphere_3d
    from waterlily_tpu.parallel.mesh import mesh_for
    mesh = mesh_for((n + 2,) * 3, 1)
    sim = sphere_3d(n=n, m=n, Re=3700, dtype=jnp.float32, mesh=mesh)
    spp = _steady_step_time(sim)
    return {
        "metric": f"3D sphere {n}^3 f32 1-device-mesh shard_map: ms/step",
        "value": round(spp * 1e3, 2),
        "unit": "ms/step",
        "baseline": "self: the unsharded step in this same bench run",
        "sharded_over_dense": round(spp / dense_spp, 3),
    }


def moving_256():
    from waterlily_tpu.models.cases import heaving_sphere_3d
    # amp=32 keeps the travel-inflated band window well inside the domain
    sim = heaving_sphere_3d(radius=64, amp=32, Re=500, dtype=jnp.float32)
    frozen = _steady_step_time(sim, warm=20, steps=25, remeasure=False)
    spp = _steady_step_time(sim, warm=20, steps=30, remeasure=True)
    return {
        "metric": "3D heaving sphere 256^3 f32 remeasure: ms/step",
        "value": round(spp * 1e3, 2),
        "unit": "ms/step",
        "mlups": round(254 ** 3 / spp / 1e6, 1),
        # SELF-ratio, not a reference comparison: the same config with the
        # body frozen measures the pure re-measurement overhead.
        # remeasure_over_static <= 1.5 is the target.
        "baseline": "self: same config with frozen body (no remeasure)",
        "remeasure_over_static": round(spp / frozen, 3),
    }


def tgv3d_big(L=128):
    """3D Taylor-Green, fully periodic — exercises the periodic flux
    variants of conv_diff (ϕuP wrap + top-face flux copy) at scale."""
    from waterlily_tpu.models.cases import tgv_3d
    sim = tgv_3d(L=L, dtype=jnp.float32)
    spp = _steady_step_time(sim, warm=15, steps=30)
    return spp, {
        "metric": f"3D Taylor-Green {L}^3 periodic: ms/step",
        "value": round(spp * 1e3, 2), "unit": "ms/step",
        "mlups": round(L ** 3 / spp / 1e6, 1),
        "baseline": "none (no reference number; tracked round-over-round)",
    }


def tgv_sharded_1dev(L, dense_spp):
    """The periodic shard_map fast path: the fully-periodic 3D TGV on a
    1-device mesh runs modular wrap halos + per-shard periodic ghost fills
    (`parallel.halo`) with the one-region solve — the multi-card
    configuration of the flagship periodic validation case, on one card."""
    from waterlily_tpu.models.cases import tgv_3d
    from waterlily_tpu.parallel.mesh import mesh_for
    mesh = mesh_for((L + 2,) * 3, 1)
    sim = tgv_3d(L=L, dtype=jnp.float32, mesh=mesh)
    spp = _steady_step_time(sim, warm=15, steps=30)
    return {
        "metric": f"3D TGV {L}^3 periodic 1-device-mesh shard_map: ms/step",
        "value": round(spp * 1e3, 2), "unit": "ms/step",
        "baseline": "self: the dense periodic step in this same bench run",
        "sharded_over_dense": round(spp / dense_spp, 3),
    }


def circle_2d_wall():
    """Reference's own 2D benchmark: circle (96,64) to tU/L=50 vs ~28 s on
    an 8-thread CPU (README.md:133-137, BASELINE.md)."""
    from waterlily_tpu.models.cases import circle_2d
    wall, steps, _sim = _timed_horizon(
        lambda: circle_2d(n=96, m=64, Re=100, dtype=jnp.float32), 50.0,
        chunk=100)
    return {
        "metric": "2D circle (96,64) f32 to tU/L=50: wall s",
        "value": round(wall, 2), "unit": "s",
        "steps": steps,
        "baseline": "reference ~28 s on 8-thread CPU (README.md:133-137); "
                    "compile + runtime warm phase excluded (two-pass, "
                    "PERF.md)",
        "vs_baseline": round(28.0 / wall, 2),
    }


def small_config(name, make, remeasure=False, warm=600, steps=300):
    """Small configs are launch-overhead-bound; ``warm``/``steps`` count
    launches: with an unroll megastep one launch advances ``unroll``
    steps."""
    sim = make()
    u = getattr(sim, "_unroll", 1)
    spp = _steady_step_time(sim, warm=warm * u, steps=steps * u,
                            remeasure=remeasure)
    cells = 1
    for s in sim.cfg.S:
        cells *= s - 2
    return {
        "metric": name, "value": round(spp * 1e3, 3), "unit": "ms/step",
        "mlups": round(cells / spp / 1e6, 1),
        "baseline": "none (no reference number for this config; "
                    "tracked round-over-round)",
    }


def main():
    quick = "--quick" in sys.argv
    dev = require_gpu()          # no CPU fallback: the numbers are the card's
    from waterlily_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_lines()}

    out = headline(quick)
    out["device"] = device
    failed = []
    if not quick:
        from waterlily_tpu.models.cases import (tgv_2d, donut_3d,
                                                oscillating_plate_2d)
        secondary = []
        dense256 = {}

        def sphere256():
            spp, row = sphere_big(256)
            dense256["spp"] = spp
            return row

        def tgv256():
            spp, row = tgv3d_big(256)
            dense256["tgv_spp"] = spp
            return row

        # the full BASELINE.md benchmark set, recorded every round
        runs = [
            ("3D sphere 256^3", sphere256),
            ("256^3 1-dev shard_map", lambda: sharded_1dev(
                256, dense256.get("spp", float("nan")))),
            ("3D sphere 320^3", lambda: sphere_big(320)[1]),
            ("3D sphere 352^3", lambda: sphere_big(352)[1]),
            ("256^3 remeasure", moving_256),
            ("2D circle wall", circle_2d_wall),
            ("2D TGV 64^2", lambda: small_config(
                "2D Taylor-Green 64^2 periodic: ms/step", tgv_2d)),
            ("3D TGV 128^3", lambda: tgv3d_big(128)[1]),
            ("3D TGV 256^3", tgv256),
            ("256^3 TGV 1-dev shard_map", lambda: tgv_sharded_1dev(
                256, dense256.get("tgv_spp", float("nan")))),
            ("2D osc plate", lambda: small_config(
                "2D oscillating plate (130^2) remeasure: ms/step",
                oscillating_plate_2d, remeasure=True)),
            ("3D donut", lambda: small_config(
                "3D donut (128,64,64): ms/step", donut_3d,
                warm=300, steps=200)),
        ]
        for name, fn in runs:
            try:
                secondary.append(fn())
            except Exception as e:  # report every row, then fail the run
                secondary.append({"metric": name, "error": repr(e)})
                failed.append(name)
        out["secondary"] = secondary
    print(json.dumps(out))
    if failed:
        sys.exit(f"bench: {len(failed)} secondary run(s) failed: {failed}")


if __name__ == "__main__":
    main()
