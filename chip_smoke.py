"""Quickest proof that the solver runs on one NVIDIA GPU, at full width.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Phases (one card), each printing one line of results; any failure raises
and the script exits non-zero:

- device      the card (JAX's view and nvidia-smi's name + power limit);
- reference   the (96,64,64) sphere for 20 steps on the card and on the
              host CPU in this process (the plain reference), compared by
              the cross-backend criterion below;
- full_width  the 256³ sphere at Re=3700 through `Simulation.steps`:
              compile seconds, memory, ms/step, pois_n, finite fields;
- periodic    the 3D TGV at 128³ for 10 steps;
- moving      the heaving sphere (radius 64) for 10 remeasured steps;
- gradient    one implicit-diff reverse-mode gradient, card vs CPU;
- trace       device time per `mom_step` phase of the 256³ sphere from a
              `jax.profiler` window, the fine-level PCG matvec's rate and a
              streaming-copy rate (chip_trace.py).

Cross-backend criterion (f32 everywhere): the card and the CPU sum in
different orders and XLA autotunes the card's reductions, so fields agree
to the solver's tolerance, not bitwise: max|Δu| < 2e-4, |Δdt| < 1e-4,
pois_n equal over the last 3 steps and within 2 on every step.  The
reference phase applies it step by step — each card step starts from the
reference's state — because a free-running f32 trajectory of this config
is not reproducible to that bound on ANY backend: a 1e-7 relative
perturbation of the initial field, on the CPU alone, grows to
|Δu| ≈ 1.1e-3 at a few near-body cells by step 16 (solver tol 1e-4).  The
free-running difference is printed beside it.

The last line of standard output is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script raises before running anything.  Everything runs
in this one process: a second JAX process could not get the card's memory.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from waterlily_tpu.models.cases import sphere_3d, tgv_3d, heaving_sphere_3d
from waterlily_tpu.metrics import total_force, ke
from waterlily_tpu.utils.cache import enable_compile_cache
import chip_trace

f32 = jnp.float32
DU_TOL, DDT_TOL, POIS_SLACK = 2e-4, 1e-4, 2


def require_gpu():
    """The first device must be a GPU: there is no CPU fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"this run needs a GPU; JAX found "
                           f"{dev.platform!r} ({dev.device_kind})")
    return dev


def card_lines() -> list:
    """``name, power.limit`` per card from nvidia-smi (a child process that
    never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _say(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _finite(*arrays) -> bool:
    return all(bool(jnp.all(jnp.isfinite(a))) for a in arrays)


def _pois(sim):
    return [list(map(int, r)) for r in sim.pois_n]


def compare_runs(a, b) -> dict:
    """The cross-backend criterion between two finished runs (host copies:
    the two may live on different devices)."""
    du = float(np.max(np.abs(np.asarray(a.flow.u) - np.asarray(b.flow.u))))
    ddt = abs(float(a.flow.dt) - float(b.flow.dt))
    pa, pb = _pois(a), _pois(b)
    steady = pa[-3:] == pb[-3:]
    slack = all(abs(x - y) <= POIS_SLACK for ra, rb in zip(pa, pb)
                for x, y in zip(ra, rb)) and len(pa) == len(pb)
    ok = du < DU_TOL and ddt < DDT_TOL and steady and slack
    return dict(du=du, ddt=ddt, pois_last3_equal=steady,
                pois_within_2=slack, ok=ok)


def step_criterion(du, ddt, pois_a, pois_b) -> dict:
    """The cross-backend criterion over per-step differences of two
    lock-stepped runs (each step of ``a`` starts from ``b``'s state)."""
    steady = pois_a[-3:] == pois_b[-3:]
    slack = all(abs(x - y) <= POIS_SLACK for ra, rb in zip(pois_a, pois_b)
                for x, y in zip(ra, rb)) and len(pois_a) == len(pois_b)
    return dict(du=max(du), ddt=max(ddt), pois_last3_equal=steady,
                pois_within_2=slack,
                ok=max(du) < DU_TOL and max(ddt) < DDT_TOL and steady
                and slack,
                du_per_step=[f"{d:.2e}" for d in du])


def _forces(sim):
    t = sim.flow.t
    nu = sim.cfg.nu
    return {s: np.asarray(total_force(sim.flow.u, sim.flow.p, nu, sim.body,
                                      t, sampling=s))
            for s in ("center", "extrap")}


def phase_reference(dev, ref_dev, n=96, m=64, steps=20):
    """The (n,m,m) sphere stepped on ``ref_dev`` (the plain reference) for
    ``steps`` steps; before each, the card takes the same step from the
    reference's state, and the two results are compared by the
    cross-backend criterion (module docstring).  The free-running card
    trajectory and the total force under both estimators are compared and
    printed beside it."""
    with jax.default_device(ref_dev):
        ref = sphere_3d(n=n, m=m, dtype=f32)
    with jax.default_device(dev):
        card = sphere_3d(n=n, m=m, dtype=f32)
        free = sphere_3d(n=n, m=m, dtype=f32)
    du, ddt, pois_card = [], [], []
    for _ in range(steps):
        with jax.default_device(dev):
            out, aux = card._step_static(jax.device_put(ref.flow, dev),
                                         card.levels)
        with jax.default_device(ref_dev):
            ref.steps(1, remeasure=False)
        du.append(float(np.max(np.abs(np.asarray(out.u)
                                      - np.asarray(ref.flow.u)))))
        ddt.append(abs(float(out.dt) - float(ref.flow.dt)))
        pois_card.append(list(map(int, aux["pois_n"])))
    card.flow = out
    with jax.default_device(dev):
        free.steps(steps, remeasure=False)
        f_card, f_free = _forces(card), _forces(free)
    with jax.default_device(ref_dev):
        f_ref = _forces(ref)
    pois_ref = _pois(ref)
    res = step_criterion(du, ddt, pois_card, pois_ref)
    res.update(pois_card=pois_card[-3:], pois_ref=pois_ref[-3:])
    rel = lambda a, b: float(np.linalg.norm(a - b)
                             / max(np.linalg.norm(b), 1e-30))
    for s in f_ref:
        res[f"force_{s}_rel"] = rel(f_card[s], f_ref[s])
    free_cmp = compare_runs(free, ref)
    res.update(free_du=free_cmp["du"], free_ddt=free_cmp["ddt"],
               free_pois_equal=_pois(free) == pois_ref,
               **{f"free_force_{s}_rel": rel(f_free[s], f_ref[s])
                  for s in f_ref})
    _say("reference", **res)
    if not (res["ok"] and _finite(out.u, out.p, free.flow.u)
            and all(np.isfinite(v).all() for v in f_card.values())):
        raise AssertionError(f"reference phase out of tolerance: {res}")
    return res


def prepare(make, remeasure=False):
    """Build ``make()``'s Simulation and AOT-compile its donated step
    program.  `run_one_card` runs these on worker threads so the big
    compiles overlap each other and the reference phase; the persistent
    compile cache (`enable_compile_cache`) hands the result to the
    Simulation's own jit on its first call.  Returns
    ``(sim, compiled, compile_seconds)``."""
    sim = make()
    fn = sim._step_remeasure_d if remeasure else sim._step_static_d
    t0 = time.perf_counter()
    compiled = fn.lower(sim.flow, sim.levels).compile()
    return sim, compiled, time.perf_counter() - t0


def phase_full_width(prepared, warm=5, steps=20, card=""):
    """The 256³ sphere at Re=3700 (``prepare``d) through
    `Simulation.steps`: compile seconds, memory analysis of the step,
    ms/step over ``steps`` steps after ``warm`` (ending in
    block_until_ready), finite fields."""
    sim, compiled, t_compile = prepared
    n = sim.cfg.S[0] - 2
    mem = compiled.memory_analysis()
    sim.steps(warm, remeasure=False)
    jax.block_until_ready(sim.flow.u)
    t0 = time.perf_counter()
    sim.steps(steps, remeasure=False)
    jax.block_until_ready(sim.flow.u)
    spp = (time.perf_counter() - t0) / steps
    stats = jax.devices()[0].memory_stats() or {}
    res = dict(
        n=n, compile_s_concurrent=round(t_compile, 3),
        temp_bytes=int(getattr(mem, "temp_size_in_bytes", -1)),
        arg_bytes=int(getattr(mem, "argument_size_in_bytes", -1)),
        out_bytes=int(getattr(mem, "output_size_in_bytes", -1)),
        alias_bytes=int(getattr(mem, "alias_size_in_bytes", -1)),
        peak_bytes_in_use=int(stats.get("peak_bytes_in_use", -1)),
        ms_per_step=spp * 1e3, ns_per_dof=spp / (3 * n ** 3) * 1e9,
        pois_last=_pois(sim)[-1], card=repr(card),
        finite=_finite(sim.flow.u, sim.flow.p))
    _say("full_width", **res)
    if not res["finite"]:
        raise AssertionError("full_width: non-finite u or p")
    return sim, res, compiled.as_text()


def phase_periodic(prepared, steps=10):
    """The fully periodic 3D TGV (wrap halos on every axis)."""
    sim, _compiled, t_compile = prepared
    sim.steps(steps)
    jax.block_until_ready(sim.flow.u)
    res = dict(L=sim.cfg.S[0] - 2, steps=steps, pois=_pois(sim)[-3:],
               ke=float(jnp.sum(ke(sim.flow.u))),
               compile_s_concurrent=round(t_compile, 3),
               finite=_finite(sim.flow.u, sim.flow.p))
    _say("periodic", **res)
    if not res["finite"]:
        raise AssertionError("periodic: non-finite u or p")
    return res


def phase_moving(prepared, steps=10):
    """The heaving sphere with a body remeasure every step."""
    sim, _compiled, t_compile = prepared
    sim.steps(steps, remeasure=True)
    jax.block_until_ready(sim.flow.u)
    res = dict(n=sim.cfg.S[0] - 2, steps=steps, pois=_pois(sim)[-3:],
               banded=sim.cfg.bbox_shape is not None,
               compile_s_concurrent=round(t_compile, 3),
               finite=_finite(sim.flow.u, sim.flow.p))
    _say("moving", **res)
    if not res["finite"]:
        raise AssertionError("moving: non-finite u or p")
    return res


def _grad_ke_nu(L):
    """d(KE after 2 implicit-diff steps)/d(nu) on a periodic 3D TGV — the
    scalar of tests/test_grad.py's full-step oracle, in 3D and f32.
    Returns the jitted gradient and its argument on the default device."""
    from waterlily_tpu.flow import FlowConfig, flow_init, mom_step
    from waterlily_tpu.ops.multigrid import build_levels
    k = 2 * np.pi / L

    def ulam(i, x):
        if i == 0:
            return jnp.sin(k * x[0]) * jnp.cos(k * x[1]) * jnp.cos(k * x[2])
        if i == 1:
            return -jnp.cos(k * x[0]) * jnp.sin(k * x[1]) * jnp.cos(k * x[2])
        return jnp.zeros_like(x[0])

    def ke_after(nu):
        cfg = FlowConfig(D=3, S=(L + 2,) * 3, nu=nu, U=(0.0, 0.0, 0.0),
                         perdir=(0, 1, 2), dtype=f32, tol=1e-8, itmx=64,
                         implicit_diff=True)
        state = flow_init(cfg, ulam)
        levels = build_levels(state.mu0, cfg.perdir)

        def body(s, _):
            s, _aux = mom_step(cfg, levels, s)
            return s, None

        state, _ = jax.lax.scan(body, state, None, length=2)
        return jnp.sum(ke(state.u))

    return jax.jit(jax.grad(ke_after)), jnp.asarray(1.0 / (k * 100.0), f32)


def compile_gradient(devices, L):
    """AOT-compile the gradient program for each of ``devices`` (on a
    worker thread of `run_one_card`; the persistent compile cache hands
    the results to `phase_gradient`)."""
    for d in devices:
        with jax.default_device(d):
            fn, nu0 = _grad_ke_nu(L)
            fn.lower(nu0).compile()


def phase_gradient(dev, ref_dev, L=8):
    """One reverse-mode gradient on the card and on the CPU reference."""
    def grad_on(d):
        with jax.default_device(d):
            fn, nu0 = _grad_ke_nu(L)
            return float(fn(nu0))

    g, g_ref = grad_on(dev), grad_on(ref_dev)
    rel = abs(g - g_ref) / max(abs(g_ref), 1e-30)
    res = dict(L=L, grad=g, grad_ref=g_ref, rel=rel,
               finite=bool(np.isfinite(g)))
    _say("gradient", **res)
    if not (res["finite"] and rel < 1e-3):
        raise AssertionError(f"gradient: {res}")
    return res


def copy_rate(mib=1024, reps=50) -> float:
    """Bytes/s of a large on-device streaming copy (``x + 1``: one read and
    one write of ``mib`` MiB per call), host clock over ``reps`` calls."""
    n = mib * 2 ** 20 // 4
    f = jax.jit(lambda x: x + 1.0, donate_argnums=0)
    x = f(jnp.zeros((n,), f32))
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = f(x)
    jax.block_until_ready(x)
    return 2 * 4 * n * reps / (time.perf_counter() - t0)


def phase_trace(sim, hlo, steps=3, copy_mib=1024, plane_pred=None):
    """Device time per `mom_step` phase over ``steps`` traced steps of
    ``sim`` (its own window, after the timed run; ``hlo`` is the compiled
    step's HLO text), the fine-level PCG matvec's achieved rate against its
    minimal bytes, and the copy rate.

    Minimal matvec bytes on the fine level: L (D fields), the diagonal and
    x read, z written — (D+3) fields of the padded grid, f32."""
    scopes = chip_trace.hlo_scopes(hlo)
    lines = chip_trace.hlo_lines(hlo)
    S = sim.cfg.S
    fine = ",".join(map(str, S))
    sim.steps(2, remeasure=False)
    jax.block_until_ready(sim.flow.u)
    n0 = len(sim.pois_n)
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            sim.steps(steps, remeasure=False)
            jax.block_until_ready(sim.flow.u)
        ev = chip_trace.device_events(d, plane_pred)
    on_fine = lambda k: fine in lines.get(k, "")          # noqa: E731
    red = chip_trace.reduce_phases(ev, scopes, sub="pcg_matvec",
                                   select=on_fine)
    fine_solve_ns = chip_trace.reduce_phases(
        ev, scopes, sub="pressure_solve", select=on_fine).get(
            "pressure_solve", 0.0)
    n_outer = int(np.sum(np.asarray(sim.pois_n[n0:])))
    n_mv = 6 * n_outer                      # pcg it=6 on the fine level
    mv_bytes = (len(S) + 3) * math.prod(S) * 4
    mv_ns = red.get("pcg_matvec", 0.0)
    mv_rate = mv_bytes * n_mv / (mv_ns * 1e-9) if mv_ns else float("nan")
    cr = copy_rate(copy_mib)
    per_step = {k: v / steps / 1e6 for k, v in red.items()}
    res = dict(steps=steps, events=len(ev),
               busy_share=chip_trace.busy_share(ev),
               **{f"{k}_ms": round(per_step.get(k, 0.0), 4)
                  for k in chip_trace.PHASES + ("other", "unmapped",
                                                "total")},
               fine_solve_ms=round(fine_solve_ns / steps / 1e6, 4),
               fine_matvecs=n_mv, matvec_ms=round(mv_ns / 1e6 / max(n_mv, 1), 5),
               matvec_GBps=mv_rate / 1e9, copy_GBps=cr / 1e9,
               matvec_over_copy=mv_rate / cr)
    _say("trace", **res)
    total = per_step.get("total", 0.0) or 1.0
    for k in chip_trace.PHASES + ("other", "unmapped"):
        v = per_step.get(k, 0.0)
        print(f"    {k:>15} {v:10.4f} ms/step {100 * v / total:6.1f} %")
    top = sorted(((d, n) for n, _h, d, _s in ev), reverse=True)
    agg = {}
    for d, n in top:
        agg[n] = agg.get(n, 0.0) + d
    for n, d in sorted(agg.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    kernel {d / steps / 1e6:9.4f} ms/step  {n[:90]}")
    if not ev:
        raise AssertionError("trace: no device events recorded")
    return res


def phase_four_cards(devices, n=256, L=128, steps=6):
    """The sharded path on ``devices`` (Simulation(mesh=mesh_for(...))):
    the n³ sphere and the L³ TGV against the dense step on the first
    device, by the cross-backend criterion.  All four step programs
    (dense and sharded, per case) compile at once on worker threads."""
    from waterlily_tpu.parallel.mesh import mesh_for
    cases = (("sphere", functools.partial(sphere_3d, n=n, m=n, Re=3700,
                                          dtype=f32), (n + 2,) * 3),
             ("tgv", functools.partial(tgv_3d, L=L, dtype=f32), (L + 2,) * 3))
    meshes = {}
    for name, _make, S in cases:
        mesh = mesh_for(S, len(devices), devices=devices)
        if len({d.id for d in mesh.devices.flat}) != len(devices):
            raise AssertionError(f"mesh_for reused devices: {mesh}")
        meshes[name] = mesh
    out = {}
    with ThreadPoolExecutor(max_workers=2 * len(cases)) as pool:
        # the dense Simulation lands on the default device, devices[0]
        futs = {(name, mesh): pool.submit(
                    prepare, functools.partial(make, mesh=mesh))
                for name, make, _S in cases
                for mesh in (None, meshes[name])}
        for name, make, _S in cases:
            dense = futs.pop((name, None)).result()[0]
            sh, _compiled, t_compile = futs.pop((name, meshes[name])).result()
            place = jax.tree.map(lambda a: a.sharding, sh.flow)
            # lock-step, as in the reference phase: each sharded step starts
            # from a copy of the dense state (the step donates its input,
            # and device_put may alias a leaf already on its target device)
            du, ddt, pois_sh = [], [], []
            for _ in range(steps):
                start = jax.device_put(jax.tree.map(jnp.copy, dense.flow),
                                       place)
                one, aux = sh._step_static_d(start, sh.levels)
                jax.block_until_ready(one.u)
                dense.steps(1, remeasure=False)
                du.append(float(np.max(np.abs(np.asarray(one.u)
                                              - np.asarray(dense.flow.u)))))
                ddt.append(abs(float(one.dt) - float(dense.flow.dt)))
                pois_sh.append(list(map(int, aux["pois_n"])))
            res = step_criterion(du, ddt, pois_sh, _pois(dense))
            # then the sharded run free from t=0, printed beside
            t0 = time.perf_counter()
            sh.steps(steps, remeasure=False)
            jax.block_until_ready(sh.flow.u)
            wall = time.perf_counter() - t0
            free = compare_runs(sh, dense)
            mesh = meshes[name]
            res.update(mesh=dict(zip(mesh.axis_names, mesh.devices.shape)),
                       devices=sorted(d.id for d in mesh.devices.flat),
                       pois_sharded=pois_sh[-3:],
                       pois_dense=_pois(dense)[-3:],
                       free_du=free["du"], free_ddt=free["ddt"],
                       free_pois_equal=_pois(sh) == _pois(dense),
                       compile_s_concurrent=round(t_compile, 3),
                       steps_s_free=round(wall, 3),
                       finite=_finite(one.u, one.p, sh.flow.u))
            _say(f"four_cards_{name}", **res)
            out[name] = res
            del dense, sh, one, start
            gc.collect()
    bad = {k: v for k, v in out.items() if not (v["ok"] and v["finite"])}
    if bad:
        raise AssertionError(f"four_cards: {bad}")
    return out


FULL = dict(ref_n=96, ref_m=64, ref_steps=20, n=256, warm=5, steps=20,
            trace_steps=3, copy_mib=1024, L=128, tgv_steps=10, radius=64,
            amp=32, Re=500, moving_steps=10, grad_L=8)


def run_one_card(dev, ref_dev, card="", sizes=FULL, plane_pred=None):
    """Every one-card phase in order; the three big step programs and the
    gradient programs compile on worker threads meanwhile (`prepare`,
    `compile_gradient`).  Prints each phase's wall seconds."""
    z = sizes
    with ThreadPoolExecutor(max_workers=4) as pool:
        fut_grad = pool.submit(compile_gradient, (dev, ref_dev),
                               z["grad_L"])
        fut_fw = pool.submit(prepare, lambda: sphere_3d(
            n=z["n"], m=z["n"], Re=3700, dtype=f32))
        fut_tgv = pool.submit(prepare, lambda: tgv_3d(L=z["L"], dtype=f32))
        fut_mv = pool.submit(prepare, lambda: heaving_sphere_3d(
            radius=z["radius"], amp=z["amp"], Re=z["Re"], dtype=f32),
            remeasure=True)
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            t1 = time.perf_counter()
            _say("wall", phase=name, seconds=round(t1 - t0, 3))
            t0 = t1

        phase_reference(dev, ref_dev, z["ref_n"], z["ref_m"], z["ref_steps"])
        lap("reference")
        sim, _, hlo = phase_full_width(fut_fw.result(), z["warm"],
                                       z["steps"], card)
        lap("full_width")
        phase_trace(sim, hlo, z["trace_steps"], z["copy_mib"], plane_pred)
        lap("trace")
        del sim
        gc.collect()
        phase_periodic(fut_tgv.result(), z["tgv_steps"])
        lap("periodic")
        phase_moving(fut_mv.result(), z["moving_steps"])
        lap("moving")
        fut_grad.result()
    phase_gradient(dev, ref_dev, z["grad_L"])
    lap("gradient")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its check")
    args = ap.parse_args(argv)

    dev = require_gpu()
    cache = enable_compile_cache()
    cards = card_lines()
    devices = jax.devices()
    _say("device", platform=dev.platform, kind=repr(dev.device_kind),
         count=len(devices), jax=jax.__version__, cache=cache)
    print("nvidia-smi name, power.limit:")
    for ln in cards:
        print(ln)
    sys.stdout.flush()

    if args.four_cards:
        if len(devices) < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                               f"{len(devices)}")
        phase_four_cards(devices[:4])
    else:
        run_one_card(dev, jax.devices("cpu")[0], card=cards[0])

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
