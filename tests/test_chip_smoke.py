"""chip_smoke.py's phases and chip_trace.py's reducer at tiny sizes on the
CPU: the script's control flow, comparisons and trace reduction are
checked here; its timings and the card's compiler only on a GPU."""
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import chip_trace  # noqa: E402
from waterlily_tpu.models.cases import (sphere_3d, tgv_3d,  # noqa: E402
                                        heaving_sphere_3d)

CPU = lambda n: n.startswith("/host:CPU")   # noqa: E731


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_main_refuses_cpu_before_any_result(capsys):
    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def _fake(u, dt, pois):
    return types.SimpleNamespace(
        flow=types.SimpleNamespace(u=np.asarray(u), dt=dt), pois_n=pois)


@pytest.mark.parametrize("du,ddt,pois_b,ok", [
    (0.0, 0.0, [[3, 2], [2, 1], [2, 1], [2, 1]], True),
    (1e-4, 5e-5, [[5, 2], [2, 1], [2, 1], [2, 1]], True),    # transient +2
    (3e-4, 0.0, [[3, 2], [2, 1], [2, 1], [2, 1]], False),    # du
    (0.0, 2e-4, [[3, 2], [2, 1], [2, 1], [2, 1]], False),    # dt
    (0.0, 0.0, [[3, 2], [2, 1], [2, 1], [2, 2]], False),     # steady pois
    (0.0, 0.0, [[6, 2], [2, 1], [2, 1], [2, 1]], False),     # transient > 2
])
def test_compare_runs_criterion(du, ddt, pois_b, ok):
    a = _fake(np.zeros((3, 4, 4, 4)), 0.5, [[3, 2], [2, 1], [2, 1], [2, 1]])
    b = _fake(np.full((3, 4, 4, 4), du), 0.5 + ddt, pois_b)
    assert chip_smoke.compare_runs(a, b)["ok"] is ok


def test_phase_reference_tiny():
    d0, d1 = jax.devices()[:2]
    res = chip_smoke.phase_reference(d0, d1, n=16, m=16, steps=3)
    assert res["ok"] and res["du"] == 0.0
    assert res["force_center_rel"] == 0.0


@pytest.fixture(scope="module")
def tiny_full_width():
    return chip_smoke.phase_full_width(
        chip_smoke.prepare(lambda: sphere_3d(n=16, m=16, Re=3700,
                                             dtype=jnp.float32)),
        warm=1, steps=2)


def test_phase_full_width_tiny(tiny_full_width):
    sim, res, hlo = tiny_full_width
    assert res["finite"] and res["ms_per_step"] > 0
    assert res["arg_bytes"] > 0 and "HloModule" in hlo


def test_phase_trace_tiny(tiny_full_width):
    """The reducer finds the step's phases in a real (CPU) trace."""
    sim, _, hlo = tiny_full_width
    res = chip_smoke.phase_trace(sim, hlo, steps=1, copy_mib=1,
                                 plane_pred=CPU)
    assert res["events"] > 0 and res["fine_matvecs"] > 0
    for k in ("conv_diff", "pressure_solve", "bc", "cfl"):
        assert res[f"{k}_ms"] > 0, (k, res)
    assert res["copy_GBps"] > 0 and 0 < res["busy_share"] <= 1


def test_phase_periodic_tiny():
    prepared = chip_smoke.prepare(lambda: tgv_3d(L=16, dtype=jnp.float32))
    assert chip_smoke.phase_periodic(prepared, steps=2)["finite"]


def test_phase_moving_tiny():
    prepared = chip_smoke.prepare(lambda: heaving_sphere_3d(
        radius=4, amp=2, Re=100, dtype=jnp.float32), remeasure=True)
    assert chip_smoke.phase_moving(prepared, steps=2)["finite"]


def test_run_one_card_tiny(capsys):
    """The one-card orchestration (worker-thread compiles, every phase in
    order) at tiny sizes, device 0 against device 1."""
    sizes = dict(ref_n=16, ref_m=16, ref_steps=2, n=16, warm=1, steps=2,
                 trace_steps=1, copy_mib=1, L=16, tgv_steps=2, radius=4,
                 amp=2, Re=100, moving_steps=2, grad_L=8)
    d0, d1 = jax.devices()[:2]
    chip_smoke.run_one_card(d0, d1, sizes=sizes, plane_pred=CPU)
    out = capsys.readouterr().out
    for phase in ("reference", "full_width", "trace", "periodic", "moving",
                  "gradient"):
        assert f"[wall] phase={phase}" in out, phase


def test_phase_gradient_tiny():
    d0, d1 = jax.devices()[:2]
    res = chip_smoke.phase_gradient(d0, d1, L=8)
    assert res["finite"] and res["rel"] == 0.0


def test_phase_four_cards_tiny():
    """The 4-device sharded path against the dense step on device 0."""
    out = chip_smoke.phase_four_cards(jax.devices()[:4], n=16, L=16, steps=2)
    for name in ("sphere", "tgv"):
        assert out[name]["ok"] and len(out[name]["devices"]) == 4


def test_hlo_scopes_maps_fusions_to_named_scopes():
    @jax.jit
    def f(x):
        with jax.named_scope("conv_diff"):
            y = jnp.sin(x) * 2 + 1
        with jax.named_scope("cfl"):
            return jnp.max(y)

    hlo = f.lower(jnp.ones((16, 16))).compile().as_text()
    scopes = chip_trace.hlo_scopes(hlo)
    phases = {chip_trace.phase_of(p) for p in scopes.values()}
    assert {"conv_diff", "cfl"} <= phases


def test_reduce_phases_and_busy_share():
    scopes = {"f.1": ["jit(s)/conv_diff/add"], "f_2": ["jit(s)/bc/x"],
              "g": ["jit(s)/pressure_solve/pcg_matvec/mul"]}
    ev = [("f.1", "f.1", 10.0, 0.0), ("k", "f_2", 5.0, 10.0),
          ("g", None, 20.0, 20.0), ("memcpy", None, 5.0, 40.0)]
    red = chip_trace.reduce_phases(ev, scopes, sub="pcg_matvec")
    assert red == {"total": 40.0, "conv_diff": 10.0, "bc": 5.0,
                   "pressure_solve": 20.0, "pcg_matvec": 20.0,
                   "unmapped": 5.0}
    # busy 10 + 5 + 20 + 5 over a 45 ns window (gap 15-20)
    assert chip_trace.busy_share(ev) == pytest.approx(40.0 / 45.0)


def test_package_source_has_no_mosaic_kernel_tier():
    """No Mosaic kernel import or backend branch for the previous
    accelerator is left in the package."""
    tp = "tp" + "u"          # spelled apart so the guard does not find itself
    bad = (f"pallas.{tp}", f"pl{tp}", f'default_backend() == "{tp}"',
           f"default_backend() == '{tp}'")
    hits = []
    for p in (REPO / "waterlily_tpu").rglob("*.py"):
        text = p.read_text()
        hits += [f"{p.name}: {b}" for b in bad if b in text]
    assert not hits, hits
