"""Performance regression gates.

The reference's alloctest.jl asserts <50 KiB host allocations per step (an
allocation-regression gate).  The XLA analog: the jitted step must compile
exactly once — repeated stepping (including the adaptive dt, which must be
a traced value, never a Python float) may not trigger retraces.
"""
import jax
import jax.numpy as jnp
import numpy as np

from waterlily_tpu.body import AutoBody
from waterlily_tpu.simulation import Simulation

f32 = jnp.float32


def plate_sim(perdir=()):
    N = 32
    body = AutoBody(lambda x, t: jnp.abs(x[1] - N / 2) - 2)
    return Simulation((N, N), (1, 0), N, nu=0.01, body=body, dtype=f32,
                      perdir=perdir)


def test_no_recompilation_static():
    sim = plate_sim()
    for _ in range(4):
        sim.step(remeasure=False)
    assert sim._step_static._cache_size() == 1


def test_no_recompilation_remeasure():
    sim = plate_sim()
    for _ in range(4):
        sim.step(remeasure=True)
    assert sim._step_remeasure._cache_size() == 1


def test_no_recompilation_periodic_wall_configs():
    # both wall and periodic configs stay stable (alloctest.jl runs both)
    sim = plate_sim(perdir=(0,))
    for _ in range(3):
        sim.step(remeasure=False)
    assert sim._step_static._cache_size() == 1


def test_steps_single_compile():
    """steps() batches (default: donated host loop) never retrace."""
    sim = plate_sim()
    sim.steps(3, remeasure=False)
    sim.steps(3, remeasure=False)
    assert sim._step_static_d._cache_size() == 1
    assert not np.any(np.isnan(np.asarray(sim.flow.u)))
    assert len(sim.pois_n) == 6  # aux history recorded per step


def test_scan_steps_single_compile():
    """The on-device lax.scan path (opt-in above _loop_threshold) compiles
    once and matches the host-loop trajectory."""
    sim = plate_sim()
    sim.steps(4, remeasure=False)
    ref = np.asarray(sim.flow.u)
    sim2 = plate_sim()
    sim2._loop_threshold = 10 ** 12  # force the scan path
    sim2.steps(2, remeasure=False)
    sim2.steps(2, remeasure=False)
    assert sim2._scan_steps._cache_size() == 1
    assert np.allclose(ref, np.asarray(sim2.flow.u), atol=1e-6)


def test_dts_complete_on_every_path():
    """Invariant: len(sim.dts) == total_steps + 1 (the initial dt plus one
    per completed step) on step(), steps() and the scan path — reference
    semantics: flow.Δt carries the FULL history (src/Flow.jl:105,168)."""
    sim = plate_sim()
    sim.step(remeasure=False)
    sim.steps(3, remeasure=False)
    assert len(sim.dts) == 4 + 1
    sim2 = plate_sim()
    sim2._loop_threshold = 10 ** 12  # force the scan path
    sim2.steps(4, remeasure=False)
    assert len(sim2.dts) == 4 + 1
    # the histories agree step-by-step, not just in length
    assert np.allclose(sim.dts, sim2.dts, atol=1e-6)
    # remeasure path too
    sim3 = plate_sim()
    sim3.steps(2, remeasure=True)
    assert len(sim3.dts) == 2 + 1


def test_unroll_megastep_matches_host_loop():
    """Simulation(unroll=k) composes k steps into one program; the
    trajectory and the dt/pois_n histories must match the single-step
    host loop, including a batch size not divisible by k."""
    N = 32
    body = AutoBody(lambda x, t: jnp.abs(x[1] - N / 2) - 2)
    kw = dict(nu=0.01, body=body, dtype=f32)
    ref = Simulation((N, N), (1, 0), N, **kw)
    ref.steps(5, remeasure=True)
    un = Simulation((N, N), (1, 0), N, unroll=3, **kw)
    un.steps(5, remeasure=True)  # one k=3 megastep + 2 single-step remainder
    assert len(un.dts) == 5 + 1
    assert np.allclose(ref.dts, un.dts, atol=1e-6)
    assert [tuple(p) for p in ref.pois_n] == [tuple(p) for p in un.pois_n]
    assert np.allclose(np.asarray(ref.flow.u), np.asarray(un.flow.u),
                       atol=1e-5)
    # remainders reuse the single-step program: exactly ONE megastep variant
    # regardless of batch size (run_record's chunk ramp must not compile one
    # program per distinct size)
    un.steps(3, remeasure=True)
    un.steps(4, remeasure=True)
    assert un._steps_k._cache_size() == 1

def test_megastep_launch_count():
    """The megastep launch contract: steps(n) with unroll=k must issue
    exactly n//k megastep launches + (n%k) single-step launches — a silent
    fall-through to per-step launches would re-open the per-launch cost
    without failing any trajectory test."""
    N = 32
    body = AutoBody(lambda x, t: jnp.abs(x[1] - N / 2) - 2)
    for remeasure in (False, True):
        sim = Simulation((N, N), (1, 0), N, nu=0.01, body=body, dtype=f32,
                         unroll=8)
        counts = {"mega": 0, "single": 0}
        mega = sim._steps_k
        single = sim._step_remeasure_d if remeasure else sim._step_static_d

        def mega_spy(*a, **k):
            counts["mega"] += 1
            return mega(*a, **k)

        def single_spy(*a, **k):
            counts["single"] += 1
            return single(*a, **k)

        sim._steps_k = mega_spy
        if remeasure:
            sim._step_remeasure_d = single_spy
        else:
            sim._step_static_d = single_spy
        sim.steps(20, remeasure=remeasure)
        assert counts == {"mega": 2, "single": 4}, (remeasure, counts)
        assert len(sim.dts) == 20 + 1
        assert len(sim.pois_n) == 20


def test_unroll_auto_default(monkeypatch):
    """The default is one step per program on every backend (the megastep
    is opt-in until it is measured on the card); an explicit unroll always
    applies."""
    assert plate_sim()._unroll == 1  # cpu backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    sim = Simulation((16, 16), (1, 0), 16, dtype=f32)
    assert sim._unroll == 1
    sim = Simulation((16, 16), (1, 0), 16, dtype=f32, unroll=2)
    assert sim._unroll == 2
