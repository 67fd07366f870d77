"""Smoke tests for visualization + residual-log plotting (reference PlotsExt)."""
import os

import jax.numpy as jnp
import numpy as np

from waterlily_tpu.simulation import Simulation
from waterlily_tpu.body import AutoBody
from waterlily_tpu.io.plots import flood, body_plot, plot_logger
from waterlily_tpu.metrics import curl


def test_flood_and_body_plot(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    body = AutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - 16.0) ** 2)) - 4)
    sim = Simulation((32, 32), (1, 0), 8, nu=0.03, body=body, dtype=jnp.float32)
    sim.sim_step()
    w = np.asarray(curl(2, sim.flow.u))
    fig, ax = plt.subplots()
    flood(w, ax=ax)
    body_plot(sim, ax=ax)
    out = str(tmp_path / "flood.png")
    fig.savefig(out)
    plt.close(fig)
    assert os.path.getsize(out) > 0


def test_sim_gif_smoke(tmp_path):
    """2-frame gif from a tiny circle sim (reference sim_gif!,
    PlotsExt.jl:41-52) — the one L7 entry point previously untested."""
    body = AutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - 16.0) ** 2)) - 4)
    sim = Simulation((32, 32), (1, 0), 8, nu=0.03, body=body,
                     dtype=jnp.float32)
    from waterlily_tpu.io.plots import sim_gif
    out = str(tmp_path / "smoke.gif")
    got = sim_gif(sim, out, duration=0.02, step=0.01, verbose=False,
                  plotbody=True)
    assert got == out and os.path.getsize(out) > 0
    assert open(out, "rb").read(6) in (b"GIF87a", b"GIF89a")


def test_log_captured_by_fast_stepping_paths(tmp_path):
    """`steps()`/`run_until` capture one (predictor, corrector) trace pair
    per completed step, exactly like `step()` (the
    reference's @log is unconditional, src/util.jl:4-24) — and `write_log`
    emits one phase block per captured trace."""
    sim = Simulation((32, 32), (1, 0), 8, nu=0.03, dtype=jnp.float32,
                     log=True, unroll=2)
    sim.steps(3)                   # one 2-step megastep + 1 single step
    assert len(sim.res_log) == 3
    sim.run_until(sim.sim_time + 1e-9, chunk=2)   # one 2-step chunk
    assert len(sim.res_log) == 5
    assert all(tr.shape == sim.res_log[0].shape for tr in sim.res_log)
    # scan path (below the loop threshold): force it
    sim._loop_threshold = 10 ** 9
    sim.steps(2)
    assert len(sim.res_log) == 7
    logf = str(tmp_path / "fastpath.log")
    sim.write_log(logf)
    txt = open(logf).read()
    assert txt.count("\np\n") == 7 and txt.count("\nc\n") == 7


def test_residual_log_roundtrip(tmp_path):
    body = AutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - 16.0) ** 2)) - 4)
    sim = Simulation((32, 32), (1, 0), 8, nu=0.03, body=body,
                     dtype=jnp.float32, log=True)
    sim.step(remeasure=False)
    sim.step(remeasure=False)
    logf = str(tmp_path / "WaterLily.log")
    sim.write_log(logf)
    txt = open(logf).read()
    assert txt.startswith("p/c, iter")
    assert "\np\n" in txt and "\nc\n" in txt
    png = plot_logger(logf, out=str(tmp_path / "res.png"))
    assert os.path.getsize(png) > 0
