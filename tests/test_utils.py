"""utils coverage: perf accounting, profiler hook, compile cache, and
run_record's sample-interval contract."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from waterlily_tpu.utils.perf import mlups, time_steps, trace_profile
from waterlily_tpu.utils.cache import enable_compile_cache, cache_dir
from waterlily_tpu.models.cases import tgv_2d


def test_mlups_and_time_steps():
    assert mlups((10, 10), 100, 2.0) == 100 * 100 / 2.0 / 1e6
    sim = tgv_2d(L=16)
    out = time_steps(sim, 4, warmup=2)
    assert out["dims"] == (16, 16)
    assert out["steps"] == 4
    assert out["seconds"] > 0 and out["sec_per_step"] > 0
    assert np.isclose(out["mlups"], mlups((16, 16), 4, out["seconds"]))


def test_trace_profile(tmp_path):
    with trace_profile(str(tmp_path / "trace")) as d:
        jnp.sum(jnp.ones((32, 32))).block_until_ready()
    # a trace directory with at least one event file must exist
    found = [f for root, _, fs in os.walk(d) for f in fs]
    assert found, "no profiler output written"


@pytest.mark.parametrize("from_env", [True, False])
def test_enable_compile_cache(tmp_path, monkeypatch, from_env):
    """The cache lands in $JAX_COMPILATION_CACHE_DIR when it is set, and in
    the fixed <checkout>/.jax_cache otherwise."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if from_env:
        want = str(tmp_path / "cc")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = os.path.join(repo, ".jax_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        d = enable_compile_cache()
        assert d == want == cache_dir()
        assert os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
        # idempotent
        assert enable_compile_cache() == d
    finally:
        # restore the suite-wide persistent cache (conftest) — leaving the
        # config pointed at tmp_path would silently disable caching for
        # every program compiled after this test
        if prev is not None:
            jax.config.update("jax_compilation_cache_dir", prev)


def test_run_record_sample_interval():
    """Samples must land within one time step of the requested interval —
    the chunk-sizing re-predicts as the CFL dt adapts (dt grows sharply
    during a decaying TGV, the worst case for the old one-shot sizing)."""
    sim = tgv_2d(L=32, Re=100)  # low Re -> fast decay -> fast-growing dt
    rec = sim.run_record(3.0, every=0.5)
    t = np.array(rec["t"])
    # one step can legitimately jump past a whole interval at this dt
    assert len(t) >= 4
    max_dt_nd = max(sim.dts) * sim.U / sim.L
    gaps = np.diff(np.concatenate([[0.0], t]))
    # the final sample's target clamps to t_end, so its gap may be short
    assert np.all(gaps[:-1] >= 0.5 - 1e-9), gaps
    assert np.all(gaps <= 0.5 + max_dt_nd + 1e-6), (gaps, max_dt_nd)
