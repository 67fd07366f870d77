"""Test configuration: force CPU with an 8-device virtual mesh.

The suite runs on the CPU; sharding tests run on a virtual 8-device CPU
mesh exactly as `__graft_entry__.dryrun_multichip(8)` does.  What runs on
the GPU is checked by `chip_smoke.py`, whose phase functions the suite
calls at tiny sizes on the CPU.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compile cache: jit programs dominate suite wall time; warm
# reruns skip compilation entirely.  min_compile_secs=0
# caches even sub-second programs — the suite compiles hundreds of them.
from waterlily_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.0)

# --- suite wall-time budget -------------------------------------------------
# The suite's warm wall time is budgeted: growth
# must be a decision, not drift.  CI sets WATERLILY_SUITE_BUDGET_S; when the
# suite exceeds it the run FAILS with a per-file cost report so the
# regressing tests are visible.  Local runs always get the report.

import time as _time  # noqa: E402

_t0 = _time.time()
_file_times: dict = {}


def pytest_runtest_logreport(report):
    if report.when == "call":
        fname = report.nodeid.split("::")[0]
        _file_times[fname] = _file_times.get(fname, 0.0) + report.duration


def pytest_sessionfinish(session, exitstatus):
    total = _time.time() - _t0
    budget = float(os.environ.get("WATERLILY_SUITE_BUDGET_S", "0") or 0)
    tr = session.config.pluginmanager.get_plugin("terminalreporter")
    lines = [f"suite wall time: {total:.0f} s"
             + (f" (budget {budget:.0f} s)" if budget else "")]
    for f, t in sorted(_file_times.items(), key=lambda kv: -kv[1])[:6]:
        lines.append(f"  {f}: {t:.0f} s")
    if tr is not None:
        tr.write_line("\n".join(lines))
    if budget and total > budget and exitstatus == 0:
        if tr is not None:
            tr.write_line(
                f"FAILED: suite wall time {total:.0f} s exceeds the "
                f"WATERLILY_SUITE_BUDGET_S={budget:.0f} s budget — trim or "
                "nightly-gate tests (tests/conftest.py)")
        session.exitstatus = 1
