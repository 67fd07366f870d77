"""User-facing Simulation API.

Re-design of the reference entry point (src/WaterLily.jl:59-121).
A `Simulation` couples the velocity/length scales, the flow state, the body,
and the multigrid level stack.  The whole time step — optional body
re-measurement, BDIM predictor/corrector, two multigrid pressure solves and
the CFL reduction — is one jitted XLA program; the host only checks the
dimensionless-time stopping criterion between steps (exactly the data the
reference syncs for its `while sim_time < t_end` loop).

For benchmarking, `steps(n)` advances n steps with no host synchronisation
until the final fetch (an async loop over the donated single-step program).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .flow import FlowConfig, flow_init, mom_step
from .body import (NoBody, measure_fields, measure_fields_banded,
                   band_box_shape)
from .grid import band_box_start
from .ops.multigrid import build_levels
from .ops.convect import quick

__all__ = ["Simulation", "sim_time"]


class Simulation:
    """Immersed-boundary incompressible flow simulation.

    Arguments mirror the reference constructor (src/WaterLily.jl:33-55):

    - ``dims``: interior grid dimensions (2- or 3-tuple).
    - ``u_BC``: domain boundary velocity — tuple, or time function ``f(i,t)``.
    - ``L``: length scale; ``U``: velocity scale (default ``|u_BC|``).
    - ``dt``: initial time step; ``nu``: kinematic viscosity.
    - ``g``: body acceleration ``g(i,t)``; ``epsilon``: BDIM kernel width.
    - ``perdir``: periodic directions (0-based); ``exitBC``: convective outlet.
    - ``ulam``: initial velocity field ``uλ(i,x)``; ``body``: immersed geometry.
    - ``dtype``: array dtype (any float; f32 on accelerators).
    - ``mesh``: a `jax.sharding.Mesh` for spatial domain decomposition (the
      scaling path the reference lacks).  Fields are constrained along the
      mesh's spatial axes inside every jitted program; GSPMD inserts halo
      exchanges and collective reductions between devices.
    - ``fixed_iters``: statically unroll exactly k pressure iterations per
      solve instead of the adaptive `while_loop` — makes the whole step
      reverse-mode differentiable (``jax.grad`` through ``mom_step``), the
      beyond-parity extension of the reference's forward-only ForwardDiff
      scope (maintests.jl:254-278).
    - ``implicit_diff``: reverse-mode via the implicit-function theorem
      instead of unrolling — the pressure solve keeps its adaptive
      `while_loop` and ``jax.grad`` costs ONE
      adjoint Poisson solve with the same multigrid stack, rather than
      storing every smoother iterate of a ``fixed_iters`` unroll.  The
      memory-feasible adjoint path at 256³-class grids.  Gradients assume
      converged solves (tighten ``tol`` for sensitive losses); forward-mode
      (`jax.jvp`) is not supported through it — use the default config or
      ``fixed_iters`` for jvp.  Mutually exclusive with both.
    - ``banded_levels``: opt-in banded (windowed) Poisson operator on the
      multigrid levels.  Off by default: its per-smoother-iteration window
      fix-ups cost more than the coefficient reads they save at 256³.
    - ``unroll``: compose this many steps into ONE jitted program for the
      `steps()` batching loop — amortizes the per-launch cost on
      launch-bound small grids.  Program size and compile time grow ∝
      unroll.  Default 1.
    """

    def __init__(self, dims, u_BC, L, dt=0.25, nu=0.0, g=None, U=None,
                 epsilon=1.0, perdir=(), ulam=None, exitBC=False, body=None,
                 dtype=jnp.float32, limiter=quick, tol=1e-4, itmx=32,
                 log=False, mesh=None, bbox=True, fixed_iters=None,
                 banded_levels=False, unroll=1, implicit_diff=False):
        D = len(dims)
        if callable(u_BC) and callable(ulam):
            raise ValueError("u_BC and ulam cannot both be functions")
        if callable(u_BC) and U is None:
            raise ValueError("U must be specified when u_BC is a function")
        if implicit_diff and fixed_iters is not None:
            raise ValueError("implicit_diff and fixed_iters are mutually "
                             "exclusive reverse-AD paths; pick one")
        if implicit_diff and log:
            raise ValueError("implicit_diff does not capture residual "
                             "traces; use log=False (or fixed_iters)")
        self.U = float(U) if U is not None else math.sqrt(sum(v * v for v in u_BC))
        self.L = float(L)
        self.epsilon = float(epsilon)
        self.body = NoBody() if body is None else body
        self.mesh = mesh
        self._dims = tuple(dims)
        self._bbox_arg = bbox
        self._banded_levels = bool(banded_levels)
        self._unroll = max(1, int(unroll))
        self._cfg_kw = dict(D=D, S=tuple(n + 2 for n in dims), nu=float(nu),
                            U=u_BC, g=g, perdir=tuple(perdir),
                            exitBC=bool(exitBC), dtype=dtype, limiter=limiter,
                            tol=float(tol), itmx=int(itmx), log=bool(log),
                            sharded=mesh is not None, mesh=mesh,
                            fixed_iters=None if fixed_iters is None
                            else int(fixed_iters),
                            implicit_diff=bool(implicit_diff))
        if mesh is not None:
            from .parallel.mesh import constrain_state, constrain_levels
            self._cs = lambda s: constrain_state(s, mesh)
            self._cl = lambda l: constrain_levels(l, mesh)
        else:
            self._cs = self._cl = lambda x: x
        self._build_programs()

        # one jitted program for the whole construction: initial condition,
        # BDIM rasterization and the multigrid level stack (eager
        # construction would dispatch hundreds of individually-compiled ops)
        cfg0, _cs, _cl, lv_box0 = self.cfg, self._cs, self._cl, self._lv_box
        _measure_all, _bbox_of = self._measure_all, self._bbox_of

        def _init():
            state = flow_init(cfg0, ulam, dt)
            V, m0, m1, dc = _measure_all(0.0)
            bb = _bbox_of(dc)
            state = state._replace(V=V, mu0=m0, mu1=m1, bbox=bb)
            return _cs(state), _cl(build_levels(m0, cfg0.perdir, cfg0.sharded,
                                                lv_box0, bb))

        self.flow, self.levels = jax.jit(_init)()

        # host-side observability mirrors of flow.Δt and pois.n
        self.dts = [float(dt)]
        self.pois_n = []
        self.res_log = []

    def _build_programs(self, t0=0.0):
        """(Re)build cfg and every jitted program from the current body.

        Called at construction and by `set_body` — the step closures capture
        the body at trace time, so swapping geometry must rebuild them.
        ``t0`` is the time at which the band window is sized (`set_body`
        passes the current sim time so a mid-run swap doesn't size the
        window from the new body's t=0 extent)."""
        dtype = self._cfg_kw["dtype"]
        S = self._cfg_kw["S"]
        D = self._cfg_kw["D"]
        bbox = self._bbox_arg
        # static band-box shape for the sparse (banded) BDIM path: the body
        # terms are local, so the expensive blend runs on a small window that
        # tracks the body.  Off for sharded layouts (a dynamic window would
        # gather across shards) — pass bbox=False to disable, or an int to
        # widen the safety margin (e.g. for sdfs whose band grows over time).
        # Below ~600k cells the step is dispatch-bound and the banded path's
        # extra window ops cost more than the traffic they save (a gate set
        # on the previous accelerator; re-tune on the card).
        # bbox="force" bypasses the size gate (tests / unusual configs).
        bbox_shape = None
        measure_box = None
        big = math.prod(self._dims) >= 600_000 or bbox == "force"
        if bbox and big and not isinstance(self.body, NoBody):
            margin = (bbox if isinstance(bbox, int)
                      and not isinstance(bbox, bool) else 3)
            shape = band_box_shape(self.body, S, float(t0), self.epsilon,
                                   dtype, margin=margin)
            if self.mesh is None:
                bbox_shape = shape
            else:
                # sharded layouts keep the dense BDIM blend (the window DUS
                # would gather across shards / the one-region step blends
                # locally) but still get the narrow-band MEASUREMENT: the
                # window fields are built replicated and the step's sharding
                # constraints reshard them (replicated -> sharded is a local
                # slice, no gather).  Kills the dense D+1-grid autodiff
                # sweep per remeasure step (~30x at 256³; Body.jl:32-44).
                measure_box = shape
        self.cfg = FlowConfig(**self._cfg_kw, bbox_shape=bbox_shape)
        self._measure_box = measure_box
        # The banded *Poisson* operator trades coefficient reads for per-
        # smoother-iteration window fix-ups (full-array dynamic updates) —
        # slower than the dense operator at 256^3, so it is opt-in.  The
        # banded BDIM blend and narrow-band remeasure (once per step, not
        # per solver iteration) stay on whenever bbox is set.
        lv_box0 = bbox_shape if self._banded_levels else None
        self._lv_box = lv_box0
        cfg, body0, eps0 = self.cfg, self.body, self.epsilon
        _cs, _cl = self._cs, self._cl

        mbox = measure_box  # measurement-only window (sharded layouts)

        def _bbox_of(d_center):
            if cfg.bbox_shape is None:
                return jnp.zeros((D,), jnp.int32)
            return band_box_start(d_center < (2.0 + eps0), cfg.bbox_shape)

        self._bbox_of = _bbox_of

        def _band_covered(d_center, bb):
            """True iff every band cell lies inside the static window.

            The window *shape* is sized at t=0 (+margin); a body whose band
            grows past it (deforming sdf, band splitting across a periodic
            boundary) would silently get far-field constants outside the
            window — this is surfaced as a hard error by the stepping loop.
            For measurement-only banding (sharded layouts) the window corner
            is re-derived here (state.bbox stays zero — nothing consumes it).
            """
            box = cfg.bbox_shape if cfg.bbox_shape is not None else mbox
            if box is None:
                return jnp.bool_(True)
            band = d_center < (2.0 + eps0)
            if cfg.bbox_shape is None:
                bb = band_box_start(band, box)
            inw = None
            for d in range(D):
                k = jax.lax.broadcasted_iota(jnp.int32, S, d)
                m = (k >= bb[d] + 1) & (k < bb[d] + 1 + box[d])
                inw = m if inw is None else inw & m
            return ~jnp.any(band & ~inw)

        self._band_covered = _band_covered

        def _measure_all(t):
            """Narrow-band measurement when the body window is on (the
            reference's d²<(2+ε)² gate, Body.jl:32-44); dense otherwise."""
            box = cfg.bbox_shape if cfg.bbox_shape is not None else mbox
            if box is not None:
                out = measure_fields_banded(body0, S, t, eps0, cfg.perdir,
                                            cfg.exitBC, dtype, box)
                if cfg.sharded:
                    # pin the window-built fields replicated so the backward
                    # sharding propagation from the (sharded) step cannot
                    # turn the dynamic-offset window writes into gathers;
                    # the step's constraints then reshard replicated->
                    # sharded, which is a local slice
                    from jax.sharding import NamedSharding, PartitionSpec
                    rep = NamedSharding(self.mesh, PartitionSpec())
                    out = tuple(
                        jax.lax.with_sharding_constraint(a, rep) for a in out)
                return out
            return measure_fields(body0, S, t, eps0, cfg.perdir,
                                  cfg.exitBC, dtype)

        self._measure_all = _measure_all

        if self.mesh is not None:
            # the one-region shard_map step when the constrained fine level
            # carries the mesh (parallel.shard_step), per-phase GSPMD else
            from .parallel.mesh import mom_step_auto as _mstep
        else:
            _mstep = mom_step

        def step_static(state, levels):
            state, levels = _cs(state), _cl(levels)
            new, aux = _mstep(cfg, levels, state)
            return _cs(new), aux

        def step_remeasure(state, levels):
            state = _cs(state)
            V, m0, m1, dc = _measure_all(state.t + state.dt)
            bb = _bbox_of(dc)
            state = state._replace(V=V, mu0=m0, mu1=m1, bbox=bb)
            levels = _cl(build_levels(m0, cfg.perdir, cfg.sharded,
                                      lv_box0, bb))
            new, aux = _mstep(cfg, levels, state)
            aux["band_ok"] = _band_covered(dc, bb)
            return _cs(new), aux

        self._step_static = jax.jit(step_static)
        self._step_remeasure = jax.jit(step_remeasure)
        # donated variants for the hot stepping loop: the returned state
        # reuses the argument's buffers in place (no allocation spike, no
        # copies) — callers must drop the donated reference
        self._step_static_d = jax.jit(step_static, donate_argnums=(0,))
        self._step_remeasure_d = jax.jit(step_remeasure, donate_argnums=(0,))

        def scan_steps(state, levels, n, remeasure):
            fn = step_remeasure if remeasure else step_static
            def body_fn(s, _):
                s, aux = fn(s, levels)
                return s, (aux["pois_n"], aux["dt"],
                           aux.get("band_ok", jnp.bool_(True)),
                           aux.get("res_trace"))
            return jax.lax.scan(body_fn, state, None, length=n)

        # donate the carried state: XLA reuses its buffers in place, halving
        # peak device memory for large 3D runs
        self._scan_steps = jax.jit(scan_steps, static_argnums=(2, 3),
                                   donate_argnums=(0,))

        def steps_k(state, levels, k, remeasure):
            # k steps composed into one program (Python unroll, NOT scan):
            # one launch per k steps with none of scan's carry handling
            fn = step_remeasure if remeasure else step_static
            ps, ds, oks, trs = [], [], [], []
            for _ in range(k):
                state, aux = fn(state, levels)
                ps.append(aux["pois_n"])
                ds.append(aux["dt"])
                oks.append(aux.get("band_ok", jnp.bool_(True)))
                if cfg.log:
                    trs.append(aux["res_trace"])
            return state, (jnp.stack(ps), jnp.stack(ds), jnp.stack(oks),
                           jnp.stack(trs) if cfg.log else None)

        self._steps_k = jax.jit(steps_k, static_argnums=(2, 3),
                                donate_argnums=(0,))
        # steps() drives the donated single-step program in an async host
        # loop (dispatch is hidden by pipelining; no sync until the final
        # fetch).  Grids below this cell count run one on-device `lax.scan`
        # instead; 0 keeps every grid on the host loop until scan and the
        # host loop are compared on the card.
        self._loop_threshold = 0

    def set_body(self, body):
        """Replace the immersed geometry and rebuild the jitted programs.

        The step closures capture the body at trace time, so plain attribute
        assignment would silently keep simulating the old geometry; this is
        the supported way to swap bodies mid-run (then re-measures at the
        current time, reference `measure!(sim)` semantics)."""
        self.body = NoBody() if body is None else body
        self._build_programs(t0=float(self.flow.t) + float(self.flow.dt))
        if not isinstance(self.body, NoBody):
            self.measure()
        return self

    # -- observability -----------------------------------------------------

    @property
    def time(self):
        """Accumulated simulation time (sum of completed steps)."""
        return float(self.flow.t)

    @property
    def sim_time(self):
        """Dimensionless time t·U/L (reference src/WaterLily.jl:89)."""
        return self.time * self.U / self.L

    # -- stepping ----------------------------------------------------------

    def measure(self, t=None):
        """Re-measure the body and refresh the Poisson coefficients
        (reference `measure!(sim)`, src/WaterLily.jl:116-119)."""
        if t is None:
            t = float(self.flow.t) + float(self.flow.dt)
        cfg = self.cfg

        def _measure(t):
            V, m0, m1, dc = self._measure_all(t)
            bb = self._bbox_of(dc)
            return (V, m0, m1, bb, self._band_covered(dc, bb),
                    self._cl(build_levels(m0, cfg.perdir, cfg.sharded,
                                          self._lv_box, bb)))

        V, m0, m1, bb, ok, levels = jax.jit(_measure)(
            jnp.asarray(t, cfg.dtype))
        if not bool(ok):
            # all-or-nothing: leave self.levels/self.flow untouched so a
            # caught error never leaves a mismatched operator/state pair
            raise RuntimeError(self._BAND_ERR)
        self.levels = levels
        self.flow = self.flow._replace(V=V, mu0=m0, mu1=m1, bbox=bb)

    _BAND_ERR = ("body band outgrew its static window: the d<2+eps region "
                 "is no longer covered by cfg.bbox_shape (sized at t=0). "
                 "Widen the margin (Simulation(bbox=<margin cells>)) or "
                 "disable the banded path (bbox=False). Steps taken after "
                 "the band escaped ran on truncated physics — the current "
                 "state is NOT trustworthy; restart from a checkpoint.")

    def _record(self, aux):
        self.dts.append(float(self.flow.dt))
        self.pois_n.append(np.asarray(aux["pois_n"]))
        if "band_ok" in aux and not bool(aux["band_ok"]):
            raise RuntimeError(self._BAND_ERR)
        if self.cfg.log:
            self.res_log.append(np.asarray(aux["res_trace"]))

    def step(self, remeasure=True):
        """Advance one time step (reference `sim_step!(sim)`, :106-109)."""
        remeasure = remeasure and not isinstance(self.body, NoBody)
        fn = self._step_remeasure if remeasure else self._step_static
        self.flow, aux = fn(self.flow, self.levels)
        self._record(aux)
        return self

    def sim_step(self, t_end=None, remeasure=True, max_steps=None,
                 verbose=False):
        """Integrate to dimensionless time ``t_end`` (reference :98-105)."""
        if t_end is None:
            return self.step(remeasure)
        n = 0
        while self.sim_time < t_end and (max_steps is None or n < max_steps):
            self.step(remeasure)
            n += 1
            if verbose:
                print(f"tU/L={self.sim_time:.4f}, Δt={self.dts[-1]:.3f}")
        return self

    def steps(self, n, remeasure=True):
        """Advance ``n`` steps with no host sync until the final state is
        fetched — the benchmarking fast path.

        With ``unroll > 1`` full-width k-step megasteps run first and the
        remainder reuses the single-step program, so any batching pattern
        compiles exactly two step executables.  Otherwise every grid drives
        the donated single-step program in an async host loop (zero-sync
        semantics — dispatch never blocks).  Grids below
        ``_loop_threshold`` cells run one on-device `lax.scan` instead."""
        n = int(n)
        if n <= 0:
            return self
        remeasure = remeasure and not isinstance(self.body, NoBody)
        k = self._unroll
        if k > 1 and n >= k:
            # full-width megasteps only; the remainder (n mod unroll) falls
            # through to the single-step host loop below, so a run only ever
            # compiles TWO step executables (the k=unroll megastep + the
            # single step) no matter how callers batch — run_record's chunk
            # ramp would otherwise trace one program per distinct size
            banded = remeasure and self.cfg.bbox_shape is not None

            def launch():
                self.flow, (p, d, o, tr) = self._steps_k(
                    self.flow, self.levels, k, bool(remeasure))
                return p, d, o if banded else None, tr

            self._drive(n // k, k, launch)
            return self.steps(n - n // k * k, remeasure=remeasure)
        elif math.prod(self.cfg.S) >= self._loop_threshold:
            fn = self._step_remeasure_d if remeasure else self._step_static_d

            def launch():
                self.flow, aux = fn(self.flow, self.levels)
                ok = aux.get("band_ok")
                tr = aux.get("res_trace")
                return (aux["pois_n"][None], aux["dt"][None],
                        None if ok is None else ok[None],
                        None if tr is None else tr[None])

            return self._drive(n, 1, launch)
        else:
            self.flow, (pois_n, dts, oks, trs) = self._scan_steps(
                self.flow, self.levels, n, bool(remeasure))
            # reconstruct host history lazily (single device sync)
            self._append_history(pois_n, dts, trs)
            if not bool(jnp.all(oks)):
                raise RuntimeError(self._BAND_ERR)
        return self

    def _drive(self, n_launches, k, launch):
        """Shared accumulation loop for the host-driven stepping paths.

        ``launch()`` advances the state by ``k`` steps and returns stacked
        ``(pois_n, dt, band_ok-or-None, res_trace-or-None)`` rows.  Band
        coverage is checked every ≥32 accumulated steps over the WHOLE
        window since the last check (one scalar sync; without it a band
        that outgrows its window would run every remaining step of the
        batch on truncated physics), flushing the completed steps' history
        before raising so ``len(dts)`` stays consistent with the advanced
        state."""
        rows, dt_rows, ok_rows, tr_rows = [], [], [], []
        win, since = [], 0

        def _flush():
            self._append_history(
                jnp.concatenate(rows), jnp.concatenate(dt_rows),
                jnp.concatenate(tr_rows) if tr_rows else None)

        for _ in range(int(n_launches)):
            p, d, o, tr = launch()
            rows.append(p)
            dt_rows.append(d)
            if tr is not None:
                tr_rows.append(tr)
            if o is not None:
                ok_rows.append(o)
                win.append(o)
                since += k
                if since >= 32:
                    bad = not bool(jnp.all(jnp.concatenate(win)))
                    win, since = [], 0
                    if bad:
                        _flush()
                        raise RuntimeError(self._BAND_ERR)
        _flush()
        if ok_rows and not bool(jnp.all(jnp.concatenate(ok_rows))):
            raise RuntimeError(self._BAND_ERR)
        return self

    def _append_history(self, pois_n, dts, res_traces=None):
        for row in np.asarray(pois_n):
            self.pois_n.append(row)
        for dt in np.asarray(dts):
            self.dts.append(float(dt))
        if res_traces is not None:
            # one (2, itmx+1, 2) predictor/corrector trace pair per step —
            # the fast stepping paths capture exactly what step() records
            # (reference @log is unconditional, src/util.jl:4-24)
            for tr in np.asarray(res_traces):
                self.res_log.append(tr)

    def run_until(self, t_end, chunk=50, remeasure=True):
        """Integrate to dimensionless time ``t_end`` in `steps()` batches,
        syncing only one scalar per chunk — the production stepping loop.

        Semantically matches `sim_step(t_end)` except the final chunk may
        overshoot by up to ``chunk-1`` steps."""
        while self.sim_time < t_end:
            self.steps(chunk, remeasure=remeasure)
        return self

    def run_record(self, t_end, every=0.5, fields=None, remeasure=True):
        """Integrate to ``t_end`` sampling diagnostics every ``every`` tU/L.

        ``fields`` maps names to callables ``fn(sim) -> value`` (e.g. jitted
        force evaluations).  Stepping happens in `lax.scan` chunks sized to
        the sampling interval, so the host syncs once per sample.  Returns
        ``{"t": [...], name: [...], ...}``.
        """
        fields = fields or {}
        out = {"t": []}
        for name in fields:
            out[name] = []
        ramp = 1  # chunk-size ramp: small chunks while the CFL dt settles
        while self.sim_time < t_end:
            # geometric chunking: each chunk is sized for at most half the
            # remaining interval at the *current* dt (re-predicted as the
            # CFL step adapts) and doubles from 1 across the run — so even a
            # sharply growing dt cannot blow through the sample interval
            # (cost: O(log) host syncs per sample)
            target = min(self.sim_time + every, t_end)
            while self.sim_time < target:
                dt_nd = float(self.flow.dt) * self.U / self.L
                n = max(1, min(ramp, int(0.5 * (target - self.sim_time)
                                         / max(dt_nd, 1e-9))))
                ramp = 2 * ramp
                self.steps(n, remeasure=remeasure)
            out["t"].append(self.sim_time)
            for name, fn in fields.items():
                out[name].append(np.asarray(fn(self)))
        return out

    def write_log(self, fname="WaterLily.log"):
        """Dump captured pressure-solver residual traces in the reference's
        log format (src/util.jl:16-24): ``p/c, iter, r∞, r₂`` rows."""
        if not self.cfg.log:
            raise ValueError("construct Simulation(log=True) to capture traces")
        with open(fname, "w") as f:
            f.write("p/c, iter, r∞, r₂\n")
            for step_tr in self.res_log:
                for phase, tr in zip("pc", step_tr):
                    f.write(f"{phase}\n")
                    for it, (linf_, r2) in enumerate(tr):
                        if it > 0 and linf_ == 0 and r2 == 0:
                            break
                        f.write(f", {it}, {linf_}, {r2}\n")


def sim_time(sim: Simulation) -> float:
    return sim.sim_time
