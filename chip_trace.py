"""Reduce a `jax.profiler` trace of the time step to device time per phase.

`flow.mom_step` names its phases with `jax.named_scope`: ``conv_diff``,
``bdim``, ``bc``, ``div_project``, ``pressure_solve`` and ``cfl`` (the fine
PCG matvec + its dot sit in ``pcg_matvec`` inside the solve).  XLA keeps the
scope path in each instruction's ``op_name`` metadata, and the profiler
tags each device kernel with the HLO instruction it came from (``hlo_op``,
or the kernel's own name, which is the sanitized instruction name).  So:

1. `hlo_scopes` maps every instruction of the compiled step's HLO text to
   its scope path (a fusion takes the paths of the instructions it calls);
2. `device_events` reads the kernels of the device plane(s) of a trace;
3. `reduce_phases` sums their durations per phase.

Used by chip_smoke.py (the per-phase table of the 256³ sphere) and
scripts/profile_trace.py.
"""
from __future__ import annotations

import collections
import glob
import re

PHASES = ("conv_diff", "bdim", "bc", "div_project", "pressure_solve", "cfl")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*[(].*[{]\s*$")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")


def _sanitize(name: str) -> str:
    return re.sub(r"[^\w]", "_", name)


def hlo_scopes(hlo_text: str) -> dict:
    """Instruction name -> list of ``op_name`` scope paths (both the HLO name
    and its sanitized kernel-name form are keys).  A fusion without its own
    metadata inherits the paths of every instruction in the computation it
    calls, so the phase of a fused kernel is recoverable either way."""
    comps = collections.defaultdict(list)   # computation -> [op_name, ...]
    instrs = {}                              # instr -> (op_names, calls)
    cur = None
    for line in hlo_text.splitlines():
        c = _COMP.match(line)
        if c and "=" not in line.split("(")[0]:
            cur = c.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        ops = _OPNAME.findall(line)
        calls = _CALLS.findall(line)
        instrs[name] = (ops, calls)
        if cur is not None:
            comps[cur].extend(ops)
    out = {}
    for name, (ops, calls) in instrs.items():
        paths = list(ops)
        for c in calls:
            paths.extend(comps.get(c, ()))
        out[name] = paths
        out[_sanitize(name)] = paths
    return out


def phase_of(paths) -> str:
    """The step phase named in a list of scope paths ("other" if none)."""
    for p in paths:
        for seg in p.split("/"):
            if seg in PHASES:
                return seg
    return "other"


def device_events(trace_dir: str, plane_pred=None) -> list:
    """``(name, hlo_op, duration_ns, start_ns)`` of every kernel on the device
    plane(s) of the newest ``.xplane.pb`` under ``trace_dir``.

    ``plane_pred`` selects the planes (default: names starting with
    ``/device:GPU``).  Stream lines hold the kernels; derived summary lines
    ("XLA Modules", "XLA Ops", "Steps", ...) would count them twice and are
    skipped whenever a stream line exists."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(files[-1])
    if plane_pred is None:
        plane_pred = lambda n: n.startswith("/device:GPU")
    out = []
    for plane in pd.planes:
        if not plane_pred(plane.name):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if "stream" in ln.name.lower()]
        for ln in (streams or lines):
            for e in ln.events:
                stats = dict(e.stats or ())
                if not streams and "hlo_op" not in stats:
                    continue
                out.append((e.name, stats.get("hlo_op"), float(e.duration_ns),
                            float(e.start_ns)))
    return out


def busy_share(events) -> float:
    """Union of the kernels' intervals over the window they span."""
    iv = sorted((s, s + d) for _n, _h, d, s in events)
    if not iv:
        return 0.0
    busy, (a, b) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > b:
            busy += b - a
            a, b = s, e
        else:
            b = max(b, e)
    busy += b - a
    return busy / (iv[-1][1] - iv[0][0]) if iv[-1][1] > iv[0][0] else 1.0


def reduce_phases(events, scopes: dict, sub: str | None = None,
                  select=None) -> dict:
    """Device nanoseconds per phase (plus ``"total"``, and ``sub``: the time
    of kernels whose scope path contains the segment ``sub``, restricted to
    instructions for which ``select(name)`` holds when given).

    Kernels whose HLO instruction is not in ``scopes`` (library calls,
    memcpys) count under ``"unmapped"``."""
    out = collections.Counter()
    for name, hlo_op, dur, _start in events:
        key = hlo_op if hlo_op in scopes else (
            name if name in scopes else _sanitize(name))
        paths = scopes.get(key)
        out["total"] += dur
        if paths is None:
            out["unmapped"] += dur
            continue
        out[phase_of(paths)] += dur
        if sub is not None and any(sub in p.split("/") for p in paths) \
                and (select is None or select(key)):
            out[sub] += dur
    return dict(out)


def hlo_lines(hlo_text: str) -> dict:
    """Instruction name (and sanitized form) -> its HLO text line."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = line
            out[_sanitize(m.group(1))] = line
    return out
