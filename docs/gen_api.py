"""Generate docs/api_generated.md from the package's docstrings.

Usage:  python docs/gen_api.py
The reference publishes Documenter.jl autodocs (docs/make.jl); this is the
equivalent surface for waterlily_tpu, kept dependency-free.
"""
from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = [
    "waterlily_tpu.simulation",
    "waterlily_tpu.flow",
    "waterlily_tpu.body",
    "waterlily_tpu.metrics",
    "waterlily_tpu.grid",
    "waterlily_tpu.ops.bc",
    "waterlily_tpu.ops.convect",
    "waterlily_tpu.ops.poisson",
    "waterlily_tpu.ops.multigrid",
    "waterlily_tpu.parallel.mesh",
    "waterlily_tpu.parallel.halo",
    "waterlily_tpu.models.cases",
    "waterlily_tpu.io.checkpoint",
    "waterlily_tpu.io.vtk",
    "waterlily_tpu.io.plots",
    "waterlily_tpu.utils.perf",
    "waterlily_tpu.utils.cache",
]


def _sig(obj):
    import re
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # strip memory addresses from default-value reprs: they differ between
    # runs and would churn the committed file on every regeneration
    return re.sub(r" at 0x[0-9a-f]+", "", sig)


def render(mod) -> list[str]:
    lines = [f"## `{mod.__name__}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    public = getattr(mod, "__all__", None)
    if public is None:
        public = [n for n in vars(mod) if not n.startswith("_")]
    for name in public:
        obj = getattr(mod, name, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", mod.__name__) != mod.__name__:
            continue  # re-exports documented at their home module
        if inspect.isclass(obj):
            lines.append(f"### class `{name}{_sig(obj)}`")
            if obj.__doc__:
                lines += ["", inspect.cleandoc(obj.__doc__)]
            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith("_") or not callable(meth):
                    continue
                lines.append(f"\n- **`{mname}{_sig(meth)}`**")
                if meth.__doc__:
                    first = inspect.cleandoc(meth.__doc__).split("\n\n")[0]
                    lines.append(f"  {first}")
            lines.append("")
        elif callable(obj):
            lines.append(f"### `{name}{_sig(obj)}`")
            if obj.__doc__:
                lines += ["", inspect.cleandoc(obj.__doc__)]
            lines.append("")
    return lines


def main(out=None):
    out = out or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "api_generated.md")
    lines = ["# waterlily_tpu — generated API reference",
             "", "Auto-generated from docstrings by `docs/gen_api.py`; "
             "see `docs/API.md` for the curated overview.", ""]
    for m in MODULES:
        lines += render(importlib.import_module(m))
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
