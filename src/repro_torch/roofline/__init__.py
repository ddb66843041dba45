"""Roofline analysis of the dry run: H100 constants, the collectives a
rank issues, the three-term model (compute / memory / collective) —
the port of ``repro.roofline``.

The reference's exports load on first use, so that ``constants``,
which the kernels' bounds read, imports nothing else of the package.
"""
import importlib

_EXPORTS = {"collective_bytes": "collectives", "count_ops": "collectives",
            "Roofline": "report", "active_param_count": "report",
            "analyze": "report", "model_flops": "report",
            "param_count": "report"}


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    if name == "constants":
        return importlib.import_module(f"{__name__}.constants")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_EXPORTS) + ["constants"]
