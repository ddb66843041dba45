"""String-keyed strategy registries — the port of
``repro.core.exchange.registry``. Each family holds only the strategies
the port implements; ``GroupSpec`` refuses the reference's other keys
with ``NotPortedError``. A strategy registers the CLI parameters it
reads (``params={cli_key: (GroupSpec field, type)}``), and
``cli_options`` is the launcher's whole ``--exchange key=value``
vocabulary, the reference's keys exactly."""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple


class Registry:
    """Name → factory table for one strategy family."""

    def __init__(self, kind: str):
        self.kind = kind
        self._table: Dict[str, Callable] = {}
        self._params: Dict[str, Mapping[str, Tuple[str, type]]] = {}

    def register(self, name: str,
                 params: Optional[Mapping[str, Tuple[str, type]]] = None):
        """Decorator: ``@REGISTRY.register("name", params={cli_key:
        (spec_field, type)})``."""
        def deco(factory):
            if name in self._table:
                raise ValueError(
                    f"duplicate {self.kind} strategy {name!r}")
            self._table[name] = factory
            self._params[name] = dict(params or {})
            return factory
        return deco

    def cli_params(self) -> Dict[str, Tuple[str, type]]:
        """Union of every registered strategy's CLI parameters."""
        out: Dict[str, Tuple[str, type]] = {}
        for p in self._params.values():
            out.update(p)
        return out

    @property
    def choices(self) -> Tuple[str, ...]:
        return tuple(sorted(self._table))

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def get(self, name: str) -> Callable:
        """The factory registered under ``name``; unknown keys raise a
        ``ValueError`` that names every valid choice."""
        try:
            return self._table[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} strategy {name!r}; expected one "
                f"of {self.choices}") from None


SCHEDULES = Registry("topology schedule")
ESTIMATORS = Registry("relevance estimator")
DELAYS = Registry("delay model")
COMBINERS = Registry("combiner")
TRANSPORTS = Registry("transport fault model")

REGISTRIES: Dict[str, Registry] = {
    "schedule": SCHEDULES,
    "estimator": ESTIMATORS,
    "delay": DELAYS,
    "combiner": COMBINERS,
    "transport": TRANSPORTS,
}


def cli_options() -> Dict[str, Tuple[str, type]]:
    """The full ``--exchange key=value`` vocabulary: the five strategy
    selectors plus every registered strategy's declared parameters,
    each mapped to the ``GroupSpec`` field it sets."""
    import repro_torch.core.exchange  # noqa: F401  (registers them all)
    opts: Dict[str, Tuple[str, type]] = {
        "schedule": ("exchange_schedule", str),
        "estimator": ("exchange_estimator", str),
        "delay": ("exchange_delay", str),
        "combiner": ("exchange_combiner", str),
        "transport": ("exchange_transport", str),
    }
    for reg in REGISTRIES.values():
        opts.update(reg.cli_params())
    return opts
