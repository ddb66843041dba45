"""String-keyed strategy registries — the port of
``repro.core.exchange.registry``. Each family holds only the strategies
the port implements; ``GroupSpec`` refuses the reference's other keys
with ``NotPortedError``."""
from __future__ import annotations

from typing import Callable, Dict, Tuple


class Registry:
    """Name → factory table for one strategy family."""

    def __init__(self, kind: str):
        self.kind = kind
        self._table: Dict[str, Callable] = {}

    def register(self, name: str):
        """Decorator: ``@REGISTRY.register("name")``."""
        def deco(factory):
            if name in self._table:
                raise ValueError(
                    f"duplicate {self.kind} strategy {name!r}")
            self._table[name] = factory
            return factory
        return deco

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
