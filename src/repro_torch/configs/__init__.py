"""Configuration dataclasses (port of ``repro.configs``):
``get_arch_config("<id>")`` for the architectures the port has."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, SSMConfig  # noqa: F401

_ARCH_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-780m": "mamba2_780m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch_config(arch_id: str) -> ArchConfig:
    """The published config of a ported architecture; any other id
    raises ``KeyError`` naming the ported ones."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; the port "
                       f"has {sorted(ARCH_IDS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.get_config()
