"""Configuration dataclasses (port of ``repro.configs``):
``get_arch_config("<id>")`` for the architectures the port has."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    LONG_CONTEXT_WINDOW,
    ArchConfig,
    HybridConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
)

_ARCH_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-3-8b": "granite_3_8b",
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-780m": "mamba2_780m",
    "musicgen-medium": "musicgen_medium",
    "qwen2-7b": "qwen2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "yi-34b": "yi_34b",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch_config(arch_id: str) -> ArchConfig:
    """The published config of an architecture of the zoo; any other id
    raises ``KeyError`` naming the known ones."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port "
                       f"has {sorted(ARCH_IDS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.get_config()


def arch_for_shape(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """Apply per-shape variants (the reference's): the dense, VLM and
    audio families get the sliding-window attention variant for
    ``long_500k``; SSM and hybrid run natively."""
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        if cfg.sliding_window is None:
            return cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg
