"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers, trainers and tests.  Only the architectures the port runs are
listed."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

# arch id -> module name under repro_torch.configs
_ARCH_MODULES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "smollm-360m": "smollm_360m",
    "gemma2-27b": "gemma2_27b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-350m": "xlstm_350m",
    "zamba2-2.7b": "zamba2_2_7b",
    "fedtime-llama2-7b": "fedtime_llama2_7b",
}

ALL_ARCHS: Tuple[str, ...] = tuple(_ARCH_MODULES)
# The archs the dry run sweeps with ``--all``: the reference's rule, every
# arch but the paper's own backbone, which it runs by name.
ASSIGNED_ARCHS: Tuple[str, ...] = tuple(
    a for a in _ARCH_MODULES if a != "fedtime-llama2-7b")


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(sorted(_ARCH_MODULES))}"
        )
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    cfg = _module(arch).CONFIG
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    cfg = _module(arch).smoke_config()
    cfg.validate()
    return cfg
