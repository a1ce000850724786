"""Architecture config registry of the PyTorch port.

Each architecture lives in its own module (``<arch>.py``) exposing ``CONFIG``
(the exact published config) and ``reduced()`` (a tiny same-family config for
CPU tests). Only the architectures whose serving path the port runs are
registered; the others arrive with their slices.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SHAPES,
    SHAPES_BY_NAME,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
    applicable_shapes,
)

ARCH_IDS = ("gemma_2b", "guard_2b")


def _norm(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch)}")
    return mod.CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch)}")
    return mod.reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
