"""Architecture config registry of the PyTorch port.

Each architecture lives in its own module (``<arch>.py``) exposing ``CONFIG``
(the exact published config) and ``reduced()`` (a tiny same-family config for
CPU tests). Only the architectures whose serving path the port runs are
registered: the dense GQA decoders, the vlm on its text path (its prefill
also takes the stub frontend's embeddings), the MLA configs, dense
(``minicpm3_4b``) and MoE (the DeepSeek-V2 pair), and the recurrent
families (``zamba2_7b``'s Mamba2 with a shared attention block,
``xlstm_1_3b``'s mLSTM/sLSTM), and the audio encoder (``hubert_xlarge``,
which trains and whose serving entry is its encoder forward).
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

ARCH_IDS = ("gemma_2b", "guard_2b", "llama3_70b", "internlm2_20b",
            "nemotron_4_340b", "pixtral_12b", "minicpm3_4b",
            "deepseek_v2_lite_16b", "deepseek_v2_236b", "zamba2_7b",
            "xlstm_1_3b", "hubert_xlarge")


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
