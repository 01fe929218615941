"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS`` (a copy of
``repro.configs``; one module per architecture, each exposing ``CONFIG``).

One module per assigned architecture; each exposes ``CONFIG``. Shapes are
in ``repro_torch.models.config`` (train_4k / prefill_32k / decode_32k /
long_500k).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS = (
    "phi3_medium_14b",
    "granite_34b",
    "stablelm_12b",
    "qwen3_8b",
    "whisper_small",
    "deepseek_moe_16b",
    "arctic_480b",
    "recurrentgemma_9b",
    "paligemma_3b",
    "falcon_mamba_7b",
    "paper_native",          # the paper's own evaluation vehicle
)


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
