"""Architecture config registry of the port: the dense GQA archs the first
slice serves.  Each module exports ``CONFIG`` (the full-scale config, source
cited) and ``smoke_config()`` (a reduced variant for CPU tests), copied from
the reference registry."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
}

ALL_ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    return importlib.import_module(_ARCH_MODULES[name]).smoke_config()
