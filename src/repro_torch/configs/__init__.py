"""Architecture config registry of the port: the decoders it serves (GQA, MLA
for minicpm3-4b, the MoE FFN for kimi-k2 and arctic-480b), the hybrid
Mamba + attention jamba-v0.1-52b, the attention-free RWKV6 rwkv6-1.6b,
the VLM internvl2-2b (a prefix of patch embeddings) and the
encoder-decoder whisper-small.  Each module exports
``CONFIG`` (the full-scale config, source cited) and ``smoke_config()`` (a
reduced variant for CPU tests), copied from the reference registry."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "whisper-small": "repro_torch.configs.whisper_small",
    # the paper's own evaluation models
    "lwm-7b": "repro_torch.configs.lwm_7b",
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
