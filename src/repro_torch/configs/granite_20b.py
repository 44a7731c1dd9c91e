"""Granite-20B (code) — llama-arch with MQA (kv=1) [arXiv:2405.04324]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", arch_type="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    source="arXiv:2405.04324",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=1, d_ff=512, vocab_size=512)
