"""Llama3-8B-262k (paper's GQA model) [hf:gradientai/Llama-3-8B-Instruct-262k]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    source="hf:gradientai/Llama-3-8B-Instruct-262k",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama3-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, d_ff=512, vocab_size=512)
