"""Qwen2.5-3B — GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", arch_type="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2.5-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, d_ff=512, vocab_size=512)
