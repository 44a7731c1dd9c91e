"""Qwen2-0.5B — GQA kv=2, QKV bias [arXiv:2407.10671]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", arch_type="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, qkv_bias=True,
    source="arXiv:2407.10671",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-smoke", num_layers=2, d_model=224, num_heads=7,
        num_kv_heads=1, d_ff=512, vocab_size=512)
