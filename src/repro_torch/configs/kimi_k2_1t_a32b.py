"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    num_experts=384, top_k_experts=8,
    source="arXiv:2501.kimi2",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="kimi-k2-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, d_ff=128, vocab_size=512, num_experts=4,
        top_k_experts=2)
