"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    num_experts=16, top_k_experts=2, moe_layer_period=2,
    attn_layer_period=8, attn_layer_offset=4,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    source="arXiv:2403.19887",
)


def smoke_config() -> ModelConfig:
    # 2 layers: one mamba(+moe), one attention — offset 1 with period 2
    return dataclasses.replace(
        CONFIG, name="jamba-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, d_ff=512, vocab_size=512, num_experts=4,
        top_k_experts=2, moe_layer_period=2, attn_layer_period=2,
        attn_layer_offset=1)
