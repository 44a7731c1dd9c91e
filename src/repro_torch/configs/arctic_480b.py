"""Snowflake Arctic 480B — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, top_k_experts=2, moe_dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="arctic-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, d_ff=256, vocab_size=512, num_experts=4,
        top_k_experts=2)
