"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892].  DSA inapplicable (no KV cache)."""
import dataclasses
from repro_torch.models.common import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    attention_type="none", rwkv_head_dim=64,
    dsa=DSAConfig(enabled=False),
    source="arXiv:2404.05892",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512)
