"""MiniCPM3-4B — dense with MLA [hf:openbmb/MiniCPM3-4B]."""
import dataclasses
from repro_torch.models.common import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", arch_type="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attention_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm3-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=512,
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32))
