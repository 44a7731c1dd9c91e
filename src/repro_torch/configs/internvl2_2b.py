"""InternVL2-2B — InternViT (stubbed) + InternLM2 LM backbone
[arXiv:2404.16821]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", arch_type="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    frontend="vit_patch_stub", num_patches=256,
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512, num_patches=8)
