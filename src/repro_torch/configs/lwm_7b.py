"""LWM-7B (paper's main model; Llama2-7B architecture, MHA, 1M ctx)
[arXiv:2402.08268]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="lwm-7b", arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000,
    source="arXiv:2402.08268",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="lwm-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=8, d_ff=512, vocab_size=512)
