"""Whisper-small — enc-dec audio, the conv/mel frontend stubbed: requests
carry precomputed frame embeddings [arXiv:2212.04356]."""
import dataclasses
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", arch_type="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    is_encoder_decoder=True, encoder_layers=12, encoder_seq_len=1500,
    frontend="audio_conv_stub",
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, encoder_layers=2,
        encoder_seq_len=64)
