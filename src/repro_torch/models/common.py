"""Configs and primitive layers shared by every module of the port.

``DSAConfig``, ``MLAConfig`` and ``ModelConfig`` are copies of the
reference package's dataclasses (same fields, same defaults, same derived
helpers), so a config means the same model on both sides.  The layer
primitives are plain functions on ``torch`` tensors with the reference's
numerics: norms and RoPE compute in float32 and cast back to the input
dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DSAConfig:
    """Dynamic-sparse-attention configuration (paper §2.2 / §3)."""
    enabled: bool = True
    block_size: int = 32           # tokens per KV block (paper default)
    token_budget: int = 2048       # selected tokens per step (paper default)
    metadata: str = "cuboid"       # "mean" (InfLLM) | "cuboid" (Quest/ArkVale)
    window: int = 12               # working-set history window (paper Fig. 8)
    sink_blocks: int = 1           # always-selected attention-sink blocks
    recent_blocks: int = 2         # always-selected most-recent blocks

    @property
    def top_k_blocks(self) -> int:
        return max(1, self.token_budget // self.block_size)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    @property
    def latent_dim(self) -> int:
        # what is cached per token: compressed KV latent + shared rope key
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- attention flavour ---
    attention_type: str = "gqa"    # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mla: Optional[MLAConfig] = None
    # --- MoE ---
    num_experts: int = 0
    top_k_experts: int = 0
    moe_dense_residual: bool = False   # Arctic: dense FFN in parallel w/ MoE
    moe_layer_period: int = 1          # apply MoE FFN every N layers
    capacity_factor: float = 1.25
    # --- hybrid (Jamba) ---
    attn_layer_period: int = 0         # 1 attention layer per N layers
    attn_layer_offset: int = 4
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- rwkv ---
    rwkv_head_dim: int = 64
    # --- encoder-decoder (Whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500        # whisper: 30s @ 50 Hz after conv stride
    # --- modality frontend stub (audio | vlm) ---
    frontend: str = "none"             # none | audio_conv_stub | vit_patch_stub
    num_patches: int = 256             # vlm: patch embeddings per image
    # --- norm / act ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- DSA ---
    dsa: DSAConfig = dataclasses.field(default_factory=DSAConfig)
    # --- citation (source of the config, for the assignment table) ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived helpers -------------------------------------------------
    @property
    def kv_cache_dim(self) -> int:
        """Per-token, per-kv-head cached dim (k and v separately, except MLA)."""
        if self.attention_type == "mla":
            assert self.mla is not None
            return self.mla.latent_dim
        return self.head_dim

    def is_attention_layer(self, layer_idx: int) -> bool:
        if self.attention_type == "none":
            return False
        if self.attn_layer_period and self.attn_layer_period > 1:
            return layer_idx % self.attn_layer_period == self.attn_layer_offset
        return True

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.num_experts <= 0:
            return False
        return layer_idx % max(1, self.moe_layer_period) == (
            self.moe_layer_period - 1 if self.moe_layer_period > 1 else 0)

    def num_attention_layers(self) -> int:
        return sum(1 for i in range(self.num_layers) if self.is_attention_layer(i))

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += v * d  # embed
        if not self.tie_embeddings:
            n += v * d
        for i in range(self.num_layers):
            if self.is_attention_layer(i):
                if self.attention_type == "mla":
                    m = self.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk
                    n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    n += self.num_heads * m.v_head_dim * d
                else:
                    hd = self.head_dim
                    n += d * self.num_heads * hd          # Wq
                    n += 2 * d * self.num_kv_heads * hd   # Wk, Wv
                    n += self.num_heads * hd * d          # Wo
            elif self.arch_type == "hybrid":              # mamba layer
                di = self.mamba_expand * d
                n += d * 2 * di + di * self.mamba_d_conv
                n += di * (self.mamba_d_state * 2 + 1) + di  # x_proj(B,C,dt) + dt_proj-ish
                n += di * self.mamba_d_state + di             # A, D
                n += di * d                                   # out proj
            elif self.attention_type == "none":           # rwkv time-mix
                n += 5 * d * d + 2 * d * d                # r,k,v,g,o + lora-ish decay
            if self.is_moe_layer(i):
                n += self.num_experts * 3 * d * f         # expert FFNs (swiglu)
                n += d * self.num_experts                 # router
                if self.moe_dense_residual:
                    n += 3 * d * f
            else:
                n += 3 * d * f                            # swiglu FFN
        if self.is_encoder_decoder:
            hd = self.head_dim
            per_enc = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                       + self.num_heads * hd * d + 3 * d * f)
            n += self.encoder_layers * per_enc
            # decoder cross-attn
            n += self.num_layers * (2 * d * self.num_heads * hd
                                    + 2 * d * self.num_kv_heads * hd)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.num_experts <= 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n = self.param_count()
        moe_layers = sum(1 for i in range(self.num_layers) if self.is_moe_layer(i))
        n -= moe_layers * (self.num_experts - self.top_k_experts) * 3 * d * f
        return n


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x W_g) * (x W_u)) W_d."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
