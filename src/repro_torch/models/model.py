"""Model assembly of the port: the dense GQA decoder.

Counterpart of the dense subset of ``repro/models/model.py``.  Parameters
are a plain dict of tensors in list mode:

    {"embed": (V, d), "final_norm": (d,), "lm_head": (d, V),
     "layers": [{"attn_norm", "ffn_norm", "attn": {wq, wk, wv, wo[, bq,
                 bk, bv]}, "ffn": {w_gate, w_up, w_down}}, ...]}

(``bridge.params_from_numpy`` un-stacks the reference's stacked layers into
this form).  DecodeState is ``{"caches": [per-layer pool dict],
"cur_len": (B,) int32, "extra": {}}`` with the pools updated IN PLACE by
the decode stages.  Configs the port does not implement (MLA, MoE,
recurrent layers, encoder-decoder, modality frontends) raise
``NotImplementedError`` in ``check_supported``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import dsa as dsa_mod
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import ModelConfig, rms_norm


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    if (cfg.attention_type != "gqa" or cfg.num_experts > 0
            or cfg.attn_layer_period > 1 or cfg.arch_type not in ("dense",)
            or cfg.is_encoder_decoder or cfg.frontend != "none"
            or cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA decoders only (MLA, MoE, "
            f"recurrent, encoder-decoder and frontend models are later work)")


def layer_kind(cfg: ModelConfig, i: int) -> str:
    """Mixer of layer i: always 'attn' for the dense GQA decoders served."""
    check_supported(cfg)
    return "attn"


def get_layer(params: Dict, i: int) -> Dict:
    return params["layers"][i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _dense(gen: torch.Generator, shape, dtype, device, scale=None):
    std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return x.to(device=device, dtype=dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Dict:
    """Random weights drawn from ``generator`` (scaled normals as the
    reference's ``init_params``; norms one, biases zero) — not the
    reference's numbers, which come from ``jax.random``.  Runs on the GPU
    unless ``device="cpu"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = generator

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    layers = []
    for _ in range(cfg.num_layers):
        a = {"wq": _dense(g, (d, Hq * hd), dtype, dev),
             "wk": _dense(g, (d, Hkv * hd), dtype, dev),
             "wv": _dense(g, (d, Hkv * hd), dtype, dev),
             "wo": _dense(g, (Hq * hd, d), dtype, dev)}
        if cfg.qkv_bias:
            a.update(bq=zeros(Hq * hd), bk=zeros(Hkv * hd),
                     bv=zeros(Hkv * hd))
        layers.append({
            "attn_norm": ones(d), "ffn_norm": ones(d), "attn": a,
            "ffn": {"w_gate": _dense(g, (d, f), dtype, dev),
                    "w_up": _dense(g, (d, f), dtype, dev),
                    "w_down": _dense(g, (f, d), dtype, dev)}})
    return {"embed": _dense(g, (V, d), dtype, dev, scale=0.02),
            "final_norm": ones(d), "layers": layers,
            "lm_head": _dense(g, (d, V), dtype, dev, scale=0.02)}


# ---------------------------------------------------------------------------
# Layer forward (full sequence): prefill
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, w, x):
    return rms_norm(x, w, cfg.norm_eps)


def layer_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, kind: str = "attn",
                  k_ctx=None, v_ctx=None, q_offset=0,
                  return_kv: bool = False):
    """One transformer layer over a full sequence.  Returns (x_out,
    layer_kv): (k, v) each (B, S, Hkv, hd) when ``return_kv``, else None."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r}")
    h_in = _norm(cfg, p["attn_norm"], x)
    h, k, v = attn.gqa_self_attention(p["attn"], cfg, h_in, positions,
                                      k_ctx=k_ctx, v_ctx=v_ctx,
                                      q_offset=q_offset, return_kv=True)
    x = x + h
    x = x + ffn_mod.ffn_apply(p["ffn"], _norm(cfg, p["ffn_norm"], x))
    return x, ((k, v) if return_kv else None)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params: Dict, cfg: ModelConfig, inputs: Dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B,S,d), positions (B,S))."""
    tokens = inputs["tokens"]
    B, S = tokens.shape
    h = params["embed"][tokens.long()]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    return h, positions


def lm_head(params: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return _norm(cfg, params["final_norm"], h) @ params["lm_head"]


# ---------------------------------------------------------------------------
# Decode state / plain prefill
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, num_blocks: int,
                      dtype: torch.dtype, device) -> Dict:
    """List-mode decode state with zero pools."""
    dev = torch.device(device)
    return {"caches": [attn.init_layer_kv_pool(cfg, batch, num_blocks,
                                               dtype, dev)
                       for _ in range(cfg.num_layers)],
            "cur_len": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "extra": {}}


def _kv_to_pool(cfg: ModelConfig, k: torch.Tensor, num_blocks: int,
                pool_dtype: torch.dtype):
    """(B, S, Hkv, D) -> pool (B, Hkv, NB, bs, D) zero-padded, in
    ``pool_dtype``, and its block metadata built from ``k``'s values."""
    B, S, Hkv, D = k.shape
    bs = cfg.dsa.block_size
    padded = k.new_zeros((B, num_blocks * bs, Hkv, D))
    padded[:, :S] = k
    pool = padded.reshape(B, num_blocks, bs, Hkv, D).permute(0, 3, 1, 2, 4)
    valid = (torch.arange(num_blocks * bs, device=k.device) < S).reshape(
        num_blocks, bs).expand(B, Hkv, num_blocks, bs)
    meta = dsa_mod.build_block_metadata(pool, cfg.dsa.metadata, valid)
    return pool.to(pool_dtype).contiguous(), meta


def prefill(params: Dict, cfg: ModelConfig, inputs: Dict, num_blocks: int,
            *, cache_dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    """Plain prefill: full forward over the prompt; returns last-token
    logits and a list-mode DecodeState whose pools hold the prompt KV."""
    h, positions = embed_inputs(params, cfg, inputs)
    B, S, _ = h.shape
    caches = []
    for i in range(cfg.num_layers):
        h, (k, v) = layer_forward(get_layer(params, i), cfg, h, positions,
                                  return_kv=True)
        kpool, meta = _kv_to_pool(cfg, k, num_blocks, cache_dtype)
        vpool, _ = _kv_to_pool(cfg, v, num_blocks, cache_dtype)
        caches.append({"k": kpool, "v": vpool, "meta": meta})
    logits = lm_head(params, cfg, h[:, -1:, :])[:, 0]
    state = {"caches": caches,
             "cur_len": torch.full((B,), S, dtype=torch.int32,
                                   device=h.device),
             "extra": {}}
    return logits, state


# ---------------------------------------------------------------------------
# Layer-segmented prefill: the prefill plane's stage functions
# ---------------------------------------------------------------------------

def prefill_embed(params: Dict, cfg: ModelConfig, inputs: Dict):
    """Segment 0 of layer-segmented prefill: the embedding."""
    h, positions = embed_inputs(params, cfg, inputs)
    return h, positions, None


def prefill_attn_layer_batched(p: Dict, cfg: ModelConfig, h: torch.Tensor,
                               positions: torch.Tensor,
                               token_mask: torch.Tensor,
                               step_mask: torch.Tensor, *,
                               k_ctx=None, v_ctx=None, q_offset=0):
    """One attention layer over a padded batch of same-layer segments.

    h (B, T, d): the rows' residual stream over the segment's token window;
    positions (B, T); k_ctx/v_ctx: earlier chunks of the same layer.
    Masked lanes (padding, unscheduled rows) keep their incoming residual.
    Returns (h_out, (k, v)) with k/v (B, T, Hkv, hd)."""
    x, kv_out = layer_forward(p, cfg, h, positions, k_ctx=k_ctx,
                              v_ctx=v_ctx, q_offset=q_offset,
                              return_kv=True)
    keep = token_mask[..., None] & step_mask[:, None, None]
    return torch.where(keep, x, h), kv_out


def prefill_logits_batched(params: Dict, cfg: ModelConfig, h: torch.Tensor,
                           tok_len: torch.Tensor) -> torch.Tensor:
    """Each row's LAST REAL hidden state (h (B, S_cap, d), tok_len (B,))
    through the lm head -> (B, V)."""
    idx = (tok_len.long() - 1).clamp(min=0)
    h_last = h[torch.arange(h.shape[0], device=h.device), idx]
    return lm_head(params, cfg, h_last[:, None, :])[:, 0]


# ---------------------------------------------------------------------------
# Staged per-layer decode (select -> [host restore] -> attend)
# ---------------------------------------------------------------------------

def decode_embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens (B,) -> x (B, d)."""
    return params["embed"][tokens.long()]


def decode_select_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache,
                        cur_len: torch.Tensor,
                        step_mask: Optional[torch.Tensor] = None):
    """Select stage of one attention layer: pre-norm, project, append the
    token's KV and grow the metadata (in place), score + top-k.
    Returns (q, cache, idx, valid)."""
    h_in = _norm(cfg, p["attn_norm"], x)
    return attn.gqa_select_step(p["attn"], cfg, h_in, cache, cur_len,
                                step_mask=step_mask)


def decode_attend_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                        q: torch.Tensor, cache, cur_len: torch.Tensor,
                        idx, valid) -> torch.Tensor:
    """Compute stage of one attention layer: block-sparse attention over
    the (possibly restored) pool + residual + FFN.  Reads ``cache`` only."""
    x = x + attn.gqa_attend_step(p["attn"], cfg, q, cache, cur_len, idx,
                                 valid)
    return x + ffn_mod.ffn_apply(p["ffn"], _norm(cfg, p["ffn_norm"], x))


def decode_logits(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  cur_len: torch.Tensor,
                  step_mask: Optional[torch.Tensor] = None):
    """lm head + cur_len advance (masked rows stay parked).
    Returns (logits (B, V), new_cur_len (B,))."""
    logits = lm_head(params, cfg, x[:, None, :])[:, 0]
    new_len = (cur_len + 1 if step_mask is None
               else cur_len + step_mask.to(cur_len.dtype))
    return logits, new_len


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: Dict, *, return_info: bool = False,
                step_mask: Optional[torch.Tensor] = None):
    """tokens (B,) int32: one new token per request.  Updates the state's
    pools IN PLACE and returns (logits, state[, {"selected": {layer: idx}}])
    with ``state["cur_len"]`` advanced (a new tensor)."""
    cur_len = state["cur_len"]
    x = decode_embed(params, cfg, tokens)
    info: Dict[str, Any] = {"selected": {}}
    for i in range(cfg.num_layers):
        p = get_layer(params, i)
        q, cache, idx, valid = decode_select_layer(
            p, cfg, x, state["caches"][i], cur_len, step_mask=step_mask)
        if idx is not None:
            info["selected"][i] = idx
        x = decode_attend_layer(p, cfg, x, q, cache, cur_len, idx, valid)
    logits, new_len = decode_logits(params, cfg, x, cur_len, step_mask)
    new_state = {"caches": state["caches"], "cur_len": new_len,
                 "extra": state["extra"]}
    if return_info:
        return logits, new_state, info
    return logits, new_state

