"""Attention of the port, GQA and MLA: prefill (causal flash attention,
the ``flash_prefill`` kernel on the GPU), the DSA decode stages over
the paged KV pool, and Whisper's cross-attention over the cached encoder
keys and values (the kernel's non-causal mode).

Counterpart of the GQA, MLA and cross-attention parts of
``repro/models/attention.py``; the context-parallel paths are not ported
yet.  The pool layout is the paper's head-major (H, N, D): ``(B, Hkv,
NB, bs, D)``.  MLA caches one latent head, ``(B, 1, NB, bs,
kv_lora_rank + rope)``, with no ``"v"`` pool: its decode attends over
the latent with the absorbed query (the latent is both key and value).
The reference's pools are functional values; here the decode stages
update the pool and its DSA metadata IN PLACE (``_append_to_pool``,
``_update_meta`` and their masked forms), and ``gqa_select_step``
returns the same cache dict it was given.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import dsa
from repro_torch.kernels import ops
from repro_torch.models.common import (DSAConfig, ModelConfig, apply_rope,
                                       rms_norm)

# ---------------------------------------------------------------------------
# GQA: prefill path
# ---------------------------------------------------------------------------

def gqa_project_qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd) with RoPE applied."""
    B, S, _ = x.shape
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q.reshape(B, S, Hq, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, Hkv, hd)


def gqa_self_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                       x: torch.Tensor, positions: torch.Tensor, *,
                       k_ctx: Optional[torch.Tensor] = None,
                       v_ctx: Optional[torch.Tensor] = None,
                       causal: bool = True, q_offset=0,
                       return_kv: bool = False):
    """Full (prefill) self-attention, through the ``flash_prefill`` kernel
    on the GPU.  Optional dense context ``k_ctx/v_ctx`` (B, S_past, Hkv,
    hd): earlier chunks of the layer, concatenated ahead of the window so
    the keys span q_offset + S positions."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    if k_ctx is not None:
        k_all = torch.cat([k_ctx.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_ctx.to(v.dtype), v], dim=1)
    else:
        k_all, v_all = k, v
    o = ops.flash_prefill(q, k_all, v_all, scale=1.0 / cfg.head_dim ** 0.5,
                          causal=causal, q_offset=q_offset)
    B, S = x.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"]
    if return_kv:
        return out, k, v
    return out


def cross_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, k_enc: torch.Tensor,
                    v_enc: torch.Tensor) -> torch.Tensor:
    """Whisper decoder cross-attention, x (B, S, d) over the projected
    encoder keys and values k_enc/v_enc (B, S_enc, Hkv, hd), cached once
    per request: every query sees every encoder position (the
    ``flash_prefill`` kernel's non-causal mode on the GPU)."""
    B, S, _ = x.shape
    Hq, hd = cfg.num_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, Hq, hd)
    o = ops.flash_prefill(q, k_enc, v_enc, scale=1.0 / hd ** 0.5,
                          causal=False)
    return o.reshape(B, S, -1) @ p["wo"]


def project_enc_kv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                   enc: torch.Tensor):
    """A decoder layer's cross keys and values of the encoder output enc
    (B, S_enc, d): (k, v) each (B, S_enc, Hkv, hd)."""
    B, S, _ = enc.shape
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return ((enc @ p["wk"]).reshape(B, S, Hkv, hd),
            (enc @ p["wv"]).reshape(B, S, Hkv, hd))


def cross_decode_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, k_enc: torch.Tensor,
                      v_enc: torch.Tensor) -> torch.Tensor:
    """Cross-attention of one decode token per row, x (B, d): one query
    row over the cached encoder keys and values."""
    return cross_attention(p, cfg, x[:, None, :], k_enc, v_enc)[:, 0]


# ---------------------------------------------------------------------------
# Paged KV pool (decode)
# ---------------------------------------------------------------------------

def init_layer_kv_pool(cfg: ModelConfig, batch: int, num_blocks: int,
                       dtype: torch.dtype, device: torch.device
                       ) -> Dict[str, torch.Tensor]:
    """Per-layer paged pool + DSA metadata, zero-filled: ``{"k", "v",
    "meta"}``, or for MLA ``{"k", "meta"}`` over one latent head."""
    bs, hd, Hkv = cfg.dsa.block_size, cfg.head_dim, cfg.num_kv_heads
    if cfg.attention_type == "mla":
        lat = cfg.mla.latent_dim
        return {
            "k": torch.zeros((batch, 1, num_blocks, bs, lat), dtype=dtype,
                             device=device),
            "meta": torch.zeros(dsa.metadata_shape(cfg.dsa, num_blocks, lat,
                                                   (batch, 1)),
                                dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros((batch, Hkv, num_blocks, bs, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, Hkv, num_blocks, bs, hd), dtype=dtype,
                         device=device),
        "meta": torch.zeros(dsa.metadata_shape(cfg.dsa, num_blocks, hd,
                                               (batch, Hkv)),
                            dtype=torch.float32, device=device),
    }


def pad_pool_cache(cache: Dict[str, torch.Tensor], num_blocks: int
                   ) -> Dict[str, torch.Tensor]:
    """Zero-pad every component of a pool cache along the block axis
    (axis 2) to ``num_blocks``; new tensors, the input is left alone."""
    nb = cache["k"].shape[2]
    if nb == num_blocks:
        return cache
    if nb > num_blocks:
        raise ValueError(f"cannot pad pool of {nb} blocks down to "
                         f"{num_blocks}")
    out = {}
    for key, arr in cache.items():
        shape = list(arr.shape)
        shape[2] = num_blocks
        padded = arr.new_zeros(shape)
        padded[:, :, :nb] = arr
        out[key] = padded
    return out


def slice_pool_cache(cache: Dict[str, torch.Tensor], num_blocks: int
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of ``pad_pool_cache``: views trimmed to ``num_blocks``."""
    if cache["k"].shape[2] == num_blocks:
        return cache
    return {key: arr[:, :, :num_blocks] for key, arr in cache.items()}


def _head_index(B: int, H: int, device):
    return (torch.arange(B, device=device)[:, None],
            torch.arange(H, device=device)[None, :])


def _append_to_pool(pool: torch.Tensor, new: torch.Tensor,
                    cur_len: torch.Tensor, block_size: int) -> torch.Tensor:
    """IN PLACE: pool (B, H, NB, bs, D) gets new (B, H, D) at position
    cur_len (B,).  Returns pool."""
    B, H = new.shape[:2]
    bidx, hidx = _head_index(B, H, pool.device)
    cl = cur_len.long()
    pool[bidx, hidx, (cl // block_size)[:, None],
         (cl % block_size)[:, None]] = new.to(pool.dtype)
    return pool


def _cuboid_update(old: torch.Tensor, kf: torch.Tensor, slot: torch.Tensor
                   ) -> torch.Tensor:
    """old (B,H,2,D), kf (B,H,D) f32, slot (B,) -> the grown [min, max];
    slot 0 starts a fresh block."""
    fresh = (slot == 0)[:, None, None]
    # Python scalars: a 0-d tensor made from one would be copied from
    # pageable memory, a stream sync on the GPU at every select
    old_mn = torch.where(fresh, float("inf"), old[..., 0, :])
    old_mx = torch.where(fresh, float("-inf"), old[..., 1, :])
    return torch.stack([torch.minimum(old_mn, kf),
                        torch.maximum(old_mx, kf)], dim=-2)


def _update_meta(meta: torch.Tensor, new_k: torch.Tensor,
                 cur_len: torch.Tensor, dsa_cfg: DSAConfig) -> torch.Tensor:
    """IN PLACE: grow the metadata of the block receiving new_k (B, H, D).
    meta mean (B,H,NB,D); cuboid (B,H,NB,2,D).  Returns meta."""
    B, H, _ = new_k.shape
    bidx, hidx = _head_index(B, H, meta.device)
    cl = cur_len.long()
    blk = (cl // dsa_cfg.block_size)[:, None]
    slot = cl % dsa_cfg.block_size
    kf = new_k.float()
    old = meta[bidx, hidx, blk]
    if dsa_cfg.metadata == "mean":
        cnt = slot[:, None, None].float()
        meta[bidx, hidx, blk] = (old * cnt + kf) / (cnt + 1.0)
    else:
        meta[bidx, hidx, blk] = _cuboid_update(old, kf, slot)
    return meta


def _append_masked(pool: torch.Tensor, new: torch.Tensor, lblk: torch.Tensor,
                   slot: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
    """IN PLACE: write new (B,H,D) at (lblk, slot) only for rows where
    ``mine`` (B,) is True; other rows keep their values.  Returns pool."""
    B, H = new.shape[:2]
    bidx, hidx = _head_index(B, H, pool.device)
    at = (bidx, hidx, lblk.long()[:, None], slot.long()[:, None])
    old = pool[at]
    pool[at] = torch.where(mine[:, None, None], new.to(pool.dtype), old)
    return pool


def _update_meta_masked(meta: torch.Tensor, new_k: torch.Tensor,
                        lblk: torch.Tensor, slot: torch.Tensor,
                        mine: torch.Tensor, dsa_cfg: DSAConfig
                        ) -> torch.Tensor:
    """IN PLACE masked form of ``_update_meta``.  Returns meta."""
    B, H, _ = new_k.shape
    bidx, hidx = _head_index(B, H, meta.device)
    at = (bidx, hidx, lblk.long()[:, None])
    kf = new_k.float()
    old = meta[at]
    slot = slot.long()
    if dsa_cfg.metadata == "mean":
        cnt = slot[:, None, None].float()
        upd = (old * cnt + kf) / (cnt + 1.0)
        sel = mine[:, None, None]
    else:
        upd = _cuboid_update(old, kf, slot)
        sel = mine[:, None, None, None]
    meta[at] = torch.where(sel, upd, old)
    return meta


# ---------------------------------------------------------------------------
# GQA decode stages (DSA select-then-compute)
# ---------------------------------------------------------------------------

def _gqa_project_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                        x: torch.Tensor, cur_len: torch.Tensor):
    """Decode-token q/k/v with RoPE at position cur_len.
    x (B, d) -> q (B,Hq,hd), k/v (B,Hkv,hd)."""
    B = x.shape[0]
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos = cur_len[:, None]
    q = apply_rope(q.reshape(B, 1, Hq, hd), pos, cfg.rope_theta)[:, 0]
    k = apply_rope(k.reshape(B, 1, Hkv, hd), pos, cfg.rope_theta)[:, 0]
    return q, k, v.reshape(B, Hkv, hd)


def gqa_select_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cur_len: torch.Tensor, *,
                    step_mask: Optional[torch.Tensor] = None):
    """Select stage: append the new token's KV to the pool and grow the
    block metadata (both IN PLACE), then score and top-k.

    Returns (q, cache, idx, valid); idx/valid are None when DSA is off.
    step_mask: rows where False keep pool and metadata unchanged."""
    bs = cfg.dsa.block_size
    q, k, v = _gqa_project_decode(p, cfg, x, cur_len)
    if step_mask is None:
        _append_to_pool(cache["k"], k, cur_len, bs)
        _append_to_pool(cache["v"], v, cur_len, bs)
        _update_meta(cache["meta"], k, cur_len, cfg.dsa)
    else:
        blk, slot = cur_len // bs, cur_len % bs
        _append_masked(cache["k"], k, blk, slot, step_mask)
        _append_masked(cache["v"], v, blk, slot, step_mask)
        _update_meta_masked(cache["meta"], k, blk, slot, step_mask, cfg.dsa)
    idx = valid = None
    if cfg.dsa.enabled:
        idx, valid = dsa.score_and_select(q, cache["meta"], cfg.dsa,
                                          cur_len)
    return q, cache, idx, valid


def gqa_attend_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    q: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cur_len: torch.Tensor, idx: Optional[torch.Tensor],
                    valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Compute stage: block-sparse attention over the selected blocks of
    the (possibly restored) pool, through the ``sparse_decode_attention``
    kernel on the GPU, then the output projection.  Reads ``cache`` only."""
    B, Hq, hd = q.shape
    new_len = (cur_len + 1).to(torch.int32)
    if idx is None:
        o = dsa.full_decode_attention_ref(q, cache["k"], cache["v"], new_len)
    else:
        o = ops.sparse_decode_attention(q, cache["k"], cache["v"], idx,
                                        valid, new_len)
    return o.reshape(B, Hq * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA — MiniCPM3 / DeepSeek-V2 latent attention
# ---------------------------------------------------------------------------

def _mla_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(qk_nope + qk_rope): the query-key depth, not the latent
    width the decode attends over."""
    m = cfg.mla
    return 1.0 / (m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5


def mla_self_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                       x: torch.Tensor, positions: torch.Tensor, *,
                       return_latent: bool = False):
    """Prefill MLA in the non-absorbed form, x (B, S, d): q and k of depth
    qk_nope + qk_rope, v of v_head_dim, every query head over its own key
    head, through the ``flash_prefill`` kernel on the GPU.  With
    ``return_latent`` also the cached latent (B, S, kv_lora + rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    qall = (cq @ p["w_uq"]).reshape(B, S, H, dn + dr)
    q_rope = apply_rope(qall[..., dn:], positions, cfg.rope_theta)
    c_kv_n = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]          # (B, S, dr) shared
    k_nope = (c_kv_n @ p["w_uk"]).reshape(B, S, H, dn)
    v = (c_kv_n @ p["w_uv"]).reshape(B, S, H, dv)
    q = torch.cat([qall[..., :dn], q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    o = ops.flash_prefill(q, k, v, scale=_mla_scale(cfg), causal=True)
    out = o.reshape(B, S, H * dv) @ p["wo"]
    if return_latent:
        return out, torch.cat([c_kv_n, k_rope], dim=-1)
    return out


def _mla_project_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                        x: torch.Tensor, cur_len: torch.Tensor):
    """Absorbed-form decode projections at position cur_len: x (B, d) ->
    (q_eff (B, H, kv_lora + rope), latent (B, kv_lora + rope)).  W_UK is
    absorbed into the query in float32, as the reference does."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    dn, lat = m.qk_nope_head_dim, m.kv_lora_rank
    pos = cur_len[:, None]
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    qall = (cq @ p["w_uq"]).reshape(B, H, dn + m.qk_rope_head_dim)
    q_rope = apply_rope(qall[:, None, :, dn:], pos, cfg.rope_theta)[:, 0]
    w_uk = p["w_uk"].reshape(lat, H, dn)
    q_abs = torch.einsum("bhd,lhd->bhl", qall[..., :dn].float(),
                         w_uk.float()).to(x.dtype)
    c_kv_n = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"])[:, None, None, :], pos,
                        cfg.rope_theta)[:, 0, 0]
    return (torch.cat([q_abs, q_rope], dim=-1),
            torch.cat([c_kv_n, k_rope], dim=-1))


def mla_select_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cur_len: torch.Tensor, *,
                    step_mask: Optional[torch.Tensor] = None):
    """MLA select stage, ``gqa_select_step`` over the latent pool: the
    token's latent appended and the metadata grown IN PLACE, then the
    blocks scored in latent space with the absorbed query (max over the
    H query heads of the one latent head) and top-k.
    Returns (q_eff, cache, idx, valid)."""
    bs = cfg.dsa.block_size
    q_eff, latent = _mla_project_decode(p, cfg, x, cur_len)
    lat1 = latent[:, None, :]                           # (B, 1, lat + dr)
    if step_mask is None:
        _append_to_pool(cache["k"], lat1, cur_len, bs)
        _update_meta(cache["meta"], lat1, cur_len, cfg.dsa)
    else:
        blk, slot = cur_len // bs, cur_len % bs
        _append_masked(cache["k"], lat1, blk, slot, step_mask)
        _update_meta_masked(cache["meta"], lat1, blk, slot, step_mask,
                            cfg.dsa)
    idx = valid = None
    if cfg.dsa.enabled:
        idx, valid = dsa.score_and_select(q_eff, cache["meta"], cfg.dsa,
                                          cur_len)
    return q_eff, cache, idx, valid


def mla_attend_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    q_eff: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cur_len: torch.Tensor, idx: Optional[torch.Tensor],
                    valid: Optional[torch.Tensor]) -> torch.Tensor:
    """MLA compute stage: block-sparse attention of the H absorbed queries
    over the selected blocks of the latent pool, which is key and value
    at once (the ``sparse_decode_attention`` kernel on the GPU, G = H over
    one head, scale 1 / sqrt(qk_nope + qk_rope)); the latent part of the
    output through W_UV in float32, then the output projection.  Reads
    ``cache`` only."""
    m = cfg.mla
    B = q_eff.shape[0]
    H, lat = cfg.num_heads, m.kv_lora_rank
    new_len = (cur_len + 1).to(torch.int32)
    pool = cache["k"]
    if idx is None:
        o_lat = dsa.full_decode_attention_ref(q_eff, pool, pool, new_len,
                                              scale=_mla_scale(cfg))
    else:
        o_lat = ops.sparse_decode_attention(q_eff, pool, pool, idx, valid,
                                            new_len, scale=_mla_scale(cfg))
    w_uv = p["w_uv"].reshape(lat, H, m.v_head_dim)
    o = torch.einsum("bhl,lhd->bhd", o_lat[..., :lat].float(),
                     w_uv.float()).to(q_eff.dtype)
    return o.reshape(B, H * m.v_head_dim) @ p["wo"]
