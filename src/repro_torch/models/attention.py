"""Attention of the port, GQA and MLA: prefill (causal flash attention,
the ``flash_prefill`` kernel on the GPU), the DSA decode stages over
the paged KV pool, and Whisper's cross-attention over the cached encoder
keys and values (the kernel's non-causal mode).

Counterpart of the GQA, MLA and cross-attention parts of
``repro/models/attention.py``, and of its fused context-parallel decode
(``cp_decode_attention``, ``cp_mla_decode_attention``: each rank holds a
block shard of the pools, ``launch/sharding.pool_shard``); the staged
planes' sharded stages (``*_step_cp``) are not ported.  The pool layout
is the paper's head-major (H, N, D): ``(B, Hkv, NB, bs, D)``.  MLA
caches one latent head, ``(B, 1, NB, bs, kv_lora_rank + rope)``, with no
``"v"`` pool: its decode attends over the latent with the absorbed
query (the latent is both key and value).
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
from repro_torch.launch import mesh as mesh_mod
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
# Context-parallel decode attention (each rank a block shard of the pools)
# ---------------------------------------------------------------------------

def _cp_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              group) -> torch.Tensor:
    """The ranks' log-sum-exp merge of their partials (float32 acc (B,
    Hq, Dv), m and l (B, Hq)) over ``group``: max of m, then the sums of
    l and acc, each rescaled to it; a rank with no valid position (m =
    NEG_INF) weighs e^(NEG_INF - max) = 0.  Returns acc / l, float32."""
    m_g = mesh_mod.all_reduce_max(m.clone(), group)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0)
    l_g = mesh_mod.all_reduce_sum(l * corr, group)
    acc_g = mesh_mod.all_reduce_sum(acc * corr[..., None], group)
    return acc_g / l_g.clamp(min=1e-30)[..., None]


def _cp_select_attend(cfg: ModelConfig, q: torch.Tensor,
                      kpool: torch.Tensor, vpool: torch.Tensor,
                      meta: torch.Tensor, new_k: torch.Tensor,
                      new_v: Optional[torch.Tensor], cur_len: torch.Tensor,
                      pm, scale: Optional[float]):
    """One rank's body, the reference's ``_cp_decode_local`` /
    ``_cp_mla_decode_local``: the pools and metadata hold NB_loc local
    blocks from global block ``offset`` on.  The new token's key (and
    value; MLA's latent, None) is appended IN PLACE only on the rank
    whose shard holds its block, the local blocks are scored (the
    ``block_score`` kernel on the GPU), the scores gathered along the
    block axis over the model group, every rank selects the same global
    top-k, attends over its own selected blocks (the partial
    ``sparse_decode_attention``) and the partials merge over the model
    group.  Returns (o (B, Hq, Dv) in q's dtype, global ids (B, Hkv,
    K))."""
    bs = cfg.dsa.block_size
    NB_loc = kpool.shape[2]
    offset = pm.model_rank * NB_loc
    blk, slot = cur_len // bs, cur_len % bs
    mine = (blk >= offset) & (blk < offset + NB_loc)
    lblk = (blk - offset).clamp(0, NB_loc - 1)
    _append_masked(kpool, new_k, lblk, slot, mine)
    if new_v is not None:
        _append_masked(vpool, new_v, lblk, slot, mine)
    _update_meta_masked(meta, new_k, lblk, slot, mine, cfg.dsa)
    new_len = (cur_len + 1).to(torch.int32)
    # the scores (small), not the pool, cross the ranks
    scores = mesh_mod.all_gather(dsa.score_blocks(q, meta, cfg.dsa.metadata),
                                 2, pm.model_group)
    idx, valid = dsa.select_blocks(scores, cfg.dsa, new_len)
    loc_valid = valid & (idx >= offset) & (idx < offset + NB_loc)
    lidx = (idx - offset).clamp(0, NB_loc - 1).to(torch.int32)
    acc, m, l = ops.sparse_decode_attention_partial(
        q, kpool, vpool, lidx, loc_valid, new_len, offset, scale=scale)
    return _cp_merge(acc, m, l, pm.model_group).to(q.dtype), idx


def _cp_rows(pm, o: torch.Tensor, idx: torch.Tensor, B: int):
    """The full batch of the body's outputs: gathered over the data group
    where the data axis sharded the rows."""
    if pm.dp_entry(B) is None:
        return o, idx
    return (mesh_mod.all_gather(o, 0, pm.data_group),
            mesh_mod.all_gather(idx, 0, pm.data_group))


def cp_decode_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, cache: Dict[str, torch.Tensor],
                        cur_len: torch.Tensor, *, pm):
    """Context-parallel select-then-compute decode attention over
    ``pm`` (``launch.plane_mesh.PlaneMesh``): q (B, Hq, hd), k/v (B, Hkv,
    hd) the new token's projections and cur_len (B,), the same on every
    rank; ``cache`` this rank's shard of the pools and metadata, ``(dp,
    None, model, None, None)`` (``launch.sharding.pool_shard``), updated
    IN PLACE.  Returns (o (B, Hq, hd), cache, global selected ids (B,
    Hkv, K)), o and the ids replicated on every rank."""
    B = q.shape[0]
    rows = pm.rows(B)
    o, idx = _cp_select_attend(cfg, q[rows], cache["k"], cache["v"],
                               cache["meta"], k[rows], v[rows],
                               cur_len[rows], pm, None)
    o, idx = _cp_rows(pm, o, idx, B)
    return o, cache, idx


def cp_mla_decode_attention(cfg: ModelConfig, q_eff: torch.Tensor,
                            latent: torch.Tensor,
                            cache: Dict[str, torch.Tensor],
                            cur_len: torch.Tensor, *, pm):
    """Context-parallel MLA decode: ``cp_decode_attention`` over the one
    latent head (its pool is key and value at once), the absorbed query
    q_eff (B, H, kv_lora + rope), the new latent (B, kv_lora + rope).
    Returns (o_lat (B, H, kv_lora + rope), cache, ids)."""
    B = q_eff.shape[0]
    rows = pm.rows(B)
    pool = cache["k"]
    o, idx = _cp_select_attend(cfg, q_eff[rows], pool, pool, cache["meta"],
                               latent[rows][:, None, :], None,
                               cur_len[rows], pm, _mla_scale(cfg))
    o, idx = _cp_rows(pm, o, idx, B)
    return o, cache, idx


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


def _check_cp(cfg: ModelConfig, step_mask) -> None:
    if not cfg.dsa.enabled:
        raise ValueError("context-parallel decode needs DSA: without it "
                         "every rank would attend over its shard alone")
    if step_mask is not None:
        raise NotImplementedError(
            "fused context-parallel decode does not support step_mask "
            "(the reference's sharded planes use the staged select/attend "
            "split, not ported)")


def gqa_decode_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cur_len: torch.Tensor, *, plane_mesh,
                    step_mask: Optional[torch.Tensor] = None):
    """The reference's ``gqa_decode_step(plane_mesh=...)``: one decode
    token of an attention layer over this rank's block shard of the pools
    (``cp_decode_attention``; DSA on, no step_mask), x (B, d) normed ->
    (out (B, d), cache, global ids).  Without a mesh ``model.decode_step``
    runs the select and attend stages (``gqa_select_step``,
    ``gqa_attend_step``)."""
    _check_cp(cfg, step_mask)
    q, k, v = _gqa_project_decode(p, cfg, x, cur_len)
    o, cache, sel = cp_decode_attention(cfg, q, k, v, cache, cur_len,
                                        pm=plane_mesh)
    return o.reshape(x.shape[0], -1) @ p["wo"], cache, sel


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
    new_len = (cur_len + 1).to(torch.int32)
    pool = cache["k"]
    if idx is None:
        o_lat = dsa.full_decode_attention_ref(q_eff, pool, pool, new_len,
                                              scale=_mla_scale(cfg))
    else:
        o_lat = ops.sparse_decode_attention(q_eff, pool, pool, idx, valid,
                                            new_len, scale=_mla_scale(cfg))
    return _mla_out(p, cfg, o_lat)


def _mla_out(p: Dict[str, torch.Tensor], cfg: ModelConfig,
             o_lat: torch.Tensor) -> torch.Tensor:
    """The latent attention's output (B, H, kv_lora + rope): its latent
    part through W_UV in float32, then the output projection."""
    m = cfg.mla
    B, H, lat = o_lat.shape[0], cfg.num_heads, m.kv_lora_rank
    w_uv = p["w_uv"].reshape(lat, H, m.v_head_dim)
    o = torch.einsum("bhl,lhd->bhd", o_lat[..., :lat].float(),
                     w_uv.float()).to(o_lat.dtype)
    return o.reshape(B, H * m.v_head_dim) @ p["wo"]


def mla_decode_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cur_len: torch.Tensor, *, plane_mesh,
                    step_mask: Optional[torch.Tensor] = None):
    """``gqa_decode_step`` for MLA: the latent pool's block shard
    (``cp_mla_decode_attention``)."""
    _check_cp(cfg, step_mask)
    q_eff, latent = _mla_project_decode(p, cfg, x, cur_len)
    o_lat, cache, sel = cp_mla_decode_attention(
        cfg, q_eff, latent, cache, cur_len, pm=plane_mesh)
    return _mla_out(p, cfg, o_lat), cache, sel
