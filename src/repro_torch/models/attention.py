"""GQA attention of the port: prefill (blocked flash-style attention in plain
PyTorch) and the DSA decode stages over the paged KV pool.

Counterpart of the GQA half of ``repro/models/attention.py``; MLA and
cross-attention are not ported yet.  The pool layout is the paper's
head-major (H, N, D): ``(B, Hkv, NB, bs, D)``.  The reference's pools are
functional values; here the decode stages update the pool and its DSA
metadata IN PLACE (``_append_to_pool``, ``_update_meta`` and their masked
forms), and ``gqa_select_step`` returns the same cache dict it was given.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import dsa
from repro_torch.kernels import ops
from repro_torch.models.common import DSAConfig, ModelConfig, apply_rope

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Blocked ("flash-style") attention — memory bounded, plain PyTorch
# ---------------------------------------------------------------------------

def flash_attention_jnp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True, q_offset=0,
                        q_chunk: int = 512, k_chunk: int = 512
                        ) -> torch.Tensor:
    """Online-softmax blocked attention (the reference's
    ``flash_attention_jnp``, whose name it keeps), chunked over queries and
    keys in float32.

    q (B, Sq, Hq, D); k/v (B, Sk, Hkv, Dk/Dv), GQA via head grouping;
    q_offset: absolute position of q[0] (chunk continuation).  Padded keys
    (beyond Sk) are masked; with ``causal`` a query at position p sees keys
    at positions <= p.  Key chunks wholly above every query of a query
    chunk are skipped: their masked update leaves the softmax state
    unchanged.  Returns (B, Sq, Hq, Dv) in q's dtype."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hkv
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    dev = q.device
    q_offset = int(q_offset)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf = k.float()
    vf = v.float()
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, q_chunk):
        q1 = min(q0 + q_chunk, Sq)
        nq = q1 - q0
        q_i = qf[:, q0:q1]                                  # (B,nq,Hkv,G,D)
        qpos = q_offset + torch.arange(q0, q0 + q_chunk, device=dev)[:nq]
        m = torch.full((B, Hkv, G, nq), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, nq), device=dev)
        acc = torch.zeros((B, Hkv, G, nq, Dv), device=dev)
        for k0 in range(0, Sk, k_chunk):
            if causal and k0 > q_offset + q1 - 1:
                break
            k1 = min(k0 + k_chunk, Sk)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i,
                             kf[:, k0:k1]) * scale
            if causal:
                kpos = torch.arange(k0, k1, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, k0:k1])
            m = m_new
        o = acc / l.clamp(min=1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, nq, Hq, Dv).to(q.dtype)
    return out


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
    """Full (prefill) self-attention.  Optional dense context
    ``k_ctx/v_ctx`` (B, S_past, Hkv, hd): earlier chunks of the layer."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    if k_ctx is not None:
        k_all = torch.cat([k_ctx.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_ctx.to(v.dtype), v], dim=1)
    else:
        k_all, v_all = k, v
    o = flash_attention_jnp(q, k_all, v_all, scale=1.0 / cfg.head_dim ** 0.5,
                            causal=causal, q_offset=q_offset)
    B, S = x.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"]
    if return_kv:
        return out, k, v
    return out


# ---------------------------------------------------------------------------
# Paged KV pool (decode)
# ---------------------------------------------------------------------------

def init_layer_kv_pool(cfg: ModelConfig, batch: int, num_blocks: int,
                       dtype: torch.dtype, device: torch.device
                       ) -> Dict[str, torch.Tensor]:
    """Per-layer paged pool + DSA metadata, zero-filled."""
    bs, hd, Hkv = cfg.dsa.block_size, cfg.head_dim, cfg.num_kv_heads
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
    inf = torch.tensor(float("inf"), device=kf.device)
    old_mn = torch.where(fresh, inf, old[..., 0, :])
    old_mx = torch.where(fresh, -inf, old[..., 1, :])
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
        scores = dsa.score_blocks(q, cache["meta"], cfg.dsa.metadata)
        idx, valid = dsa.select_blocks(scores, cfg.dsa, cur_len + 1)
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
