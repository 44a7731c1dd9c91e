"""Dynamic Sparse Attention (DSA) primitives — paper §2.2, in PyTorch.

Counterpart of ``repro/core/dsa.py``, with the same shape conventions:

    q          (B, Hq, D)
    kv pool    (B, Hkv, NB, bs, D)     -- head-major (H, N, D) layout
    meta mean  (B, Hkv, NB, D)
    meta cuboid(B, Hkv, NB, 2, D)      -- [min, max]
    scores     (B, Hkv, NB)            -- group-reduced over GQA query heads
    selection  (B, Hkv, K) int32

On the GPU the cuboid/max scoring goes through the ``block_score`` kernel
(``kernels/ops.py``); everything else is plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.common import DSAConfig

NEG_INF = -1e30


def build_block_metadata(keys: torch.Tensor, method: str = "cuboid",
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """keys (..., NB, bs, D); valid optional (..., NB, bs) bool ->
    mean (..., NB, D) or cuboid (..., NB, 2, D), float32."""
    kf = keys.float()
    if method == "mean":
        if valid is None:
            return kf.mean(dim=-2)
        v = valid[..., None].float()
        denom = v.sum(dim=-2).clamp(min=1.0)
        return (kf * v).sum(dim=-2) / denom
    if method == "cuboid":
        if valid is None:
            mn = kf.amin(dim=-2)
            mx = kf.amax(dim=-2)
        else:
            v = valid[..., None]
            inf = torch.tensor(float("inf"), device=kf.device)
            mn = torch.where(v, kf, inf).amin(dim=-2)
            mx = torch.where(v, kf, -inf).amax(dim=-2)
            # fully-empty blocks: zero cuboid (scored but masked elsewhere)
            any_valid = valid.any(dim=-1)[..., None]
            mn = torch.where(any_valid, mn, 0.0)
            mx = torch.where(any_valid, mx, 0.0)
        return torch.stack([mn, mx], dim=-2)
    raise ValueError(f"unknown DSA metadata method: {method}")


def metadata_shape(cfg: DSAConfig, num_blocks: int, head_dim: int,
                   prefix=()) -> Tuple[int, ...]:
    if cfg.metadata == "mean":
        return (*prefix, num_blocks, head_dim)
    return (*prefix, num_blocks, 2, head_dim)


def score_blocks(q: torch.Tensor, meta: torch.Tensor,
                 method: str = "cuboid",
                 group_reduce: str = "max") -> torch.Tensor:
    """Block criticality per query head, reduced over the GQA group.
    Returns (B, Hkv, NB) float32.  The cuboid/max case (the serving
    default) is the ``block_score`` kernel on the GPU."""
    if method == "cuboid" and group_reduce == "max":
        return ops.block_score(q, meta)
    B, Hq, D = q.shape
    Hkv = meta.shape[1]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    if method == "mean":
        s = torch.einsum("bhgd,bhnd->bhgn", qf, meta.float())
    elif method == "cuboid":
        s = (torch.einsum("bhgd,bhnd->bhgn", qf.clamp(min=0.0),
                          meta[..., 1, :].float())
             + torch.einsum("bhgd,bhnd->bhgn", qf.clamp(max=0.0),
                            meta[..., 0, :].float()))
    else:
        raise ValueError(f"unknown DSA metadata method: {method}")
    if group_reduce == "max":
        return s.amax(dim=2)
    if group_reduce == "sum":
        return s.sum(dim=2)
    raise ValueError(group_reduce)


def selected_block_ids(sel_row) -> list:
    """Host-side de-dup of one request's selection: (Hkv, K) indices ->
    sorted unique block ids (invalid selections were already substituted
    with block 0, a force-included sink block)."""
    return np.unique(np.asarray(sel_row)).tolist()


def select_blocks(scores: torch.Tensor, cfg: DSAConfig,
                  cur_len: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k KV blocks per (batch, kv-head).

    scores (B, Hkv, NB) float32; cur_len (B,) tokens in the cache.
    Returns (indices (B, Hkv, K) int32, sel_valid (B, Hkv, K) bool).
    Unwritten blocks are masked out; sink and most-recent blocks are
    forced in with a score of +inf.  ``torch.topk`` orders ties otherwise
    than ``jax.lax.top_k``, so only the selected id SET is comparable
    with the reference (``selected_block_ids`` sorts and de-duplicates).
    Stays on the device: no host sync."""
    B, Hkv, NB = scores.shape
    k = min(cfg.top_k_blocks, NB)
    dev = scores.device
    blk_ids = torch.arange(NB, dtype=torch.int32, device=dev)
    n_valid = torch.ceil(cur_len.float() / cfg.block_size).to(torch.int32)
    valid = blk_ids[None, :] < n_valid[:, None]                  # (B, NB)
    s = torch.where(valid[:, None, :], scores, NEG_INF)
    inf = torch.tensor(float("inf"), device=dev)
    if cfg.sink_blocks > 0:
        sink = blk_ids[None, :] < torch.clamp(n_valid,
                                              max=cfg.sink_blocks)[:, None]
        s = torch.where((sink & valid)[:, None, :], inf, s)
    if cfg.recent_blocks > 0:
        recent = blk_ids[None, :] >= (n_valid - cfg.recent_blocks)[:, None]
        s = torch.where((recent & valid)[:, None, :], inf, s)
    top_scores, top_idx = torch.topk(s, k, dim=-1)
    sel_valid = top_scores > NEG_INF / 2
    top_idx = torch.where(sel_valid, top_idx, 0).to(torch.int32)
    return top_idx, sel_valid


def sparse_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_idx: torch.Tensor,
                                sel_valid: torch.Tensor,
                                cur_len: torch.Tensor,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Reference attention over only the selected KV blocks, as
    ``repro.core.dsa.sparse_decode_attention_ref`` computes it (a plain
    softmax: a row with no valid position averages the selected values).
    Returns (B, Hq, Dv)."""
    B, Hq, D = q.shape
    _, Hkv, NB, bs, _ = k_pool.shape
    Dv = v_pool.shape[-1]
    K = block_idx.shape[-1]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    idx = block_idx.long()
    k_sel = torch.gather(k_pool, 2, idx[..., None, None].expand(
        B, Hkv, K, bs, D))
    v_sel = torch.gather(v_pool, 2, idx[..., None, None].expand(
        B, Hkv, K, bs, Dv))
    qf = q.float().reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhksd->bhgks", qf, k_sel.float()) * scale
    pos = idx[..., None] * bs + torch.arange(bs, device=q.device)
    mask = (pos < cur_len.long()[:, None, None, None]) & sel_valid[..., None]
    s = s.masked_fill(~mask[:, :, None], NEG_INF)
    p = torch.softmax(s.reshape(B, Hkv, group, -1), dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p,
                     v_sel.float().reshape(B, Hkv, -1, Dv))
    return o.reshape(B, Hq, Dv).to(q.dtype)


def full_decode_attention_ref(q, k_pool, v_pool, cur_len, scale=None):
    """Dense (non-sparse) decode attention oracle over the whole pool."""
    B = q.shape[0]
    _, Hkv, NB, _, _ = v_pool.shape
    all_idx = torch.arange(NB, dtype=torch.int32,
                           device=q.device).expand(B, Hkv, NB)
    valid = torch.ones((B, Hkv, NB), dtype=torch.bool, device=q.device)
    return sparse_decode_attention_ref(q, k_pool, v_pool, all_idx, valid,
                                       cur_len, scale)
