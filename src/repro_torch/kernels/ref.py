"""Plain PyTorch versions of the four hand-written Hopper kernels.

Each function computes exactly what its CUDA kernel in ``csrc/`` computes,
with the same conventions, so the wrappers in ``ops.py`` can take it for
CPU tensors and ``chip_smoke.py`` can hold each kernel against it on the
card.  They are the port's counterparts of the reference oracles in
``repro/kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def gather_blocks_hkv(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Head-major FlashH2D gather: pool (H, NB, bs, D), idx (K,) ->
    (H, K, bs, D), a new tensor."""
    return pool[:, idx.long()]


def scatter_blocks_hkv(pool: torch.Tensor, payload: torch.Tensor,
                       dest_blocks: torch.Tensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Head-major block scatter IN PLACE, casting the payload to the pool's
    dtype; untouched blocks persist.  Returns ``pool``.

    pool (H, NB, bs, D) with ``rows`` None, or (B, H, NB, bs, D) with
    ``rows`` (K,) naming each payload block's batch row; payload
    (H, K, bs, D); dest_blocks (K,)."""
    new = payload.to(pool.dtype)
    if rows is None:
        pool[:, dest_blocks.long()] = new
    else:
        # advanced indices at axes 0 and 2 put the indexed axis first
        pool[rows.long(), :, dest_blocks.long()] = new.transpose(0, 1)
    return pool


def block_score(q: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Quest cuboid upper bound, max over the GQA group.

    q (B, Hq, D); meta (B, Hkv, NB, 2, D) float32 with [min, max]
    interleaved on axis 3 (the pool's own layout) -> (B, Hkv, NB) f32:
    max_g sum_d max(q_d mn_d, q_d mx_d) = pos @ mx^T + neg @ mn^T."""
    B, Hq, D = q.shape
    Hkv = meta.shape[1]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    pos = qf.clamp(min=0.0)
    neg = qf.clamp(max=0.0)
    s = (torch.einsum("bhgd,bhnd->bhgn", pos, meta[..., 1, :].float())
         + torch.einsum("bhgd,bhnd->bhgn", neg, meta[..., 0, :].float()))
    return s.amax(dim=2)


def sparse_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_idx: torch.Tensor,
                            sel_valid: torch.Tensor, cur_len: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Attention of one decode token over its selected KV blocks.

    q (B, Hq, D); pools (B, Hkv, NB, bs, D|Dv); block_idx/sel_valid
    (B, Hkv, K); cur_len (B,) tokens in the cache.  Returns (B, Hq, Dv) in
    q's dtype, accumulated in float32.  A position counts when its
    selection is valid and it lies below ``cur_len``.  A row with no such
    position returns 0 (the reference Pallas kernel's convention: its
    softmax denominator is clamped to 1e-30), where the reference's
    ``dsa.sparse_decode_attention_ref`` would return the mean of the
    selected values; the engine never produces such a row for a scheduled
    request (block 0 is always selected and ``cur_len`` >= 1)."""
    B, Hq, D = q.shape
    _, Hkv, NB, bs, _ = k_pool.shape
    Dv = v_pool.shape[-1]
    G = Hq // Hkv
    K = block_idx.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    idx = block_idx.long()
    k_sel = torch.gather(k_pool, 2, idx[..., None, None].expand(
        B, Hkv, K, bs, D))
    v_sel = torch.gather(v_pool, 2, idx[..., None, None].expand(
        B, Hkv, K, bs, Dv))
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhksd->bhgks", qf, k_sel.float()) * scale
    pos = idx[..., None] * bs + torch.arange(bs, device=q.device)
    mask = (pos < cur_len.long()[:, None, None, None]) & sel_valid[..., None]
    mask = mask[:, :, None].expand_as(s).reshape(B, Hkv, G, K * bs)
    s = s.reshape(B, Hkv, G, K * bs).masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhgt,bhtd->bhgd", p,
                     v_sel.float().reshape(B, Hkv, K * bs, Dv)) / l
    return o.reshape(B, Hq, Dv).to(q.dtype)
