"""Plain PyTorch versions of the port's hand-written Hopper kernels.

Each function computes exactly what its CUDA kernel in ``csrc/`` computes,
with the same conventions, so the wrappers in ``ops.py`` can take it for
CPU tensors and ``chip_smoke.py`` can hold each kernel against it on the
card.  They are the port's counterparts of the reference oracles in
``repro/kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def gather_blocks(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Flat FlashH2D gather: pool (NB, bs, D), idx (K,) -> (K, bs, D), a
    new tensor."""
    return pool[idx.long()]


def scatter_blocks(pool: torch.Tensor, new_kv: torch.Tensor,
                   dest: torch.Tensor) -> torch.Tensor:
    """Flat FlashD2H scatter IN PLACE, byte for byte: new_kv (n_new * bs,
    D), contiguous, lands in blocks ``dest`` (n_new,) of pool (NB, bs, D);
    untouched blocks persist.  Returns ``pool`` (the reference returns a
    new array)."""
    NB, bs, D = pool.shape
    n_new = dest.shape[0]
    if new_kv.dtype != pool.dtype or tuple(new_kv.shape) != (n_new * bs, D):
        raise ValueError(f"scatter_blocks: new_kv {tuple(new_kv.shape)} "
                         f"{new_kv.dtype} for a {pool.dtype} pool of "
                         f"{bs}-row blocks and {n_new} ids")
    pool[dest.long()] = new_kv.reshape(n_new, bs, D)
    return pool


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


def zero_blocks_hkv(pools: Sequence[torch.Tensor], which: torch.Tensor,
                    rows: torch.Tensor, blocks: torch.Tensor
                    ) -> Sequence[torch.Tensor]:
    """Zero block ``blocks[i]`` of batch row ``rows[i]``, every head, of
    pool ``pools[which[i]]``, IN PLACE: pools (B, H, NB, bs, D); which,
    rows and blocks (N,) integer tensors (an eviction round's drops).
    Returns ``pools``."""
    for p in torch.unique(which).tolist():
        sel = which == p
        pools[p][rows[sel].long(), :, blocks[sel].long()] = 0
    return pools


def write_blocks_hkv(pool: torch.Tensor, payload: torch.Tensor,
                     dest_blocks: torch.Tensor) -> torch.Tensor:
    """Byte-for-byte block write IN PLACE: payload (H, K, bs, D) of the
    pool's own dtype into blocks ``dest_blocks`` of pool (H, NB, bs, D).
    Returns ``pool``."""
    if payload.dtype != pool.dtype:
        raise ValueError(f"write_blocks_hkv: {payload.dtype} payload for a "
                         f"{pool.dtype} pool")
    pool[:, dest_blocks.long()] = payload
    return pool


def block_score(q: torch.Tensor, meta: torch.Tensor,
                metadata: str = "cuboid",
                group_reduce: str = "max") -> torch.Tensor:
    """Block criticality per query head, reduced over the GQA group (the
    reference's ``dsa.score_blocks``) -> (B, Hkv, NB) float32.

    q (B, Hq, D).  Cuboid: meta (B, Hkv, NB, 2, D) float32 with [min, max]
    interleaved on axis 3 (the pool's own layout), the Quest upper bound
    sum_d max(q_d mn_d, q_d mx_d) = pos @ mx^T + neg @ mn^T.  Mean (InfLLM):
    meta (B, Hkv, NB, D) float32, q . mean.  ``group_reduce`` "max" or
    "sum" over the group's query heads."""
    B, Hq, D = q.shape
    Hkv = meta.shape[1]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    if metadata == "mean":
        s = torch.einsum("bhgd,bhnd->bhgn", qf, meta.float())
    elif metadata == "cuboid":
        pos = qf.clamp(min=0.0)
        neg = qf.clamp(max=0.0)
        s = (torch.einsum("bhgd,bhnd->bhgn", pos, meta[..., 1, :].float())
             + torch.einsum("bhgd,bhnd->bhgn", neg, meta[..., 0, :].float()))
    else:
        raise ValueError(f"unknown DSA metadata method: {metadata}")
    if group_reduce == "max":
        return s.amax(dim=2)
    if group_reduce == "sum":
        return s.sum(dim=2)
    raise ValueError(f"unknown group reduction: {group_reduce}")


def select_scores(scores: torch.Tensor, n_tokens: torch.Tensor, *,
                  block_size: int, sink_blocks: int, recent_blocks: int
                  ) -> torch.Tensor:
    """The scores the DSA top-k ranks: scores (B, Hkv, NB) float32 with the
    blocks at or past ceil(n_tokens / block_size) (n_tokens (B,) tokens in
    the cache) masked to NEG_INF and the valid sink and most recent blocks
    forced to +inf."""
    NB = scores.shape[-1]
    dev = scores.device
    blk_ids = torch.arange(NB, dtype=torch.int32, device=dev)
    n_valid = torch.ceil(n_tokens.float() / block_size).to(torch.int32)
    valid = blk_ids[None, :] < n_valid[:, None]                  # (B, NB)
    s = torch.where(valid[:, None, :], scores, NEG_INF)
    inf = torch.tensor(float("inf"), device=dev)
    if sink_blocks > 0:
        sink = blk_ids[None, :] < torch.clamp(n_valid,
                                              max=sink_blocks)[:, None]
        s = torch.where((sink & valid)[:, None, :], inf, s)
    if recent_blocks > 0:
        recent = blk_ids[None, :] >= (n_valid - recent_blocks)[:, None]
        s = torch.where((recent & valid)[:, None, :], inf, s)
    return s


def select_blocks(scores: torch.Tensor, n_tokens: torch.Tensor, *,
                  block_size: int, top_k: int, sink_blocks: int,
                  recent_blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """DSA top-k block selection per (request, kv-head), the reference's
    ``dsa.select_blocks``: scores (B, Hkv, NB) float32, n_tokens (B,)
    tokens in the cache -> (indices (B, Hkv, K) int32, sel_valid
    (B, Hkv, K) bool), K = min(top_k, NB): the top K of
    ``select_scores``, sel_valid where the score is above NEG_INF / 2,
    invalid selections replaced by block 0.  ``torch.topk`` may order the
    selection otherwise than the kernel or ``jax.lax.top_k``: only the id
    set is comparable."""
    s = select_scores(scores, n_tokens, block_size=block_size,
                      sink_blocks=sink_blocks, recent_blocks=recent_blocks)
    top_scores, top_idx = torch.topk(s, min(top_k, s.shape[-1]), dim=-1)
    sel_valid = top_scores > NEG_INF / 2
    top_idx = torch.where(sel_valid, top_idx, 0).to(torch.int32)
    return top_idx, sel_valid


def score_select(q: torch.Tensor, meta: torch.Tensor, cur_len: torch.Tensor,
                 *, block_size: int, top_k: int, sink_blocks: int,
                 recent_blocks: int, metadata: str = "cuboid",
                 group_reduce: str = "max"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode select stage from q to the selected blocks: the block
    scores (``block_score``) then ``select_blocks`` over the cache once
    this step's token is in it, ``cur_len + 1`` tokens (cur_len (B,) as
    the cache holds it before the append)."""
    return select_blocks(block_score(q, meta, metadata, group_reduce),
                         cur_len + 1,
                         block_size=block_size, top_k=top_k,
                         sink_blocks=sink_blocks,
                         recent_blocks=recent_blocks)


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


def sparse_decode_attention_partial(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_idx: torch.Tensor, sel_valid: torch.Tensor,
        cur_len: torch.Tensor, block_offset: int,
        scale: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unnormalised flash partials of one rank's share of the decode
    attention, the reference's ``dsa.sparse_decode_attention_partial``:
    pools (B, Hkv, NB_loc, bs, D|Dv) a rank's block shard, block_idx its
    LOCAL ids (B, Hkv, K) int32, sel_valid False for blocks of other
    ranks, cur_len (B,) the GLOBAL length; a position is valid where its
    selection is and its global position ((id + block_offset) * bs + t)
    lies below cur_len.  Returns float32 (acc (B, Hq, Dv), m (B, Hq), l
    (B, Hq)): the max score m over the valid positions (NEG_INF where
    there are none), l = sum exp(s - m) and acc = sum exp(s - m) v over
    them (0 where there are none)."""
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
    pos = (idx[..., None] + block_offset) * bs + torch.arange(
        bs, device=q.device)
    mask = (pos < cur_len.long()[:, None, None, None]) & sel_valid[..., None]
    s = s.masked_fill(~mask[:, :, None], NEG_INF).reshape(B, Hkv, G, -1)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)           # empty shards
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgt,bhtd->bhgd", p,
                       v_sel.float().reshape(B, Hkv, K * bs, Dv))
    return (acc.reshape(B, Hq, Dv), m.reshape(B, Hq), l.reshape(B, Hq))


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True, q_offset=0,
                  q_chunk: int = 512, k_chunk: int = 512) -> torch.Tensor:
    """Online-softmax blocked attention (the reference's
    ``flash_attention_jnp``), chunked over queries and keys in float32.

    q (B, Sq, Hq, D); k/v (B, Sk, Hkv, Dk/Dv), GQA via head grouping;
    q_offset: absolute position of q[0] (chunk continuation).  With
    ``causal`` a query at position p sees keys at positions <= p.  Key
    chunks wholly above every query of a query chunk are skipped: their
    masked update leaves the softmax state unchanged.  Returns
    (B, Sq, Hq, Dv) in q's dtype."""
    return flash_prefill_fwd_lse(q, k, v, scale=scale, causal=causal,
                                 q_offset=q_offset, q_chunk=q_chunk,
                                 k_chunk=k_chunk)[0]


def flash_prefill_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True, q_offset=0,
                          q_chunk: int = 512, k_chunk: int = 512
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_prefill`` that also returns each query row's log-sum-exp
    of its scaled scores over the keys it sees, lse (B, Hq, Sq) float32,
    natural log: what the backward recomputes the weights from,
    P = exp(S * scale - lse).  Returns (out, lse)."""
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
    lse = torch.empty((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
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
        lse[..., q0:q1] = m + torch.log(l.clamp(min=1e-30))
    return out, lse.reshape(B, Hq, Sq)


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      scale: float, causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 512
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_prefill`` over whole sequences (q_offset
    0), written out, in float32 and chunked like the forward so that no
    (Sq, Sk) tensor is held:

        P  = exp(S * scale - lse)          (S = Q K^T over the keys a
                                            query sees)
        dV = P^T dO
        D  = rowsum(dO * O)
        dS = P * (dO V^T - D)
        dQ = scale * dS K
        dK = scale * dS^T Q

    ``causal``: query i sees the keys j <= i (self-attention, Sq == Sk);
    else every query sees every key j < Sk (Whisper's encoder, Sq == Sk,
    and its cross-attention, Sq != Sk).  dK and dV summed over each GQA
    group.  q, o, do (B, Sq, Hq, D|Dv); k (B, Sk, Hkv, D), v (B, Sk, Hkv,
    Dv); lse (B, Hq, Sq) from ``flash_prefill_fwd_lse``.  Returns (dq, dk,
    dv), float32."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    if causal and Sk != Sq:
        raise ValueError(f"flash_prefill_bwd: causal self-attention takes "
                         f"Sq == Sk (Sq {Sq}, Sk {Sk})")
    G = Hq // Hkv
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    dev = q.device
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf = k.float()
    vf = v.float()
    dof = do.float().reshape(B, Sq, Hkv, G, Dv)
    delta = (dof * o.float().reshape(B, Sq, Hkv, G, Dv)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)                     # (B, Hkv, G, Sq)
    lse_r = lse.float().reshape(B, Hkv, G, Sq)
    dq = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, Hkv, Dv), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, q_chunk):
        q1 = min(q0 + q_chunk, Sq)
        q_i, do_i = qf[:, q0:q1], dof[:, q0:q1]
        qpos = torch.arange(q0, q1, device=dev)
        for k0 in range(0, q1 if causal else Sk, k_chunk):
            k1 = min(k0 + k_chunk, Sk)
            k_j, v_j = kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j) * scale
            if causal:
                kpos = torch.arange(k0, k1, device=dev)
                s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]),
                                  NEG_INF)
            p = torch.exp(s - lse_r[..., q0:q1, None])
            dv[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", p, do_i)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", do_i, v_j)
            ds = p * (dp - delta[..., q0:q1, None])
            dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                         k_j) * scale
            dk[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", ds,
                                         q_i) * scale
    return dq.reshape(B, Sq, Hq, D), dk, dv


# ---------------------------------------------------------------------------
# int8 offload tier: symmetric per-(head, block) quantization
# ---------------------------------------------------------------------------
# The arithmetic of the reference, step for step (so the three paths agree
# bit for bit): x to float32; amax = max |x| over (bs, D); scale =
# amax / 127 (an IEEE float32 division); inv = 1 / scale (1 where the
# scale is 0); q = clip(rint(x * inv), -127, 127) with round-half-to-even;
# dequant = float32(q) * scale, rounded once to the destination dtype.

def quantize_blocks(blocks: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """blocks (H, K, bs, D) fp -> (q (H, K, bs, D) int8, scales (H, K)
    float32).  An all-zero block gets scale 0 and quantizes to 0."""
    x = blocks.float()
    amax = x.abs().amax(dim=(-2, -1))
    # divisors are tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal instead, which can move a scale by an ulp
    scales = amax / torch.full_like(amax, 127.0)
    one = torch.ones_like(scales)
    pos = scales > 0.0
    inv = torch.where(pos, one / torch.where(pos, scales, one), one)
    q = torch.round(x * inv[..., None, None]).clamp(-127.0, 127.0)
    return q.to(torch.int8), scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q (H, K, bs, D) int8, scales (H, K) float32 -> (H, K, bs, D)
    float32."""
    return q.float() * scales.float()[..., None, None]


def dequantize_scatter_blocks(pool: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor, dest_blocks: torch.Tensor,
                              rows: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Dequantize q (H, K, bs, D) int8 with scales (H, K) and scatter the
    blocks into ``pool`` IN PLACE, rounded once to the pool's dtype; pool
    and ``rows`` as in ``scatter_blocks_hkv``.  Returns ``pool``."""
    return scatter_blocks_hkv(pool, dequantize_blocks(q, scales),
                              dest_blocks, rows)


def quant_save_blocks(saves) -> None:
    """The int8 tier's save IN PLACE, segment by segment in the order
    given (the reference's ``_store_quant_span``): ``saves`` holds
    ``(pool, layer, start, stripe (H, T, D))``, the pool's ``q`` (L, H,
    NB, bs, D) int8 with its ``scales`` (L, H, NB) float32; each block the
    stripe touches is dequantized with its scales, the stripe's tokens
    overwrite their slots, and the block is requantized and written back
    with its fresh scales."""
    for qp, layer, start, stripe in saves:
        pool, scales = qp.q, qp.scales
        bs = pool.shape[3]
        t0, T = 0, stripe.shape[1]
        while t0 < T:
            blk, off = divmod(start + t0, bs)
            n = min(bs - off, T - t0)
            cur = dequantize_blocks(pool[layer, :, blk, None],
                                    scales[layer, :, blk, None])
            cur[:, 0, off:off + n] = stripe[:, t0:t0 + n].to(cur.device,
                                                             torch.float32)
            q, s = quantize_blocks(cur)
            pool[layer, :, blk] = q[:, 0]
            scales[layer, :, blk] = s[:, 0]
            t0 += n


def selective_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor, chunk: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan, a loop over tokens in the reference's
    arithmetic order (``_ssm_scan``): x, dt (Bt, S, di); B, C (Bt, S,
    ds); A (di, ds) (already -exp(A_log)); D (di,); h0 (Bt, di, ds).
    Every input is widened to float32; per token dA = exp(dt A), h = dA h
    + (dt B) x, y = sum_n h C + D x.  A position with dt = 0 leaves h as
    it was.  dA, (dt B) x and y are computed for ``chunk`` tokens at a
    time, elementwise as per token; only the recurrence steps token by
    token.  Returns (y (Bt, S, di) float32, h after token S-1 (Bt, di,
    ds) float32)."""
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    A, D = A.float(), D.float()
    h = h0.float().clone()
    ys = []
    for t0 in range(0, x.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        dtc = dt[:, sl, :, None]                        # (Bt, T, di, 1)
        dA = torch.exp(dtc * A)
        dBx = dtc * B[:, sl, None, :] * x[:, sl, :, None]
        hs = torch.empty_like(dA)                      # h after each token
        for t in range(dA.shape[1]):
            torch.mul(dA[:, t], h, out=hs[:, t])
            hs[:, t] += dBx[:, t]
            h = hs[:, t]
        ys.append((hs * C[:, sl, None, :]).sum(-1) + D * x[:, sl])
    y = torch.cat(ys, dim=1) if ys else x.new_zeros(x.shape)
    return y, h.clone()


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       h0: torch.Tensor, dy: torch.Tensor,
                       dh: Optional[torch.Tensor] = None, chunk: int = 256
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan``, the explicit reverse loop of its
    token walk: x, dt, dy (Bt, S, di); B, C (Bt, S, ds); A (di, ds); D
    (di,); h0 and dh, the gradient of the final state (None: zero), (Bt,
    di, ds).  Per (row, channel d, state n), with a_t = exp(dt_t A), h_t
    the state after token t (recomputed by the forward loop, h_{-1} = h0)
    and g_t the gradient of h_t (g_{S-1} = dh + C_{S-1} dy_{S-1}; g_t =
    C_t dy_t + a_{t+1} g_{t+1}, the reverse loop):
      dC_t[n] = sum_d dy_t h_t            dB_t[n] = sum_d g_t dt_t x_t
      dx_t = dt_t sum_n g_t B_t + D dy_t
      ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
      dA = sum over rows and tokens of g_t dt_t a_t h_{t-1}
      dD = sum over rows and tokens of dy_t x_t,   dh0 = a_0 g_0.
    A position with dt = 0 carries h and g through unchanged.  Only the
    two recurrences step token by token (every state kept); the per-token
    sums run over ``chunk`` tokens at a time.  Every input is widened to
    float32.  Returns (dx, ddt, dB, dC, dA, dD, dh0), float32; the caller
    chains dA to A_log (A = -exp(A_log))."""
    x, dt, B, C, dy = (t.float() for t in (x, dt, B, C, dy))
    A, D = A.float(), D.float()
    Bt, S, di = x.shape
    states = x.new_empty((Bt, S + 1, di, A.shape[1]))  # h_{t-1} at [:, t]
    states[:, 0] = h0.float()
    for t0 in range(0, S, chunk):
        sl = slice(t0, t0 + chunk)
        dA = torch.exp(dt[:, sl, :, None] * A)
        dBx = dt[:, sl, :, None] * B[:, sl, None, :] * x[:, sl, :, None]
        for t in range(dA.shape[1]):
            torch.mul(dA[:, t], states[:, t0 + t], out=states[:, t0 + t + 1])
            states[:, t0 + t + 1] += dBx[:, t]
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA_sum = torch.zeros_like(A)
    G = (torch.zeros_like(states[:, 0]) if dh is None
         else dh.float().clone())
    for t1 in range(S, 0, -chunk):
        t0 = max(0, t1 - chunk)
        sl = slice(t0, t1)
        a = torch.exp(dt[:, sl, :, None] * A)
        g = dy[:, sl, :, None] * C[:, sl, None, :]
        for t in range(t1 - t0 - 1, -1, -1):
            g[:, t] += G
            G = a[:, t] * g[:, t]
        hprev, hcur = states[:, t0:t1], states[:, t0 + 1:t1 + 1]
        w = a * hprev
        dC[:, sl] = (dy[:, sl, :, None] * hcur).sum(2)
        dB[:, sl] = (g * (dt[:, sl] * x[:, sl])[..., None]).sum(2)
        gB = (g * B[:, sl, None, :]).sum(-1)
        dx[:, sl] = dt[:, sl] * gB + D * dy[:, sl]
        ddt[:, sl] = (g * A * w).sum(-1) + x[:, sl] * gB
        dA_sum += (g * dt[:, sl, :, None] * w).sum((0, 1))
    dD = (dy * x).sum((0, 1))
    return dx, ddt, dB, dC, dA_sum, dD, G


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6's WKV recurrence, a loop over tokens in the reference's
    arithmetic order (``_wkv_step`` under ``jax.lax.scan``): r, k, v, w
    (B, S, H, hd); u (H, hd); S0 (B, H, hd, hd).  Every input is widened
    to float32; per token, with kv_ij = k_i v_j, y_j = sum_i r_i (S_ij +
    u_i kv_ij), then S_ij = w_i S_ij + kv_ij.  A position with k = 0 and
    w = 1 leaves S as it was.  Returns (y (B, S, H, hd) float32, S after
    token S-1 (B, H, hd, hd) float32)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]
    S = S0.float().clone()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,i,j)
        ys.append(torch.einsum("bhij,bhi->bhj", S + u * kv, r[:, t]))
        S = w[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else r.new_zeros(r.shape)
    return y, S


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor,
             dy: torch.Tensor, dS: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6``, the explicit reverse loop of its token
    walk: r, k, v, w, dy (B, S, H, hd); u (H, hd); S0 and dS, the
    gradient of the final state (None: zero), (B, H, hd, hd).  With S_t
    the state before token t (recomputed by the forward loop) and lam_t
    the gradient of the state after token t (lam_{S-1} = dS; lam_{t-1} =
    w_t lam_t + r_t dy_t, the reverse loop), and dyv = dy . v:
      dr_i = sum_j dy_j S_ij + u_i k_i dyv
      dk_i = sum_j lam_ij v_j + r_i u_i dyv
      dv_j = sum_i lam_ij k_i + (sum_i r_i u_i k_i) dy_j
      dlogw_i = w_i sum_j lam_ij S_ij        (the gradient of log w)
      du_i = sum over rows and tokens of r_i k_i dyv
    per token.  Only the two recurrences step token by token (both
    states kept); the per-token sums run over 256 tokens at a time (the
    bound on their products' scratch).
    Returns (dr, dk, dv, dlogw, du, dS0 = the gradient of S0), all
    float32."""
    r, k, v, w, dy = (t.float() for t in (r, k, v, w, dy))
    u = u.float()
    B, T, H, hd = r.shape
    # states[:, t]: S before token t; lams[:, t]: the gradient of the state
    # before token t (lams[:, T] = dS)
    states = r.new_empty((B, T + 1, H, hd, hd))
    states[:, 0] = S0.float()
    for t in range(T):
        torch.addcmul(k[:, t, :, :, None] * v[:, t, :, None, :],
                      w[:, t, :, :, None], states[:, t],
                      out=states[:, t + 1])
    lams = r.new_empty((B, T + 1, H, hd, hd))
    lams[:, T] = 0.0 if dS is None else dS.float()
    for t in range(T - 1, -1, -1):
        torch.addcmul(r[:, t, :, :, None] * dy[:, t, :, None, :],
                      w[:, t, :, :, None], lams[:, t + 1], out=lams[:, t])
    dyv = (dy * v).sum(-1, keepdim=True)
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    for t0 in range(0, T, 256):
        end = min(t0 + 256, T)
        sl, nx = slice(t0, end), slice(t0 + 1, end + 1)
        st, lam = states[:, sl], lams[:, nx]
        dr[:, sl] = torch.einsum("bthij,bthj->bthi", st, dy[:, sl])
        dk[:, sl] = torch.einsum("bthij,bthj->bthi", lam, v[:, sl])
        dv[:, sl] = torch.einsum("bthij,bthi->bthj", lam, k[:, sl])
        dlogw[:, sl] = w[:, sl] * (lam * st).sum(-1)
    dr += u * k * dyv
    dk += r * u * dyv
    dv += (r * u * k).sum(-1, keepdim=True) * dy
    du = (r * k * dyv).sum((0, 1))
    return dr, dk, dv, dlogw, du, lams[:, 0].clone()
