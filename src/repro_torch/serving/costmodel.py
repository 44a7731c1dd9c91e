"""Analytic cost model for iteration latencies and transfer times.

A copy of the reference package's cost model.  The port's engine uses it
as its modelled clock when ``EngineConfig.charge_real_time`` is False (the
CPU parity tests need the same clock, hence the same scheduling, as the
reference); its hardware presets are the reference's modelled figures and
are not measurements of this port on any device.  On the GPU the launcher
charges the card's wall clock instead.

The paper's wall-clock figures come from an A100-40GB + PCIe Gen4 testbed;
this container is CPU-only, so the discrete-event simulator replays the
paper's experiments against this calibrated model instead.  Default
constants are the A100 testbed (to reproduce the paper's numbers); a TPU
v5e preset is provided for the deployment target.

Transfer model (paper Fig. 4): per-copy fixed overhead dominates small
fragmented block copies —

    t(copy of b bytes) = overhead + b / peak_bw
    memcpy path:   one copy PER BLOCK (per head)   -> effective bw collapses
    FlashH2D/D2H:  ONE fused launch for all blocks -> near-peak bw

With 16 KB blocks and ~8 us per-call overhead the memcpy path yields
~2-4 GB/s and the fused path >20 GB/s, matching Fig. 4.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float              # FLOP/s (bf16/fp16 dense)
    hbm_bw: float                  # bytes/s
    hbm_capacity: float            # bytes
    host_link_bw: float            # bytes/s (PCIe / host DMA)
    host_capacity: float           # bytes (DRAM)
    per_copy_overhead: float       # seconds per individual memcpy call
    kernel_launch_overhead: float  # seconds per fused-kernel launch
    mfu: float = 0.45              # achievable fraction of peak flops
    mbu: float = 0.70              # achievable fraction of hbm bw
    link_eff_fused: float = 0.75   # fused transfers reach this of link peak
    ici_bw: float = 90e9           # bytes/s inter-chip interconnect (per
                                   # link: NVLink / TPU ICI) — collective
                                   # charging for the sharded planes
    collective_overhead: float = 5e-6  # seconds per collective launch


A100_40G = HardwareSpec(
    name="a100-40g", peak_flops=312e12, hbm_bw=1.555e12,
    hbm_capacity=40e9, host_link_bw=32e9, host_capacity=256e9,
    per_copy_overhead=8e-6, kernel_launch_overhead=12e-6)

TPU_V5E = HardwareSpec(
    name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
    hbm_capacity=16e9, host_link_bw=32e9, host_capacity=192e9,
    per_copy_overhead=6e-6, kernel_launch_overhead=10e-6)


# ---------------------------------------------------------------------------
# Transfer times (Fig. 4 / §3.2)
# ---------------------------------------------------------------------------

def memcpy_transfer_time(hw: HardwareSpec, n_copies: int,
                         bytes_per_copy: int) -> float:
    """Per-block cudaMemcpy path: overhead paid per fragment."""
    return n_copies * (hw.per_copy_overhead
                       + bytes_per_copy / hw.host_link_bw)


def fused_transfer_time(hw: HardwareSpec, total_bytes: int) -> float:
    """FlashH2D / FlashD2H: one launch, streaming at link_eff_fused."""
    return (hw.kernel_launch_overhead
            + total_bytes / (hw.host_link_bw * hw.link_eff_fused))


QUANT_SCALE_BYTES = 4  # f32 scale per (kv-head, block) per tensor (int8 tier)


def offload_block_bytes(n_kv_heads: int, head_dim: int, block_size: int,
                        kv_factor: int = 2, dtype_bytes: int = 2,
                        quant: str = "none") -> int:
    """Wire bytes of ONE KV block (one layer, all kv heads, K+V) as stored
    in the DRAM offload tier — what one FlashH2D/FlashD2H block transfer
    actually moves.

    ``quant="none"``: elements x ``dtype_bytes``.  ``quant="int8"``: 1 B
    per element + ``QUANT_SCALE_BYTES`` per (kv-head, block) per tensor —
    a ~``dtype_bytes``x shrink for realistic block sizes.  The engine
    charges the overlap model's per-layer transfer bytes with this, so the
    modeled transfer time reflects the tier."""
    elems_per_head = block_size * head_dim
    if quant == "int8":
        per_head = elems_per_head + QUANT_SCALE_BYTES
    elif quant == "none":
        per_head = elems_per_head * dtype_bytes
    else:
        raise ValueError(f"offload_block_bytes: unknown quant {quant!r}")
    return n_kv_heads * per_head * kv_factor


def offload_bytes_per_token(n_kv_heads: int, head_dim: int, block_size: int,
                            kv_factor: int = 2, dtype_bytes: int = 2,
                            quant: str = "none") -> float:
    """Per-token amortized wire bytes of the offload tier (one layer, all
    kv heads, K+V): ``offload_block_bytes / block_size``.  The scale
    overhead amortizes across the block's tokens, so int8 approaches
    exactly half the bf16 size as ``block_size`` grows."""
    return offload_block_bytes(n_kv_heads, head_dim, block_size,
                               kv_factor=kv_factor, dtype_bytes=dtype_bytes,
                               quant=quant) / block_size


def allgather_time(hw: HardwareSpec, total_bytes: int,
                   n_shards: int) -> float:
    """Ring all-gather of `total_bytes` (the FULL gathered size) across
    `n_shards`: each shard sends/receives (n-1)/n of the result over the
    interconnect.  The sharded planes move only small tensors this way —
    selected block ids, block scores, one window of fresh prefill K/V —
    never a pool."""
    if n_shards <= 1 or total_bytes <= 0:
        return 0.0
    return (hw.collective_overhead
            + total_bytes * (n_shards - 1) / n_shards / hw.ici_bw)


def effective_bandwidth(hw: HardwareSpec, n_copies: int, bytes_per_copy: int,
                        fused: bool) -> float:
    total = n_copies * bytes_per_copy
    t = (fused_transfer_time(hw, total) if fused
         else memcpy_transfer_time(hw, n_copies, bytes_per_copy))
    return total / t if t > 0 else 0.0


# ---------------------------------------------------------------------------
# Model compute / memory times
# ---------------------------------------------------------------------------

def layer_flops_per_token(d_model: int, d_ff: int, n_heads: int,
                          n_kv_heads: int, head_dim: int,
                          context: int, moe_top_k: int = 0,
                          moe_dense_residual: bool = False) -> float:
    """Forward FLOPs for one token through one layer (matmul 2x factor)."""
    qo = 2 * d_model * (n_heads * head_dim) * 2          # Wq + Wo
    kv = 2 * d_model * (n_kv_heads * head_dim) * 2       # Wk + Wv
    attn = 2 * 2 * n_heads * head_dim * context          # qk + pv
    ff_mult = (moe_top_k if moe_top_k else 1) + (1 if moe_dense_residual else 0)
    ffn = 3 * 2 * d_model * d_ff * ff_mult
    return qo + kv + attn + ffn


@dataclasses.dataclass(frozen=True)
class ModelCost:
    """Per-model constants the simulator needs (derived from ModelConfig)."""
    num_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    param_bytes: float            # total weight bytes (bf16)
    active_param_bytes: float     # MoE: active path only
    kv_bytes_per_token: float     # all layers, all kv heads, k+v
    moe_top_k: int = 0
    moe_dense_residual: bool = False

    @classmethod
    def from_config(cls, cfg, dtype_bytes: int = 2) -> "ModelCost":
        kv_per_tok = (cfg.num_attention_layers() * max(cfg.num_kv_heads, 1)
                      * cfg.kv_cache_dim * dtype_bytes
                      * (1 if cfg.attention_type == "mla" else 2))
        return cls(
            num_layers=cfg.num_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
            n_heads=max(cfg.num_heads, 1),
            n_kv_heads=max(cfg.num_kv_heads, 1),
            head_dim=max(cfg.head_dim, 1), vocab=cfg.vocab_size,
            param_bytes=cfg.param_count() * dtype_bytes,
            active_param_bytes=cfg.active_param_count() * dtype_bytes,
            kv_bytes_per_token=kv_per_tok,
            moe_top_k=cfg.top_k_experts,
            moe_dense_residual=cfg.moe_dense_residual)


def prefill_time(hw: HardwareSpec, mc: ModelCost, new_tokens: int,
                 context: int, layers: int = -1) -> float:
    """Compute-bound prefill of `new_tokens` attending to `context` total."""
    L = mc.num_layers if layers < 0 else layers
    per_tok = layer_flops_per_token(
        mc.d_model, mc.d_ff, mc.n_heads, mc.n_kv_heads, mc.head_dim,
        context, mc.moe_top_k, mc.moe_dense_residual)
    flops = new_tokens * per_tok * L
    return flops / (hw.peak_flops * hw.mfu)


def batched_prefill_time(hw: HardwareSpec, mc: ModelCost,
                         segs, layers: int = 1, n_shards: int = 1,
                         allgather_bytes: int = 0) -> float:
    """ONE batched prefill-plane launch (layer-segmented prefill §3.4).

    segs: [(new_tokens, context)] — one entry per request row in the
    launch.  The plane batches every same-layer segment of the prefill
    batch into a single jitted launch, so the kernel launch overhead is
    paid ONCE per (layer, chunk) group instead of once per request segment;
    compute is charged on each row's REAL tokens (padding is bucketed and
    masked, not charged).  The legacy per-request executor is charged with
    the same formula at batch 1, so the modeled plane-vs-legacy difference
    is exactly the launch amortization.

    n_shards > 1: the launch runs sequence-sharded across the plane mesh's
    model axis — but ONLY the O(tokens x context) attention term splits
    over the shards (projections and the FFN/MoE epilogue run replicated
    by design, for bitwise exactness; see
    ``model._prefill_attn_layer_batched_cp``), and the sharded attention
    outputs are re-gathered once per launch (`allgather_bytes`, the full
    gathered size)."""
    n = max(n_shards, 1)
    t = hw.kernel_launch_overhead
    for new_tokens, context in segs:
        t_full = prefill_time(hw, mc, new_tokens, context, layers=layers)
        if n > 1:
            # context-independent terms (projections, FFN/MoE) stay
            # replicated; the attention term (t_full - t_ctx0) shards
            t_ctx0 = prefill_time(hw, mc, new_tokens, 0, layers=layers)
            t += t_ctx0 + (t_full - t_ctx0) / n
        else:
            t += t_full
    return t + allgather_time(hw, allgather_bytes, n_shards)


def overlapped_decode_time(hw: HardwareSpec, mc: ModelCost, batch: int,
                           attended_tokens_per_req: float,
                           transfer_bytes_by_layer, n_shards: int = 1,
                           allgather_bytes_by_layer=None) -> float:
    """Staged-pipeline decode charge (§3.2's H2D/compute overlap).

    The fused plane charges decode compute + ALL restore transfer serially
    (one forward, transfers can only land after it).  The staged plane
    restores layer l's missing blocks while adjacent layers compute, so
    each layer is charged max(layer compute, layer transfer) instead of the
    sum — the paper's pipelining bound.

    transfer_bytes_by_layer: H2D restore payload bytes per MODEL layer this
    iteration (0 for layers with no misses or no paged KV); entries beyond
    ``mc.num_layers`` are ignored, missing entries charge compute only.

    n_shards > 1 (sharded plane): each shard scatters only the restore
    payloads that land in ITS pool slots, so per-layer transfer divides by
    the shard count; ``allgather_bytes_by_layer`` adds the per-layer
    collective (selected block ids crossing the model axis so the host can
    stage GLOBAL ids), charged serially — the host sync sits between
    select and attend and cannot overlap the layer's own restore."""
    t_layer = decode_time(hw, mc, batch, attended_tokens_per_req) \
        / max(mc.num_layers, 1)
    n = max(n_shards, 1)
    ag = list(allgather_bytes_by_layer or [])
    t = 0.0
    per_layer = list(transfer_bytes_by_layer)[:mc.num_layers]
    for i, b in enumerate(per_layer):
        t_tx = fused_transfer_time(hw, b / n) if b > 0 else 0.0
        t += max(t_layer, t_tx)
        if i < len(ag):
            t += allgather_time(hw, ag[i], n)
    t += t_layer * max(0, mc.num_layers - len(per_layer))
    return t


def mixed_iteration_time(hw: HardwareSpec, mc: ModelCost, batch: int,
                         attended_tokens_per_req: float,
                         transfer_bytes_by_layer,
                         prefill_time_by_layer=None, n_shards: int = 1,
                         allgather_bytes_by_layer=None) -> float:
    """ONE mixed iteration of the hybrid plane (decode rows AND prefill
    segments in the same layer walk, ``core.hybrid_plane``).

    Per model layer the walk runs decode select/attend AND the layer's
    prefill groups, while the single per-layer host stage moves the
    layer's fused FlashD2H/H2D payloads — so each layer is charged
    max(decode layer compute + prefill layer compute, layer transfer),
    the union of both planes' compute overlapping the shared transfer
    (same pipelining bound as ``overlapped_decode_time``, with the
    prefill launches joining the compute side of the max).

    prefill_time_by_layer: modeled seconds of this iteration's prefill
    launches per MODEL layer (``batched_prefill_time`` per group, already
    including sharded allgathers); None or missing entries charge decode
    only.  ``batch == 0`` (pure-prefill iteration) degenerates to the sum
    of the prefill layer times vs the transfers."""
    t_layer = (decode_time(hw, mc, batch, attended_tokens_per_req)
               / max(mc.num_layers, 1)) if batch > 0 else 0.0
    n = max(n_shards, 1)
    ag = list(allgather_bytes_by_layer or [])
    pf = list(prefill_time_by_layer or [])
    t = 0.0
    per_layer = list(transfer_bytes_by_layer)[:mc.num_layers]
    for i in range(mc.num_layers):
        b = per_layer[i] if i < len(per_layer) else 0
        t_tx = fused_transfer_time(hw, b / n) if b > 0 else 0.0
        t_cmp = t_layer + (pf[i] if i < len(pf) else 0.0)
        t += max(t_cmp, t_tx)
        if batch > 0 and i < len(ag):
            t += allgather_time(hw, ag[i], n)
    return t


def decode_time(hw: HardwareSpec, mc: ModelCost, batch: int,
                attended_tokens_per_req: float) -> float:
    """Memory-bound decode iteration: weights read once per iteration +
    attended KV read per request.  attended = full context (vLLM) or the
    DSA token budget (sparse)."""
    weight_bytes = mc.active_param_bytes
    kv_bytes = batch * attended_tokens_per_req * mc.kv_bytes_per_token
    flops = batch * layer_flops_per_token(
        mc.d_model, mc.d_ff, mc.n_heads, mc.n_kv_heads, mc.head_dim,
        attended_tokens_per_req, mc.moe_top_k,
        mc.moe_dense_residual) * mc.num_layers
    t_mem = (weight_bytes + kv_bytes) / (hw.hbm_bw * hw.mbu)
    t_cmp = flops / (hw.peak_flops * hw.mfu)
    return max(t_mem, t_cmp)
