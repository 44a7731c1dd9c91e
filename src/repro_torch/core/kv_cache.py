"""Hierarchical HBM–DRAM KV cache manager (paper §3.1 "KV Cache Manager").

Control plane: block-table bookkeeping, HBM LRU cache, transfer accounting
(``KVGeometry``, ``TransferStats`` and ``HBMCache`` are copies of the
reference's).  Data plane: one host block pool per request, a float32
tensor that lies in pinned memory when the engine runs on the GPU.
FlashH2D reads it IN PLACE through the ``gather_blocks_hkv`` kernel, so the
gather is the host-to-device transfer; FlashD2H stages contiguous stripes
and scatters them into the pool on the CPU (``flush``).  The pool stays
float32, as the reference's numpy pool is, so every byte counter is the
reference's.  Only the fp offload tier is ported (``quant="none"``).

Blocks are tracked per (layer, kv_head, block_id) — the paper's per-head
granularity (Fig. 5, (H, N, D) layout) — so transfer sizes and hit rates
match what an A100/v5e deployment would see.

All byte/transfer counters feed the cost model (`serving/costmodel.py`)
and the Fig. 4 / Fig. 14 / Fig. 15 benchmarks.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.device import host_to_device
from repro_torch.kernels import ops
from repro_torch.obs.tracing import NULL_TRACER


@dataclasses.dataclass
class KVGeometry:
    """Shape of one request's KV cache."""
    num_layers: int          # attention layers only
    num_kv_heads: int
    block_size: int          # tokens per block
    head_dim: int            # cached dim per token per head (MLA: latent)
    dtype_bytes: int = 2     # bf16
    kv_factor: int = 2       # k and v (MLA latent: 1)

    @property
    def block_bytes_per_head(self) -> int:
        """Bytes of ONE block for ONE kv head at the MODELED device dtype
        (``dtype_bytes``, bf16 by default), K and V together
        (``kv_factor``).  This is the deployment-sized unit the cost model
        charges transfers in; it is independent of the f32 numpy pools the
        smoke data plane happens to hold, and of the offload tier's stored
        size (``HostPool.wire_bytes`` for that)."""
        return self.block_size * self.head_dim * self.dtype_bytes * self.kv_factor

    @property
    def block_bytes(self) -> int:
        """One block id across ALL layers and kv heads — the working-set
        unit (bytes per entry of a request's block table).  Scheduler
        admission (M_avl) and working-set estimates use this; per-transfer
        accounting uses the per-(layer, head) slices instead."""
        return self.block_bytes_per_head * self.num_kv_heads * self.num_layers

    def tokens_bytes(self, n_tokens: int) -> int:
        """Logical KV bytes of ``n_tokens`` across all layers/heads at the
        modeled dtype (no block-size round-up)."""
        return (n_tokens * self.head_dim * self.dtype_bytes * self.kv_factor
                * self.num_kv_heads * self.num_layers)


@dataclasses.dataclass
class TransferStats:
    """PCIe/DMA traffic counters, booked exactly once per moved byte.

    Units: ``*_bytes`` are bytes AS STORED IN THE OFFLOAD TIER (the wire
    size of the DMA) — under ``offload_quant="int8"`` that is the int8
    payload plus 4 B per (kv-head, block) scale, NOT the logical fp size;
    with the default fp tier the two coincide.  ``*_calls`` count fused
    kernel launches (one FlashH2D/FlashD2H per layer per iteration under
    batching), ``*_blocks`` count (block x kv-head) units moved.

    Who books what (the staged-vs-accounted split): ``HBMCache.access``
    books residency only (hits/misses/evictions); ``HostPool.stage``
    appends to staging WITHOUT booking (it returns the wire bytes so the
    one fused caller can book them); bytes/calls land at the single fused
    data-plane call (``KVCacheManager.load_blocks_fused`` /
    ``save_new_tokens_fused`` on ``fused_stats``); ``HostPool.flush``
    books ``d2h_blocks`` only — a staged byte is never counted twice.
    """
    h2d_bytes: int = 0          # wire bytes (stored size, see above)
    h2d_calls: int = 0          # fused kernel launches (FlashH2D)
    h2d_blocks: int = 0         # fragmented (block x kv-head) units moved
    d2h_bytes: int = 0
    d2h_calls: int = 0
    d2h_blocks: int = 0
    evictions: int = 0
    hits: int = 0
    misses: int = 0

    def merge(self, o: "TransferStats") -> None:
        for f in dataclasses.fields(TransferStats):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))


class HBMCache:
    """LRU cache of HBM-resident KV blocks for ONE request.

    Keys are (layer, block_id); all kv heads of a block move together (the
    per-head transfer granularity is reflected in byte accounting).  The LRU
    policy exploits the temporal locality of DSA block selection —
    consecutive query tokens select highly-overlapping blocks (§3.1/Fig. 8).
    """

    def __init__(self, geom: KVGeometry, capacity_blocks: int):
        self.geom = geom
        self.capacity = capacity_blocks            # in (layer, block) units
        self._lru: "collections.OrderedDict[Tuple[int,int], bool]" = \
            collections.OrderedDict()
        # eviction keys are recorded only when a consumer drains them
        # (engine with drop_evicted_device_blocks): unconditional recording
        # would grow without bound on the default path
        self.track_evictions = False
        self._evicted: List[Tuple[int, int]] = []  # since last pop_evicted
        self.stats = TransferStats()

    def resident(self, layer: int, block: int) -> bool:
        return (layer, block) in self._lru

    @property
    def num_resident(self) -> int:
        return len(self._lru)

    def access(self, layer: int, blocks: List[int]) -> List[int]:
        """Touch `blocks` for `layer`; return the MISSING block ids (to load).

        Units: `blocks` are block *ids* (``block_size`` tokens each); one
        LRU entry is one (layer, block) key covering all kv heads.  Evicts
        LRU entries beyond capacity (retrievable until the next
        ``pop_evicted``).  Residency accounting ONLY (hits/misses/
        evictions): the actual FlashH2D transfer — and its h2d_* stats —
        happens exactly once, in the data plane (``HostPool.load_blocks`` /
        ``KVCacheManager.load_blocks_fused``), so ``total_stats`` never
        double-counts a transfer.
        """
        missing = []
        for b in blocks:
            key = (layer, b)
            if key in self._lru:
                self._lru.move_to_end(key)
                self.stats.hits += 1
            else:
                missing.append(b)
                self.stats.misses += 1
        for b in missing:
            self._lru[(layer, b)] = True
        self._evict_over_capacity()
        return missing

    def _evict_over_capacity(self) -> None:
        while len(self._lru) > self.capacity:
            key = self._lru.popitem(last=False)[0]
            if self.track_evictions:
                self._evicted.append(key)
            self.stats.evictions += 1

    def pop_evicted(self) -> List[Tuple[int, int]]:
        """Drain the (layer, block) keys evicted since the last call — the
        engine zeroes these device slots when
        ``drop_evicted_device_blocks`` is on (which also sets
        ``track_evictions``; keys are not recorded otherwise)."""
        out, self._evicted = self._evicted, []
        return out

    def insert(self, layer: int, block: int) -> None:
        """Insert a freshly produced block (decode append) without a load."""
        self._lru[(layer, block)] = True
        self._lru.move_to_end((layer, block))
        self._evict_over_capacity()

    def drop_layer(self, layer: int) -> int:
        """Evict all blocks of one layer (layer-segmented prefill §3.4)."""
        keys = [k for k in self._lru if k[0] == layer]
        for k in keys:
            del self._lru[k]
        return len(keys)


class HostPool:
    """Host-DRAM block pool for ONE request (data plane).

    K/V blocks live in float32 tensors shaped (L, Hkv, NB, bs, D), pinned
    when ``device`` is a GPU.  Saving follows FlashD2H: the contiguous
    per-iteration KV stripe is appended to a staging list in one "memcpy"
    and scattered into blocks lazily (``flush``, numpy writes into the
    tensors' memory, in place), mirroring the paper's CPU-assisted
    two-phase save.  Gathering follows FlashH2D: ONE ``gather_blocks_hkv``
    launch per (pool, layer) reads the fragmented blocks of the pinned
    pool and lands them in device memory.
    """

    def __init__(self, geom: KVGeometry, num_blocks: int,
                 quant: str = "none", device="cpu"):
        if quant != "none":
            raise NotImplementedError(
                f"HostPool: offload tier {quant!r} is not ported yet")
        g = geom
        self.geom = g
        self.num_blocks = num_blocks
        self.quant = quant
        self.device = torch.device(device)
        shape = (g.num_layers, g.num_kv_heads, num_blocks, g.block_size,
                 g.head_dim)
        pin = self.device.type == "cuda"
        self.k = torch.zeros(shape, dtype=torch.float32, pin_memory=pin)
        self.v = (torch.zeros(shape, dtype=torch.float32, pin_memory=pin)
                  if g.kv_factor == 2 else None)
        self._k_np = self.k.numpy()               # views for flush
        self._v_np = None if self.v is None else self.v.numpy()
        self._staging: List[Tuple[int, int, np.ndarray,
                                  Optional[np.ndarray]]] = []
        self.stats = TransferStats()

    def wire_bytes(self, n_blocks: int) -> int:
        """Bytes ``n_blocks`` whole blocks occupy as stored in this pool —
        the wire size of moving them (one layer, all kv heads, K+V)."""
        g = self.geom
        per_head = g.block_size * g.head_dim * self.k.element_size()
        kvf = 2 if self.v is not None else 1
        return n_blocks * g.num_kv_heads * per_head * kvf

    def stage(self, layer: int, start_token: int, k_new: np.ndarray,
              v_new: Optional[np.ndarray]) -> int:
        """Append one contiguous KV stripe (k_new/v_new (Hkv, T, D) numpy,
        T tokens from absolute position ``start_token``) to the staging
        list WITHOUT booking d2h stats; returns its wire bytes for the one
        fused caller to book.  Out-of-range stripes raise ``ValueError``."""
        T = k_new.shape[1]
        end_token = start_token + T
        max_tokens = self.num_blocks * self.geom.block_size
        if start_token < 0 or end_token > max_tokens:
            raise ValueError(
                f"HostPool.stage: tokens [{start_token}, {end_token})"
                f" exceed the registered pool capacity of {max_tokens} tokens"
                f" ({self.num_blocks} blocks x {self.geom.block_size}); "
                f"register the request with a larger max_tokens")
        self._staging.append((layer, start_token, np.asarray(k_new),
                              None if v_new is None else np.asarray(v_new)))
        kvf = 2 if v_new is not None else 1
        return k_new.nbytes * kvf

    def flush(self) -> int:
        """Phase 2 of FlashD2H: CPU-side scatter of staged stripes into the
        per-head block layout, in place.  Returns blocks written; books
        ``d2h_blocks`` only."""
        g = self.geom
        written = 0
        for layer, start, k_new, v_new in self._staging:
            T = k_new.shape[1]
            t0 = 0
            while t0 < T:
                blk = (start + t0) // g.block_size
                off = (start + t0) % g.block_size
                if blk >= self.num_blocks:
                    raise ValueError(
                        f"HostPool.flush: staged token {start + t0} maps to "
                        f"block {blk} but the pool only has "
                        f"{self.num_blocks} blocks")
                t1 = min(t0 + (g.block_size - off), T)
                self._k_np[layer, :, blk, off:off + (t1 - t0)] = \
                    k_new[:, t0:t1]
                if v_new is not None:
                    self._v_np[layer, :, blk, off:off + (t1 - t0)] = \
                        v_new[:, t0:t1]
                written += 1
                self.stats.d2h_blocks += 1
                t0 = t1
        self._staging.clear()
        return written

    def gather(self, layer: int, blocks: List[int]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Data-plane gather of fragmented blocks — NO accounting.

        Returns (k (Hkv, K, bs, D), v or None) float32 on the pool's
        compute device: one ``gather_blocks_hkv`` launch per tensor reading
        the pinned pool in place on the GPU, the plain gather on the CPU."""
        if blocks and (max(blocks) >= self.num_blocks or min(blocks) < 0):
            bad = max(blocks) if max(blocks) >= self.num_blocks \
                else min(blocks)
            raise ValueError(
                f"HostPool.gather: block {bad} out of range "
                f"(pool has {self.num_blocks} blocks)")
        idx = host_to_device(blocks, self.device)
        k = ops.gather_blocks_hkv(self.k[layer], idx)
        v = None if self.v is None else ops.gather_blocks_hkv(
            self.v[layer], idx)
        return k, v


class KVCacheManager:
    """System-wide manager: per-request HBM caches + host pools + global
    HBM budget (M_avl feeds the scheduler's Algorithm 1)."""

    def __init__(self, geom: KVGeometry, hbm_budget_bytes: int,
                 host_budget_bytes: Optional[int] = None,
                 offload_quant: str = "none", device="cpu"):
        if offload_quant != "none":
            raise NotImplementedError(
                f"KVCacheManager: offload tier {offload_quant!r} is not "
                f"ported yet")
        self.device = torch.device(device)
        self.geom = geom
        self.hbm_budget_bytes = hbm_budget_bytes
        self.host_budget_bytes = host_budget_bytes
        self.offload_quant = offload_quant
        self.caches: Dict[str, HBMCache] = {}
        self.pools: Dict[str, HostPool] = {}
        self._retired_stats = TransferStats()   # stats of released requests
        self.fused_stats = TransferStats()      # batched FlashH2D launches
        self.tracer = NULL_TRACER               # engine installs a live
                                                # Tracer when obs is on

    # -- lifecycle ---------------------------------------------------------
    def register(self, req_id: str, max_tokens: int,
                 hbm_blocks_per_request: int) -> None:
        nb = -(-max_tokens // self.geom.block_size)
        self.caches[req_id] = HBMCache(self.geom, hbm_blocks_per_request)
        self.pools[req_id] = HostPool(self.geom, nb,
                                      quant=self.offload_quant,
                                      device=self.device)

    def release(self, req_id: str) -> None:
        c = self.caches.pop(req_id, None)
        p = self.pools.pop(req_id, None)
        if c is not None:
            self._retired_stats.merge(c.stats)
        if p is not None:
            self._retired_stats.merge(p.stats)

    # -- control plane -----------------------------------------------------
    def access_layer(self, layer: int, blocks_by_req: Dict[str, List[int]],
                     drain_evicted: bool = False
                     ) -> Tuple[Dict[str, List[int]],
                                Dict[str, List[Tuple[int, int]]]]:
        """Touch one layer's selected blocks for every request of a decode
        iteration (LRU residency only — no transfer accounting; see
        ``HBMCache.access``).

        The per-layer unit matches the decode planes: the fused plane calls
        this once per layer after its single forward, the staged plane calls
        it between a layer's select and attend stages so the returned
        ``missing`` can be loaded (``load_blocks_fused``) and restored into
        device slots BEFORE that layer's attention.

        `layer` is the attention-layer ordinal.  Returns
        (missing_by_req, evicted_by_req): the block ids each request must
        load, and — when ``drain_evicted`` — the (layer, block) keys each
        request's LRU evicted during these accesses (``pop_evicted``; empty
        lists otherwise).  Requests without a registered cache are skipped.
        """
        missing_by_req: Dict[str, List[int]] = {}
        evicted_by_req: Dict[str, List[Tuple[int, int]]] = {}
        for req_id, blocks in blocks_by_req.items():
            cache = self.caches.get(req_id)
            if cache is None:
                continue
            missing = cache.access(layer, blocks)
            if missing:
                missing_by_req[req_id] = missing
            if drain_evicted:
                evicted_by_req[req_id] = cache.pop_evicted()
        return missing_by_req, evicted_by_req

    # -- data plane --------------------------------------------------------
    def load_blocks_fused(self, layer: int,
                          blocks_by_req: Dict[str, List[int]]
                          ) -> Dict[str, Tuple[torch.Tensor,
                                               Optional[torch.Tensor]]]:
        """ONE fused FlashH2D launch covering every missing block of `layer`
        across the whole decode batch (batched engine hot path).

        The paper's FlashH2D kernel gathers fragmented blocks from pinned
        DRAM in a single launch; under batched decode the launch amortizes
        over ALL requests in the iteration, so h2d_calls grows
        per-layer-per-iteration, not per-request.  Accounting lives HERE and
        only here for these transfers (``HBMCache.access`` books residency
        only), so each moved block is counted exactly once: h2d_calls in
        fused launches, h2d_blocks in (block x kv-head) units, h2d_bytes in
        K+V payload bytes AT STORED SIZE (``HostPool.wire_bytes`` — int8 +
        scales under ``offload_quant="int8"``, fp bytes otherwise).

        `layer` is the attention-layer ORDINAL (0..geom.num_layers-1), not
        the model layer id; `blocks_by_req` values are block ids, each
        bounds-checked by ``HostPool.gather`` against the pool registered
        at ``register`` time.  Returns {req_id: (k (Hkv,K,bs,D), v|None)} —
        under the persistent decode plane the engine scatters these
        payloads DIRECTLY into the requests' device slots
        (``DevicePoolPlane.restore_blocks``)."""
        tr = self.tracer
        if tr.enabled:
            _ts = time.perf_counter()
        out: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
        total_blocks = 0
        total_bytes = 0
        for req_id, blocks in blocks_by_req.items():
            pool = self.pools.get(req_id)
            if pool is None or not blocks:
                continue
            k, v = pool.gather(layer, blocks)
            out[req_id] = (k, v)
            total_blocks += len(blocks) * self.geom.num_kv_heads
            total_bytes += pool.wire_bytes(len(blocks))
        if total_blocks:
            self.fused_stats.h2d_calls += 1
            self.fused_stats.h2d_blocks += total_blocks
            self.fused_stats.h2d_bytes += total_bytes
            if tr.enabled:
                tr.end("FlashH2D", "transfer", _ts, layer=layer,
                       blocks=total_blocks, bytes=total_bytes,
                       fused_reqs=len(out))
        return out

    def save_new_tokens_fused(self, layer: int,
                              kv_by_req: Dict[str, Tuple[int, np.ndarray,
                                                         Optional[np.ndarray]]]
                              ) -> None:
        """ONE fused FlashD2H save of this iteration's newly produced KV
        for `layer` across a whole batch — the decode planes' per-layer
        write-back AND the prefill plane's per-(layer, chunk)-group save
        (each batched prefill launch saves every request's stripe through
        one call here).

        kv_by_req: {req_id: (start_token, k (Hkv,T,D), v or None)}.  Under
        batching the stripe is contiguous across the batch, so the paper
        saves it with one D2H DMA per layer per iteration; accordingly
        ``d2h_calls`` is booked ONCE here (on ``fused_stats``) while each
        pool stages its stripe without accounting (``HostPool.stage``).
        The CPU-side scatter into blocks still happens at each pool's
        ``flush``.  With the default fp tier the host pool stays a
        byte-exact superset of device KV; under ``offload_quant="int8"``
        it is a BOUNDED-ERROR superset (per-block per-head scales), and
        either way ``load_blocks_fused`` payloads come back in the compute
        dtype — dequantized at gather — so they stay safe to scatter
        straight into device slots.  Staged bytes are booked at wire size
        (see ``HostPool.stage``)."""
        tr = self.tracer
        if tr.enabled:
            _ts = time.perf_counter()
        total_bytes = 0
        for req_id, (start, k, v) in kv_by_req.items():
            pool = self.pools.get(req_id)
            if pool is None:
                continue
            total_bytes += pool.stage(layer, start, k, v)
        if total_bytes:
            self.fused_stats.d2h_calls += 1
            self.fused_stats.d2h_bytes += total_bytes
            # in async mode this fires on the HostStageWorker thread —
            # the tracer is thread-safe and books the span to that tid
            if tr.enabled:
                tr.end("FlashD2H", "transfer", _ts, layer=layer,
                       bytes=total_bytes, fused_reqs=len(kv_by_req))

    # -- accounting --------------------------------------------------------
    def hbm_used_bytes(self) -> int:
        per_lb = (self.geom.block_bytes_per_head * self.geom.num_kv_heads)
        return sum(c.num_resident * per_lb for c in self.caches.values())

    def total_stats(self) -> TransferStats:
        s = TransferStats()
        s.merge(self._retired_stats)
        s.merge(self.fused_stats)
        for c in self.caches.values():
            s.merge(c.stats)
        for p in self.pools.values():
            s.merge(p.stats)
        return s
