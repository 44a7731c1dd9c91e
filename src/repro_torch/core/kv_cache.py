"""Hierarchical HBM–DRAM KV cache manager (paper §3.1 "KV Cache Manager").

Control plane: block-table bookkeeping, HBM LRU cache, transfer accounting
(``KVGeometry``, ``TransferStats`` and ``HBMCache`` are copies of the
reference's).  Data plane: one host block pool per request, tensors that
lie in pinned memory when the engine runs on the GPU.  FlashH2D reads them
IN PLACE through the ``gather_blocks_hkv`` kernel, so the gather is the
host-to-device transfer; FlashD2H stages contiguous stripes and scatters
them into the pool at ``flush``.  The fp tier (``quant="none"``) keeps
float32 pools, as the reference's numpy pools are, so every byte counter
is the reference's.  The int8 tier (``quant="int8"``) keeps int8 pools
with one float32 scale per (layer, kv-head, block) and requantizes each
touched block at ``flush``: on the GPU through the quant kernels, on the
CPU through their plain versions, writing the reference's bytes either
way.

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
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import HostCopy, OnDevice, host_to_device
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

    @classmethod
    def of_model(cls, cfg) -> "KVGeometry":
        """The engine's geometry for a ``ModelConfig``: MLA caches one
        latent (``kv_factor`` 1), counted over ``max(num_kv_heads, 1)``
        heads and ``max(num_attention_layers, 1)`` layers as the
        reference counts them (an attention-free model, RWKV6, has one
        layer of zero-byte blocks: head_dim 0)."""
        return cls(num_layers=max(cfg.num_attention_layers(), 1),
                   num_kv_heads=max(cfg.num_kv_heads, 1),
                   block_size=cfg.dsa.block_size, head_dim=cfg.kv_cache_dim,
                   kv_factor=1 if cfg.attention_type == "mla" else 2)

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

    @property
    def stored_heads(self) -> int:
        """Heads a host pool physically holds: ``num_kv_heads``, or one
        for MLA's latent (``kv_factor`` 1).  The reference's numpy pool
        broadcasts the one latent head over ``num_kv_heads`` and restores
        head 0 of it; the port stores that head once.  Every byte and
        block counter keeps the reference's ``num_kv_heads`` (an
        accounting factor for MLA), so ``TransferStats`` stay equal."""
        return 1 if self.kv_factor == 1 else self.num_kv_heads

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


QUANT_SCALE_BYTES = 4  # one f32 scale per (kv-head, block) per tensor



class QuantBlocks(NamedTuple):
    """Gathered blocks of the int8 tier: q (Hkv, K, bs, D) int8 and their
    scales (Hkv, K) float32."""
    q: torch.Tensor
    scales: torch.Tensor


class HostPool:
    """Host-DRAM block pool for ONE request (data plane).

    K/V blocks live in tensors shaped (L, Hkv, NB, bs, D), pinned when
    ``device`` is a GPU (MLA: K only, one latent head; ``stored_heads``): float32 in the fp tier, int8 with float32 scale
    planes (L, Hkv, NB) (``k_scale``/``v_scale``) in the int8 tier.  Saving
    follows FlashD2H: the contiguous per-iteration KV stripe is appended to
    a staging list in one "memcpy" and scattered into blocks lazily
    (``flush``), mirroring the paper's CPU-assisted two-phase save.  A
    stripe lies where ``KVCacheManager.ship`` put it: in host memory, or
    in the int8 tier on the GPU on the device (the save then never copies
    fp data to the host).  Gathering follows
    FlashH2D: ONE ``gather_blocks_hkv`` launch per (pool, layer) reads the
    fragmented blocks of the pinned pool and lands them in device memory
    (in the int8 tier, one more for the scales).
    """

    def __init__(self, geom: KVGeometry, num_blocks: int,
                 quant: str = "none", device="cpu"):
        if quant not in ("none", "int8"):
            raise ValueError(f"HostPool: unknown quant mode {quant!r}")
        g = geom
        self.geom = g
        self.num_blocks = num_blocks
        self.quant = quant
        self.device = torch.device(device)
        shape = (g.num_layers, g.stored_heads, num_blocks, g.block_size,
                 g.head_dim)
        pin = self.device.type == "cuda"
        dt = torch.int8 if quant == "int8" else torch.float32
        self.k = torch.zeros(shape, dtype=dt, pin_memory=pin)
        self.v = (torch.zeros(shape, dtype=dt, pin_memory=pin)
                  if g.kv_factor == 2 else None)
        self.k_scale = self.v_scale = None
        if quant == "int8":
            sshape = (g.num_layers, g.stored_heads, num_blocks)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       pin_memory=pin)
            self.v_scale = (torch.zeros(sshape, dtype=torch.float32,
                                        pin_memory=pin)
                            if self.v is not None else None)
            # the pools as the save's kernel reaches them, mapped once
            self.k_quant = ops.QuantPool(self.k, self.k_scale)
            self.v_quant = (ops.QuantPool(self.v, self.v_scale)
                            if self.v is not None else None)
        self._staging: List[Tuple[int, int, torch.Tensor,
                                  Optional[torch.Tensor]]] = []
        self.stats = TransferStats()

    def wire_bytes(self, n_blocks: int) -> int:
        """Bytes ``n_blocks`` whole blocks occupy AS STORED in this pool —
        the wire size of moving them (one layer, all kv heads, K+V): the
        fp tier's float32 elements, or the int8 tier's 1 B per element
        plus ``QUANT_SCALE_BYTES`` per (kv-head, block) per tensor."""
        g = self.geom
        elems_per_head = g.block_size * g.head_dim
        if self.quant == "int8":
            per_head = elems_per_head + QUANT_SCALE_BYTES
        else:
            per_head = elems_per_head * self.k.element_size()
        kvf = 2 if self.v is not None else 1
        return n_blocks * g.num_kv_heads * per_head * kvf

    def stage(self, layer: int, start_token: int, k_new, v_new) -> int:
        """Append one contiguous KV stripe (k_new/v_new (Hkv, T, D) tensors
        or numpy arrays, T tokens from absolute position ``start_token``;
        v_new may be None) to the staging list
        WITHOUT booking d2h stats; returns its wire bytes for the one fused
        caller to book: the fp stripe's bytes, or in the int8 tier the
        int8 payload plus one scale per touched (kv-head, block) per
        tensor.  Out-of-range stripes raise ``ValueError``."""
        T = k_new.shape[1]
        end_token = start_token + T
        max_tokens = self.num_blocks * self.geom.block_size
        if start_token < 0 or end_token > max_tokens:
            raise ValueError(
                f"HostPool.stage: tokens [{start_token}, {end_token})"
                f" exceed the registered pool capacity of {max_tokens} tokens"
                f" ({self.num_blocks} blocks x {self.geom.block_size}); "
                f"register the request with a larger max_tokens")
        k_new = torch.as_tensor(k_new)
        v_new = None if v_new is None else torch.as_tensor(v_new)
        self._staging.append((layer, start_token, k_new, v_new))
        kvf = 2 if v_new is not None else 1
        if self.quant == "int8":
            if T == 0:
                return 0
            bs = self.geom.block_size
            touched = (end_token - 1) // bs - start_token // bs + 1
            elems = T * self.geom.num_kv_heads * k_new.shape[2]
            scale_b = touched * self.geom.num_kv_heads * QUANT_SCALE_BYTES
            return (elems + scale_b) * kvf
        return k_new.nbytes * kvf

    def save_contiguous(self, layer: int, start_token: int, k_new,
                        v_new) -> None:
        """Phase 1 of FlashD2H for ONE request: one contiguous stripe
        (k_new/v_new (Hkv, T, D), as ``stage`` takes them) into staging.
        Books exactly one ``d2h_calls`` and the stripe's wire bytes on this
        pool; ``flush`` books ``d2h_blocks``."""
        nbytes = self.stage(layer, start_token, k_new, v_new)
        self.stats.d2h_calls += 1
        self.stats.d2h_bytes += nbytes

    def flush(self) -> int:
        """Phase 2 of FlashD2H: scatter of staged stripes into the per-head
        block layout, in place, in staging order.  Returns blocks written
        (block-boundary segments: a stripe spanning two blocks writes two);
        books ``d2h_blocks`` only.  In the int8 tier every touched block is
        dequantized with its current per-head scales, overlaid with the
        stripe's tokens and requantized with fresh scales (the reference's
        ``_store_quant_span`` per (stripe, block) segment): one
        ``quant_save_blocks`` call, on the GPU a kernel that reads and
        writes the pinned pool in place, on the CPU its plain version."""
        if self.quant == "int8":
            saves, written = self.take_saves()
            ops.quant_save_blocks(saves)
            return written
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
                self.k[layer, :, blk, off:off + (t1 - t0)] = k_new[:, t0:t1]
                if v_new is not None:
                    self.v[layer, :, blk, off:off + (t1 - t0)] = \
                        v_new[:, t0:t1]
                written += 1
                self.stats.d2h_blocks += 1
                t0 = t1
        self._staging.clear()
        return written

    def take_saves(self) -> Tuple[List[ops.QuantSave], int]:
        """int8 tier: the staged stripes as ``quant_save_blocks`` items, K
        then V of each stripe, in staging order; books ``d2h_blocks`` and
        clears the staging.  Returns (items, blocks written: a stripe's
        block-boundary segments, K and V counted once)."""
        bs = self.geom.block_size
        saves: List[ops.QuantSave] = []
        written = 0
        for layer, start, k_new, v_new in self._staging:
            T = k_new.shape[1]
            if T == 0:
                continue
            for pool, new in ((self.k_quant, k_new), (self.v_quant, v_new)):
                if new is not None:
                    saves.append(ops.QuantSave(pool, layer, start, new))
            written += (start + T - 1) // bs - start // bs + 1
        self.stats.d2h_blocks += written
        self._staging.clear()
        return saves, written

    def gather(self, layer: int, blocks: List[int]):
        """Data-plane gather of fragmented blocks — NO accounting.

        Returns (k, v or None) on the pool's compute device: one
        ``gather_blocks_hkv`` launch per tensor reading the pinned pool in
        place on the GPU, the plain gather on the CPU.  fp tier: k/v
        (Hkv, K, bs, D) float32.  int8 tier: each a ``QuantBlocks`` of the
        stored int8 payload and its scales (one more gather launch per
        tensor), dequantized where they land (``dequantize_scatter_blocks``
        in ``DevicePoolPlane.restore_blocks_fused``)."""
        if blocks and (max(blocks) >= self.num_blocks or min(blocks) < 0):
            bad = max(blocks) if max(blocks) >= self.num_blocks \
                else min(blocks)
            raise ValueError(
                f"HostPool.gather: block {bad} out of range "
                f"(pool has {self.num_blocks} blocks)")
        idx = host_to_device(blocks, self.device)
        if self.quant == "int8":
            return tuple(
                None if pool is None else self._gather_quant(
                    pool, scale, layer, idx)
                for pool, scale in ((self.k, self.k_scale),
                                    (self.v, self.v_scale)))
        k = ops.gather_blocks_hkv(self.k[layer], idx)
        v = None if self.v is None else ops.gather_blocks_hkv(
            self.v[layer], idx)
        return k, v

    def _gather_quant(self, pool: torch.Tensor, scale: torch.Tensor,
                      layer: int, idx: torch.Tensor) -> QuantBlocks:
        H, K = pool.shape[1], idx.shape[0]
        splane = scale[layer].view(H, self.num_blocks, 1, 1)
        return QuantBlocks(ops.gather_blocks_hkv(pool[layer], idx),
                           ops.gather_blocks_hkv(splane, idx).view(H, K))


class KVCacheManager:
    """System-wide manager: per-request HBM caches + host pools + global
    HBM budget (M_avl feeds the scheduler's Algorithm 1)."""

    def __init__(self, geom: KVGeometry, hbm_budget_bytes: int,
                 host_budget_bytes: Optional[int] = None,
                 offload_quant: str = "none", device="cpu"):
        if offload_quant not in ("none", "int8"):
            raise ValueError(
                f"KVCacheManager: unknown offload_quant {offload_quant!r}")
        self.device = torch.device(device)
        self.geom = geom
        self.hbm_budget_bytes = hbm_budget_bytes
        self.host_budget_bytes = host_budget_bytes
        self.offload_quant = offload_quant
        # where a save's stripes go: the int8 tier on the GPU quantizes
        # them on the device; otherwise they are copied to host memory
        self.device_save = (offload_quant == "int8"
                            and self.device.type == "cuda")
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

    def ship(self, *tensors: Optional[torch.Tensor]):
        """A save's device stripes on their way to the host pools: a
        ``HostCopy`` into host memory, launched now on the current stream,
        or (``device_save``) an ``OnDevice`` that leaves them on the
        device.  Its ``wait()`` gives the stripes ``HostPool.stage``
        takes."""
        return OnDevice(*tensors) if self.device_save else HostCopy(*tensors)

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
                          ) -> Dict[str, Tuple[Any, Any]]:
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
        at ``register`` time.  Returns {req_id: (k, v|None)} as
        ``HostPool.gather`` gives them (float32 (Hkv,K,bs,D) blocks, or
        ``QuantBlocks`` in the int8 tier) — the engine scatters these
        payloads DIRECTLY into the requests' device slots
        (``DevicePoolPlane.restore_blocks_fused``)."""
        tr = self.tracer
        if tr.enabled:
            _ts = time.perf_counter()
        out: Dict[str, Tuple[Any, Any]] = {}
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
                              kv_by_req: Dict[str, Tuple[int, Any, Any]]
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
        The scatter into blocks still happens at each pool's ``flush``.
        With the default fp tier the host pool stays a byte-exact superset
        of device KV; under ``offload_quant="int8"`` it is a BOUNDED-ERROR
        superset (per-block per-head scales), whose ``load_blocks_fused``
        payloads are dequantized where they land in the device slots.
        Staged bytes are booked at wire size (see ``HostPool.stage``)."""
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

    def flush_fused(self, layer: int, req_ids) -> int:
        """Phase 2 of FlashD2H for the pools of ``req_ids`` after a save of
        `layer` (``save_new_tokens_fused``): in the int8 tier ONE
        ``quant_save_blocks`` call over every listed pool's staged stripes,
        on the GPU one kernel launch per round (one round unless two
        stripes of a pool touch one block); in the fp tier each pool's
        ``flush``.  Books ``d2h_blocks`` per pool exactly as ``flush``
        does; returns the blocks written."""
        tr = self.tracer
        if tr.enabled:
            _ts = time.perf_counter()
        pools = [self.pools[r] for r in req_ids if r in self.pools]
        if self.offload_quant != "int8":
            written = sum(p.flush() for p in pools)
        else:
            saves: List[ops.QuantSave] = []
            written = 0
            for p in pools:
                s, w = p.take_saves()
                saves += s
                written += w
            ops.quant_save_blocks(saves)
        if tr.enabled and written:
            tr.end("FlashD2H.flush", "transfer", _ts, layer=layer,
                   blocks=written, fused_reqs=len(pools))
        return written

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
