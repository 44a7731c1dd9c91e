"""Persistent shared device decode pool — the engine's decode data plane.

Counterpart of ``repro/core/device_pool.py``: the staged per-layer
pipeline (``step_staged``) and the persistent plane's one fused forward
(``step``), whose restores land after it.  One
padded paged pool per layer lives on the device for the lifetime of the
decode batch: a request is admitted once into a free batch row
(``admit``), nothing is copied per iteration while it decodes, and
``release`` frees the row for the next request (lowest row first, so a
replayed trace is deterministic).  Pool capacity follows
``BucketingPolicy`` buckets.  Requests scheduled this iteration are picked
with a step mask, so occupancy changes never change shapes.

The reference updates functional pool values through jitted stages; here
every write is IN PLACE on the plane's tensors: the select stage's append
and metadata update, the FlashH2D restores (``restore_blocks_fused``,
through the ``scatter_blocks_hkv`` kernel on the GPU) and the eviction
drops (``drop_blocks_many``: a whole round of them zeroed by one
``zero_blocks_hkv`` launch over the plane's table of K and V pools, where
the reference scatters a zero payload per request and layer).  An MLA
plane holds one latent pool per layer and no V pool.  The state's
``extra`` (Whisper's per-layer cross keys and values) is padded to
``b_cap`` rows like the pools, written at admission and handed to every
layer's attend; a plane holds requests whose ``extra`` shapes agree (the
engine keys its planes so).  A hybrid's Mamba layers hold their rows'
recurrent states ({"conv", "ssm"}, padded to ``b_cap`` rows) beside the
attention layers' pools, and RWKV6's layers theirs ({"shift_t",
"shift_c", "S"}; with no attention layer the plane holds no pool and no
pool table); a decode step runs such a layer as one stage
(``model.decode_recurrent_layer``: no select, no ``idx`` copy, no host
stage) and replaces its state.  Stage functions are plain calls of
``models/model.py``.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kv_cache import QuantBlocks
from repro_torch.device import host_to_device
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.obs.tracing import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class BucketingPolicy:
    """Shape-bucketing policy of the decode and prefill planes (a copy of
    the reference's).

    batch_buckets: allowed padded batch-row counts; demand beyond the last
        bucket doubles it (8 -> 16 -> 32 ...).
    block_bucket: pool block capacity is rounded UP to a multiple of this.
    token_bucket: prefill-plane token-length grid — windows round up to
        token_bucket, then DOUBLE (64, 128, 256, ...).
    """
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    block_bucket: int = 8
    token_bucket: int = 64

    def bucket_batch(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        b = self.batch_buckets[-1]
        while b < n:
            b *= 2
        return b

    def bucket_blocks(self, nb: int) -> int:
        bb = self.block_bucket
        return max(bb, -(-nb // bb) * bb)

    def bucket_tokens(self, n: int) -> int:
        t = self.token_bucket
        while t < n:
            t *= 2
        return t


def gather_row_blocks(pool: torch.Tensor, row: int, blocks
                      ) -> torch.Tensor:
    """Gather ``blocks`` of one batch row: (B,H,NB,bs,D) -> (H,K,bs,D),
    through the ``gather_blocks_hkv`` kernel on the GPU."""
    idx = host_to_device(blocks, pool.device)
    return ops.gather_blocks_hkv(pool[row], idx)


def scatter_row_blocks(pool: torch.Tensor, row: int, blocks,
                       payload: torch.Tensor) -> torch.Tensor:
    """Scatter ``payload`` (H,K,bs,D) into ``blocks`` (host-held ids) of
    one batch row IN PLACE (whole blocks, untouched blocks preserved),
    through the ``scatter_blocks_hkv`` kernel on the GPU.  Returns
    ``pool``."""
    ops.scatter_blocks_hkv(pool[row], payload, blocks)
    return pool


class DevicePoolPlane:
    """Persistent padded decode state for one group of batched requests.

    The plane OWNS its requests' decode state after ``admit``."""

    def __init__(self, cfg, policy: Optional[BucketingPolicy] = None):
        self.cfg = cfg
        self.policy = policy or BucketingPolicy()
        self.state: Optional[Dict] = None
        self.b_cap = 0
        self.nb_cap = 0
        self.rows: Dict[str, int] = {}            # req_id -> batch row
        self.cur_host: Dict[str, int] = {}        # host mirror of cur_len
        self._free: List[int] = []                # sorted free rows
        self.steps = 0
        self.blocks_dropped = 0
        self.blocks_restored = 0
        self.blocks_restored_before_use = 0
        self.host_syncs = 0              # per-layer selected-id syncs
        self.stage_launches = 0          # staged stage calls (embed, select,
                                         # attend, recurrent, logits), total
        self.d2h_readback_bytes = 0      # float32 stripe bytes gathered
                                         # for the write-back
        # last staged step's (layer, idx_sync_s, host_stage_s) per
        # stage_cb, and their sums over every step: the counter half of
        # the overlap cross-check (the spans reuse the same reads)
        self.stage_timeline: List[Tuple[int, float, float]] = []
        self.dispatch_sync_s = 0.0
        self.host_stage_s = 0.0
        self.tracer = NULL_TRACER        # the engine installs a live
                                         # Tracer when obs is on
        # K and V pools of every attention layer (the layer's K pool at
        # _pool_index[layer], its V pool after it; MLA's latent alone),
        # with their device address table: rebuilt where the pools are
        # made
        self.pool_table: Optional[ops.PoolTable] = None
        self._pool_index: Dict[int, int] = {}

    @property
    def device(self) -> torch.device:
        return self.state["cur_len"].device

    # -- capacity ----------------------------------------------------------

    def _alloc(self, template: Dict, b_cap: int, nb_cap: int) -> Dict:
        caches = []
        for c in template["caches"]:
            caches.append({
                key: v.new_zeros((b_cap,) + v.shape[1:2] + (nb_cap,)
                                 + v.shape[3:]) if M.is_pool_cache(c)
                else v.new_zeros((b_cap,) + v.shape[1:])
                for key, v in c.items()})
        dev = next(iter(template["caches"][0].values())).device
        self._table_pools(caches)
        return {"caches": caches,
                "cur_len": torch.zeros((b_cap,), dtype=torch.int32,
                                       device=dev),
                "extra": M.map_extra(
                    lambda x: x.new_zeros((b_cap,) + x.shape[1:]),
                    template["extra"])}

    @staticmethod
    def _kv_keys(cache: Dict) -> Tuple[str, ...]:
        """A layer cache's pools: K and V, or MLA's one latent pool."""
        return tuple(key for key in ("k", "v") if key in cache)

    def _table_pools(self, caches: List[Dict]) -> None:
        """The pool table over every attention layer's pools, and where
        each model layer's K pool sits in it (recurrent layers have
        none; a plane with no attention layer, RWKV's, has no table)."""
        pools = []
        self._pool_index = {}
        for l, c in enumerate(caches):
            if M.is_pool_cache(c):
                self._pool_index[l] = len(pools)
                pools.extend(c[key] for key in self._kv_keys(c))
        self.pool_table = ops.PoolTable(pools) if pools else None
        self._kvf = len(pools) // max(len(self._pool_index), 1)

    def _grow(self, b_cap: int, nb_cap: int) -> None:
        st = self.state
        for c in st["caches"]:
            pool = M.is_pool_cache(c)
            for key, v in c.items():
                if pool:
                    new = v.new_zeros((b_cap,) + v.shape[1:2] + (nb_cap,)
                                      + v.shape[3:])
                    new[:self.b_cap, :, :self.nb_cap] = v
                else:
                    new = v.new_zeros((b_cap,) + v.shape[1:])
                    new[:self.b_cap] = v
                c[key] = new
        self._table_pools(st["caches"])
        cl = st["cur_len"].new_zeros((b_cap,))
        cl[:self.b_cap] = st["cur_len"]
        st["cur_len"] = cl

        def pad_rows(x):
            new = x.new_zeros((b_cap,) + x.shape[1:])
            new[:self.b_cap] = x
            return new
        st["extra"] = M.map_extra(pad_rows, st["extra"])
        for r in range(self.b_cap, b_cap):
            bisect.insort(self._free, r)

    def _ensure_capacity(self, template: Dict, need_rows: int,
                         need_nb: int) -> None:
        b_cap = max(self.b_cap, self.policy.bucket_batch(need_rows))
        nb_cap = max(self.nb_cap, self.policy.bucket_blocks(need_nb))
        if self.state is None:
            self.state = self._alloc(template, b_cap, nb_cap)
            self._free = list(range(b_cap))
        elif b_cap != self.b_cap or nb_cap != self.nb_cap:
            self._grow(b_cap, nb_cap)
        self.b_cap, self.nb_cap = b_cap, nb_cap

    # -- slot lifecycle ----------------------------------------------------

    def admit(self, req_id: str, state: Dict) -> int:
        """Copy one request's DecodeState (B=1 list-mode pools;
        ``cur_len`` a host tensor) into a free batch row; returns the row.
        The only full-pool copy in a request's decode lifetime."""
        if req_id in self.rows:
            raise ValueError(f"{req_id} already admitted")
        if int(state["cur_len"].shape[0]) != 1:
            raise ValueError("admit expects a single-request state (B=1)")
        nbs = [c["k"].shape[2] if M.is_pool_cache(c) else None
               for c in state["caches"]]
        self._ensure_capacity(state, len(self.rows) + 1,
                              max((n for n in nbs if n is not None),
                                  default=0))
        row = self._free.pop(0)
        st = self.state
        for l, c in enumerate(state["caches"]):
            for key, v in c.items():
                if nbs[l] is None:           # a recurrent state
                    st["caches"][l][key][row] = v[0]
                else:
                    st["caches"][l][key][row, :, :nbs[l]] = v[0]
        for dst, src in zip(M.extra_leaves(st["extra"]),
                            M.extra_leaves(state["extra"])):
            dst[row] = src[0]
        cur = int(state["cur_len"][0])
        st["cur_len"][row] = cur
        self.rows[req_id] = row
        self.cur_host[req_id] = cur
        return row

    def release(self, req_id: str) -> int:
        """Free a finished request's row for reuse."""
        row = self.rows.pop(req_id)
        self.cur_host.pop(req_id)
        bisect.insort(self._free, row)
        return row

    def batch_inputs(self, token_by_req: Dict[str, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens (B_cap,) int32, step mask (B_cap,) bool) on the device:
        scheduled rows carry their input token, every other row is
        parked."""
        tokens = np.zeros((self.b_cap,), np.int32)
        mask = np.zeros((self.b_cap,), bool)
        for rid, tok in token_by_req.items():
            tokens[self.rows[rid]] = tok
            mask[self.rows[rid]] = True
        return (host_to_device(tokens, self.device),
                host_to_device(mask, self.device, torch.bool))

    # -- iteration ---------------------------------------------------------

    def step(self, params: Dict, token_by_req: Dict[str, int]
             ) -> Tuple[torch.Tensor, Dict, Dict[str, int]]:
        """ONE fused forward over the plane's padded rows (the persistent
        plane): ``model.decode_step`` with a step mask that parks the
        unscheduled rows.  Returns (logits (B_cap, V), info, {req_id:
        cur_len before the step}), the positions where this step's KV
        landed."""
        tokens, mask = self.batch_inputs(token_by_req)
        prev = {rid: self.cur_host[rid] for rid in token_by_req}
        logits, new_state, info = M.decode_step(
            params, self.cfg, tokens, self.state, return_info=True,
            step_mask=mask)
        self.state["cur_len"] = new_state["cur_len"]
        self.finish_step(token_by_req)
        return logits, info, prev

    def step_staged(self, params: Dict, token_by_req: Dict[str, int],
                    stage_cb=None) -> Tuple[torch.Tensor, Dict,
                                            Dict[str, int]]:
        """Staged per-layer pipeline over every layer: select ->
        ``stage_cb(layer, sel_np, prev_lens)`` on the host -> attend, so
        restores land before the attention that selected them.  The copy
        of the selected ids to the host is the one device sync per layer.
        Returns (logits (B_cap, V), info, {req_id: cur_len before})."""
        cfg = self.cfg
        tokens, mask = self.batch_inputs(token_by_req)
        st = self.state
        prev = {rid: self.cur_host[rid] for rid in token_by_req}
        enc_kvs = st["extra"].get("enc_kvs")
        info: Dict[str, Any] = {"selected": {}}
        timeline: List[Tuple[int, float, float]] = []
        tr = self.tracer
        x = M.decode_embed(params, cfg, tokens)
        self.stage_launches += 1
        for i in range(cfg.num_layers):
            p = M.get_layer(params, i)
            kind = M.layer_kind(cfg, i)
            self.stage_launches += 1 if kind != "attn" else 2
            if kind != "attn":
                x, st["caches"][i] = M.decode_recurrent_layer(
                    p, cfg, kind, x, st["caches"][i], mask)
                continue
            if tr.enabled:
                _ts = time.perf_counter()
            q, _, idx, valid = M.decode_select_layer(
                p, cfg, x, st["caches"][i], st["cur_len"], step_mask=mask)
            if tr.enabled:
                tr.end("select", "stage", _ts, layer=i)
            if idx is not None:
                info["selected"][i] = idx
            if stage_cb is not None:
                # the copy of the selected ids is the layer's one device
                # sync (it waits for select_i and the queued attend_{i-1});
                # its time and the host stage's are kept apart
                t0 = time.perf_counter()
                sel = None if idx is None else idx.cpu().numpy()
                t1 = time.perf_counter()
                if sel is not None:
                    self.host_syncs += 1
                stage_cb(i, sel, prev)
                t2 = time.perf_counter()
                timeline.append((i, t1 - t0, t2 - t1))
                if tr.enabled:
                    # the same t0/t1/t2 as the timeline: the trace and the
                    # dispatch_sync_s/host_stage_s counters are one
                    # measurement exported two ways
                    tr.complete_at("idx-sync", "stage", t0, t1 - t0,
                                   layer=i)
                    tr.complete_at("host-stage", "host-stage", t1,
                                   t2 - t1, layer=i)
            if tr.enabled:
                _ts = time.perf_counter()
            x = M.decode_attend_layer(p, cfg, x, q, st["caches"][i],
                                      st["cur_len"], idx, valid,
                                      M.index_enc_kvs(enc_kvs, i))
            if tr.enabled:
                tr.end("attend", "stage", _ts, layer=i)
        logits, st["cur_len"] = M.decode_logits(params, cfg, x,
                                                st["cur_len"], mask)
        self.stage_launches += 1
        self.stage_timeline = timeline
        for _, sync_s, stage_s in timeline:
            self.dispatch_sync_s += sync_s
            self.host_stage_s += stage_s
        self.finish_step(token_by_req)
        return logits, info, prev

    def finish_step(self, token_by_req: Dict[str, int]) -> None:
        self.steps += 1
        for rid in token_by_req:
            self.cur_host[rid] += 1

    # -- data plane: FlashH2D/D2H wiring ----------------------------------

    def new_token_kv(self, req_ids: List[str], prev_lens: Dict[str, int],
                     layers: List[int], ship) -> Dict[int, Tuple]:
        """``new_token_kv_async`` waited for: {model_layer: (k, v)}, each
        (R, Hkv, D) float32 where ``ship`` put it (v None for MLA)."""
        return {l: tuple(pending.wait()) for l, pending in
                self.new_token_kv_async(req_ids, prev_lens, layers,
                                        ship).items()}

    def new_token_kv_async(self, req_ids: List[str],
                           prev_lens: Dict[str, int], layers: List[int],
                           ship) -> Dict[int, Any]:
        """Launch the gathers of the KV stripe this iteration appended and
        hand each layer's to ``ship`` (``KVCacheManager.ship``) WITHOUT a
        host sync: {model_layer: pending}, whose ``wait()`` gives (k
        (R,Hkv,D), v (R,Hkv,D) or None for MLA) float32, rows ordered like
        ``req_ids``.
        The gather makes a new tensor right after the layer's select, so
        later in-place pool writes (restores, drops, the next select)
        cannot reach the stripe."""
        bs = self.cfg.dsa.block_size
        dev = self.device
        pos = np.asarray([prev_lens[r] for r in req_ids], np.int64)
        rows = host_to_device([self.rows[r] for r in req_ids], dev,
                              torch.int64)
        blk = host_to_device(pos // bs, dev, torch.int64)
        slot = host_to_device(pos % bs, dev, torch.int64)
        out: Dict[int, Any] = {}
        for l in layers:
            c = self.state["caches"][l]
            k = c["k"][rows, :, blk, slot].float()          # (R, Hkv, D)
            v = c["v"][rows, :, blk, slot].float() if "v" in c else None
            out[l] = ship(k, v)
            self.d2h_readback_bytes += k.nbytes + (
                0 if v is None else v.nbytes)
        return out

    def restore_blocks_fused(self, layer: int,
                             payload_by_req: Dict[str, Tuple[List[int],
                                                             Any, Any]],
                             before_use: bool = False) -> None:
        """Land one layer's fused FlashH2D payloads for the WHOLE batch
        with one launch per tensor, IN PLACE.  payload_by_req: {req_id:
        (blocks, k, v)} with k/v float32 (Hkv,K,bs,D) blocks (v None for
        MLA), cast to the pool dtype by ``scatter_blocks_hkv``, or the int8
        tier's
        ``QuantBlocks`` (int8 payload and (Hkv,K) scales, both on the
        device), dequantized into the pool by ``dequantize_scatter_blocks``.
        before_use: the restore lands between the layer's select and
        attend stages."""
        c = self.state["caches"][layer]
        rows_l: List[int] = []
        blks_l: List[int] = []
        keys = self._kv_keys(c)
        pays: Dict[str, List[Any]] = {key: [] for key in keys}
        for req_id, (blocks, k_pay, v_pay) in payload_by_req.items():
            rows_l.extend([self.rows[req_id]] * len(blocks))
            blks_l.extend(blocks)
            for key, pay in zip(keys, (k_pay, v_pay)):
                pays[key].append(pay)
        if not blks_l:
            return
        if isinstance(pays["k"][0], QuantBlocks):
            dev = self.device
            rows = host_to_device(rows_l, dev)
            blks = host_to_device(blks_l, dev)
            for key, ps in pays.items():
                ops.dequantize_scatter_blocks(
                    c[key], torch.cat([p.q for p in ps], dim=1),
                    torch.cat([p.scales for p in ps], dim=1), blks, rows)
        else:
            # host-held ids: checked, then uploaded with the launch
            for key, ps in pays.items():
                ops.scatter_blocks_hkv(c[key], torch.cat(ps, dim=1), blks_l,
                                       rows_l)
        self.blocks_restored += len(blks_l)
        if before_use:
            self.blocks_restored_before_use += len(blks_l)

    def drop_blocks(self, req_id: str, layer: int,
                    blocks: List[int]) -> None:
        """Zero evicted blocks' device data IN PLACE (HBM eviction really
        drops device data): the one-(request, layer) case of
        ``drop_blocks_many``."""
        self.drop_blocks_many({(req_id, layer): blocks})

    def drop_blocks_many(self, blocks_by: Dict[Tuple[str, int], List[int]]
                         ) -> None:
        """Zero a whole eviction round IN PLACE, {(req_id, layer): blocks}:
        K and V (MLA: the latent) of every listed block, in one
        ``zero_blocks_hkv`` launch
        with one upload of its (pool, row, block) items on the GPU.  Block
        METADATA stays, so DSA scoring is exact; re-selected blocks come
        back through ``restore_blocks_fused``.  ``blocks_dropped`` grows by
        the blocks listed, as one ``drop_blocks`` call per key would."""
        if not blocks_by:
            return
        blks = np.concatenate([np.asarray(b, np.int64)
                               for b in blocks_by.values()])
        n = np.fromiter(map(len, blocks_by.values()), np.int64,
                        len(blocks_by))
        self.blocks_dropped += int(blks.size)
        if not blks.size:
            return
        kvf = self._kvf
        k_pool = np.repeat(np.fromiter((self._pool_index[l]
                                        for _, l in blocks_by),
                                       np.int64, len(blocks_by)), n)
        row = np.repeat(np.fromiter((self.rows[r] for r, _ in blocks_by),
                                    np.int64, len(blocks_by)), n)
        # every block in its layer's K pool, then in its V pool
        ops.zero_blocks_hkv(self.pool_table,
                            np.concatenate([k_pool + j for j in range(kvf)]),
                            np.concatenate([row] * kvf),
                            np.concatenate([blks] * kvf))
