"""Real-execution serving engine of the port: continuous batching with
dynamic sparse attention decode over a hierarchical HBM/DRAM KV cache.

Counterpart of ``repro/serving/engine.py`` for its default configuration:
every iteration is ONE mixed layer walk (``core.hybrid_plane``) carrying
the staged decode plane's rows (select -> host stage -> attend per layer)
and the batched layer-segmented prefill plane's segments, with one host
stage per attention layer:

1. one merged fused FlashD2H save of the layer's new KV (decode write-back
   plus fresh prefill chunks) — on the ``HostStageWorker`` thread when
   ``stage_dispatch="async"`` (the default), inline when ``"sync"`` (the
   equivalence oracle; async must give byte-identical greedy tokens);
2. the LRU round for every decode row's DSA selection, then at most ONE
   fused FlashH2D load of the misses (the ``gather_blocks_hkv`` kernel
   reading the pinned host pools) scattered into the device slots
   (``scatter_blocks_hkv``) BEFORE the attention that selected them;
3. the one-stage-deferred physical drop of LRU-evicted blocks;
4. the end-of-layer decode-pool builds of prefill rows and their HBM
   layer eviction (the one-layer prefill bound).

Iteration latency is charged from the copied analytic cost model unless
``charge_real_time`` is set (the GPU launcher sets it, and then TTFT/TBT
are the card's wall clock).  Configurations the port does not implement
yet raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dsa as dsa_mod
from repro_torch.core.device_pool import BucketingPolicy, DevicePoolPlane
from repro_torch.core.host_stage import HostStageWorker
from repro_torch.core.hybrid_plane import (DecodeJob, HybridPlane,
                                           LayerWindow, PrefillJob)
from repro_torch.core.kv_cache import KVCacheManager, KVGeometry, TransferStats
from repro_torch.core.layer_prefill import hbm_footprint_tokens, plan_segments
from repro_torch.core.prefill_plane import PrefillPlane, admit_embed
from repro_torch.core.scheduler import BatchPlan, Scheduler, SchedulerConfig
from repro_torch.device import host_to_device
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig
from repro_torch.serving import costmodel as cm
from repro_torch.serving.metrics import ServingMetrics, compute_metrics
from repro_torch.serving.request import Phase, Request


@dataclasses.dataclass
class EngineConfig:
    """The reference's ``EngineConfig`` fields and defaults, less the
    ``attn_impl`` knob (the device of the tensors decides).  Values of the
    reference that the port does not implement yet raise
    ``NotImplementedError`` in ``ServingEngine``: prefill_mode "chunked",
    prefill_exec "legacy", decode_plane "persistent"/"stacked",
    hybrid_plane "split", batched_decode False, offload_quant "int8", a
    mesh_spec, and obs True."""
    prefill_mode: str = "layer_segmented"
    prefill_exec: str = "plane"
    prefill_max_tokens_per_step: int = 0     # intra-layer chunk size of the
                                             # prefill plane (0 = whole
                                             # layers)
    chunk_size: int = 2048
    max_inject_tokens: int = 0               # 0 -> chunk_size * L
    r_max: int = 8
    t_max: int = 8192
    ws_control: bool = True
    hbm_budget_bytes: int = 1 << 30          # HBM KV-cache budget (M_avl)
    hbm_blocks_per_request: int = 96         # per-request LRU capacity
    charge_real_time: bool = False
    greedy: bool = True
    seed: int = 0
    batched_decode: bool = True
    decode_plane: str = "staged"
    bucketing: BucketingPolicy = dataclasses.field(
        default_factory=BucketingPolicy)
    decode_write_back: bool = True           # FlashD2H of decode KV
    mesh_spec: Any = None
    hybrid_plane: str = "mixed"
    stage_dispatch: str = "async"            # "async" | "sync" (oracle)
    drop_evicted_device_blocks: Optional[bool] = None   # None -> on
    offload_quant: str = "none"
    obs: Optional[bool] = None               # None -> off


_KNOWN = {
    "prefill_mode": (("layer_segmented",), ("chunked",)),
    "prefill_exec": (("plane",), ("legacy",)),
    "decode_plane": (("staged",), ("persistent", "stacked")),
    "hybrid_plane": (("mixed",), ("split",)),
    "stage_dispatch": (("async", "sync"), ()),
    "offload_quant": (("none",), ("int8",)),
}


def _validate(eng: EngineConfig) -> None:
    for field, (ported, later) in _KNOWN.items():
        val = getattr(eng, field)
        if val in later:
            raise NotImplementedError(
                f"EngineConfig.{field}={val!r} is not ported yet")
        if val not in ported:
            raise ValueError(f"unknown {field} {val!r}; expected one of "
                             f"{ported + later}")
    if not eng.batched_decode:
        raise NotImplementedError("batched_decode=False is not ported yet")
    if eng.mesh_spec is not None:
        raise NotImplementedError("plane meshes are not ported yet")
    if eng.obs:
        raise NotImplementedError("the obs layer is not wired in yet")


@dataclasses.dataclass
class _ReqState:
    """Engine-side state for one request."""
    req: Request
    tokens: np.ndarray                              # prompt token ids
    decode_state: Optional[Dict] = None             # B=1 pools until the
                                                    # decode plane owns them
    prefill_carry: int = 0                          # unspent token budget
    last_logits: Optional[torch.Tensor] = None      # (1, V) on the host
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    num_blocks: int = 0


class ServingEngine:
    """Continuous-batching engine over real model forwards.  Runs on the
    device of ``params``."""

    def __init__(self, params: Dict, cfg: ModelConfig, eng: EngineConfig,
                 hw: cm.HardwareSpec = cm.TPU_V5E):
        M.check_supported(cfg)
        _validate(eng)
        self.params = params
        self.cfg = cfg
        self.hw = hw                 # the modelled clock's preset
        self.device = params["embed"].device
        self.kv_dtype = params["embed"].dtype
        if eng.drop_evicted_device_blocks is None:
            # resolved into a COPY: the caller's config stays as given
            eng = dataclasses.replace(
                eng, drop_evicted_device_blocks=eng.decode_write_back)
        if eng.drop_evicted_device_blocks and not eng.decode_write_back:
            raise ValueError(
                "drop_evicted_device_blocks requires decode_write_back: "
                "restores come from the host pool, which is only a superset "
                "of device KV when decode write-back is on")
        self.eng = eng
        self.mc = cm.ModelCost.from_config(cfg)
        self.rng = np.random.default_rng(eng.seed)
        self.geom = KVGeometry(
            num_layers=cfg.num_attention_layers(),
            num_kv_heads=cfg.num_kv_heads, block_size=cfg.dsa.block_size,
            head_dim=cfg.kv_cache_dim, kv_factor=2)
        inject = (eng.max_inject_tokens if eng.max_inject_tokens > 0
                  else eng.chunk_size * cfg.num_layers)
        self.scheduler = Scheduler(
            SchedulerConfig(
                r_max=eng.r_max, t_max=eng.t_max,
                m_avl_bytes=eng.hbm_budget_bytes if eng.ws_control else 0,
                prefill_mode=eng.prefill_mode, chunk_size=eng.chunk_size,
                max_inject_tokens=inject,
                segment_tokens=eng.prefill_max_tokens_per_step,
                ws_control=eng.ws_control),
            self.geom, cfg.num_layers, cfg.dsa.top_k_blocks)
        self.kv_mgr = KVCacheManager(self.geom, eng.hbm_budget_bytes,
                                     offload_quant=eng.offload_quant,
                                     device=self.device)
        # wire bytes the cost model charges per moved (layer, block)
        self._offload_block_bytes = cm.offload_block_bytes(
            self.geom.num_kv_heads, self.geom.head_dim,
            self.geom.block_size, kv_factor=self.geom.kv_factor,
            dtype_bytes=self.geom.dtype_bytes, quant=eng.offload_quant)
        self.states: Dict[str, _ReqState] = {}
        self._pending: List[Request] = []      # not yet arrived
        self.now = 0.0
        self.iterations = 0
        self.prefill_hbm_peak_tokens = 0
        self.decode_step_calls = 0
        self.decode_tokens = 0
        self.prefill_launches = 0
        self.admit_embed_launches = 0
        self.plane = DevicePoolPlane(cfg, eng.bucketing)
        self.prefill_plane = PrefillPlane(cfg, eng.bucketing)
        self.hybrid = HybridPlane(cfg)
        self._stage_async = eng.stage_dispatch == "async"
        self._worker: Optional[HostStageWorker] = None
        self.worker_jobs_run = 0
        self.worker_busy_s = 0.0
        self._staged_layer_bytes: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------
    def submit(self, req: Request, tokens: Optional[np.ndarray] = None
               ) -> None:
        """Register a request (it joins the scheduler queue at
        ``req.arrival_time``, engine-clock seconds).  ``tokens``: prompt
        ids of length ``req.prompt_len`` (drawn at random when omitted).
        The host pool is sized for ``prompt_len + max_new_tokens``."""
        if tokens is None:
            tokens = self.rng.integers(
                4, self.cfg.vocab_size, size=req.prompt_len).astype(np.int32)
        if len(tokens) != req.prompt_len:
            raise ValueError(f"{req.req_id}: {len(tokens)} tokens for "
                             f"prompt_len {req.prompt_len}")
        st = _ReqState(req=req, tokens=np.asarray(tokens, np.int32))
        total = req.prompt_len + req.max_new_tokens
        st.num_blocks = -(-total // self.cfg.dsa.block_size) + 1
        self.states[req.req_id] = st
        self._pending.append(req)
        self._pending.sort(key=lambda r: r.arrival_time)
        self.kv_mgr.register(req.req_id, total,
                             self.eng.hbm_blocks_per_request)
        if self.eng.drop_evicted_device_blocks:
            self.kv_mgr.caches[req.req_id].track_evictions = True

    def _admit_arrivals(self) -> None:
        while self._pending and self._pending[0].arrival_time <= self.now:
            self.scheduler.add_request(self._pending.pop(0))

    # ------------------------------------------------------------------
    # Prefill admission
    # ------------------------------------------------------------------
    def _kv_to_layer_cache(self, st: _ReqState, kv_out: Tuple) -> Dict:
        k, v = kv_out
        kpool, meta = M._kv_to_pool(self.cfg, k, st.num_blocks,
                                    self.kv_dtype)
        vpool, _ = M._kv_to_pool(self.cfg, v, st.num_blocks, self.kv_dtype)
        return {"k": kpool, "v": vpool, "meta": meta}

    def _batched_admit_embed(self, sts: List[_ReqState]
                             ) -> Dict[str, torch.Tensor]:
        """{req_id: h (1, S, d)} for an admission batch, embedded in ONE
        bucketed launch."""
        if not sts:
            return {}
        pol = self.eng.bucketing
        n_cap = pol.bucket_batch(len(sts))
        s_cap = pol.bucket_tokens(max(len(st.tokens) for st in sts))
        toks = np.zeros((n_cap, s_cap), np.int32)
        for i, st in enumerate(sts):
            toks[i, :len(st.tokens)] = st.tokens
        h_all = admit_embed(self.params, host_to_device(toks, self.device))
        self.admit_embed_launches += 1
        return {st.req.req_id: h_all[i:i + 1, :len(st.tokens)]
                for i, st in enumerate(sts)}

    def _admit_prefill_plane(self, st: _ReqState, h: torch.Tensor) -> None:
        """Plan the request's (layer, chunk) segments and admit it into a
        prefill plane row."""
        S = int(h.shape[1])
        step = self.eng.prefill_max_tokens_per_step or S
        segs = plan_segments(S, self.cfg.num_layers, step)
        self.prefill_plane.admit(st.req.req_id, h, segs)
        st.decode_state = {"caches": [None] * self.cfg.num_layers,
                           "cur_len": None, "extra": {}}

    # ------------------------------------------------------------------
    # Mixed iteration (hybrid plane)
    # ------------------------------------------------------------------
    def _mixed_iteration(self, plan: BatchPlan
                         ) -> Tuple[List[Request], int, List[float]]:
        """One MIXED iteration: the decode plane's staged pipeline and the
        prefill plane's (layer, chunk) groups ride ONE layer walk
        (``HybridPlane.run_iteration``) with one host stage per layer
        (``layer_cb`` below; see the module docstring for its four steps).

        Returns (finished prefill requests, iteration HBM footprint in
        token-layer units, per-layer modelled prefill seconds)."""
        L = self.cfg.num_layers
        done: List[Request] = []
        fp = 0
        drop = self.eng.drop_evicted_device_blocks
        prefill_by_layer = [0.0] * L
        spent: Dict[str, int] = {}
        pplane = self.prefill_plane

        # prefill job: admit new rows (one batched embed), grant budgets
        pre_h = self._batched_admit_embed(
            [self.states[req.req_id] for req, _ in plan.prefill_reqs
             if req.req_id not in pplane.rows])
        allow: Dict[str, int] = {}
        for req, inject in plan.prefill_reqs:
            st = self.states[req.req_id]
            if req.scheduled_time is None:
                req.scheduled_time = self.now
            if req.req_id not in pplane.rows:
                self._admit_prefill_plane(st, pre_h[req.req_id])
            st.prefill_carry += max(int(inject), 1)
            allow[req.req_id] = st.prefill_carry
        prefill_jobs = [PrefillJob(pplane, allow)] if allow else []

        # decode job: the plane admits new rows and takes their state
        decode_sts = [self.states[req.req_id] for req in plan.decode_reqs]
        decode_jobs: List[DecodeJob] = []
        pending_evict: Dict[str, set] = {}
        sel_pairs: Dict[str, List[Tuple[int, int]]] = {}
        if decode_sts:
            decode_jobs.append(DecodeJob(self._plane_for(decode_sts), {
                st.req.req_id: st.out_tokens[-1] for st in decode_sts}))
            pending_evict = {st.req.req_id: set() for st in decode_sts}
            sel_pairs = {st.req.req_id: [] for st in decode_sts}

        worker = self._stage_worker() if self._stage_async else None

        def layer_cb(win: LayerWindow) -> None:
            # every layer of a dense decoder is an attention layer, so the
            # KV manager's attention-layer ordinal is the model layer
            lidx = win.layer
            for _, g in win.groups:
                prefill_by_layer[win.layer] += cm.batched_prefill_time(
                    self.hw, self.mc,
                    [(g.segs[rid].chunk_len,
                      g.chunk_start + g.segs[rid].chunk_len)
                     for rid in g.req_ids], layers=1)
                self.prefill_launches += 1
                for rid in g.req_ids:
                    spent[rid] = spent.get(rid, 0) + g.segs[rid].chunk_len
            # 1. ONE merged fused FlashD2H: decode write-back + fresh
            #    prefill-chunk KV of this layer; its copies to pinned host
            #    memory are launched here, the save runs on the worker
            parts = []
            if self.eng.decode_write_back:
                for d, _ in win.selections:
                    parts.append((list(d.req_ids), dict(d.prev),
                                  d.plane.new_token_kv_async(
                                      d.req_ids, d.prev,
                                      layers=[win.layer])[win.layer]))
            finishers = [(g.chunk_start, pp.read_group_kv_async(g))
                         for pp, g in win.groups]
            if parts or finishers:
                if worker is not None:
                    worker.submit(lidx, self._stage_writeback_merged, lidx,
                                  parts, finishers)
                else:
                    self._stage_writeback_merged(lidx, parts, finishers)
            # 2. LRU round, then at most ONE merged FlashH2D, restored into
            #    the decode slots before the attention that selected them
            rounds, merged_missing = self._account_selections(
                lidx, win.selections, pending_evict, sel_pairs)
            if merged_missing:
                n_missing = sum(len(m) for m in merged_missing.values())
                self._staged_layer_bytes[win.layer] = (
                    self._staged_layer_bytes.get(win.layer, 0)
                    + n_missing * self._offload_block_bytes)
                if worker is not None:
                    # restore-before-use fence: this layer's write-back
                    # must be in DRAM before gathering from it
                    worker.fence(lidx)
                payloads = self.kv_mgr.load_blocks_fused(lidx,
                                                         merged_missing)
                if self.eng.decode_write_back:
                    for d, _, missing_by_req in rounds:
                        if missing_by_req:
                            d.plane.restore_blocks_fused(
                                win.layer,
                                {rid: (missing_by_req[rid], k, v)
                                 for rid, (k, v) in payloads.items()
                                 if rid in missing_by_req},
                                before_use=True)
            # 3. deferred eviction drop (blocks the imminent attend
            #    selected stay until the next stage boundary)
            if drop:
                for d, blocks_by_req, _ in rounds:
                    self._drop_pending_evictions(
                        d.plane, d.req_ids, pending_evict,
                        protect=(lidx, blocks_by_req))
            # 4. prefill end-of-layer: decode pool builds + HBM layer evict
            for pp, g in win.groups:
                for rid in g.req_ids:
                    if not g.segs[rid].is_last_chunk_of_layer:
                        continue
                    st_r = self.states[rid]
                    st_r.decode_state["caches"][g.layer] = \
                        self._kv_to_layer_cache(st_r, pp.layer_ctx(rid))
                    cache = self.kv_mgr.caches.get(rid)
                    if cache is not None:
                        cache.drop_layer(lidx)

        res = self.hybrid.run_iteration(self.params, decode_jobs,
                                        prefill_jobs, layer_cb)
        if worker is not None:
            # iteration fence: every merged write-back has landed before
            # sampling or a release can drop a DRAM pool
            worker.drain()

        # decode epilogue
        for (dplane, logits, _info, _prev) in res.decode:
            self.decode_step_calls += 1
            self.decode_tokens += len(decode_sts)
            if drop:
                self._drop_pending_evictions(
                    dplane, [st.req.req_id for st in decode_sts],
                    pending_evict)
            host_logits = logits.float().cpu()
            for st in decode_sts:
                row = dplane.rows[st.req.req_id]
                st.last_logits = host_logits[row:row + 1]
                st.out_tokens.append(self._sample(st))
                if sel_pairs[st.req.req_id]:
                    self.scheduler.observe_selection(
                        st.req, sel_pairs[st.req.req_id])

        # prefill epilogue
        for pp, pres in res.prefill:
            for rid in allow:
                st_r = self.states[rid]
                st_r.prefill_carry = max(
                    0, st_r.prefill_carry - spent.get(rid, 0))
                req = st_r.req
                if not pp.done(rid):
                    seg = pp.segments[rid][pp.next_idx[rid]]
                    req.prefill_layer = seg.layer
                    req.prefill_layer_tokens_done = min(
                        seg.chunk_start, max(req.prompt_len - 1, 0))
            for rid, peak in pres.peaks.items():
                fp += hbm_footprint_tokens(
                    pp.tok_len[rid], "layer_segmented", L,
                    layer_tokens_resident=peak)
            host_logits = (pres.logits.float().cpu() if pres.finished
                           else None)
            for rid in pres.finished:
                st_r = self.states[rid]
                row = pp.rows[rid]
                st_r.last_logits = host_logits[row:row + 1]
                st_r.decode_state["cur_len"] = torch.full(
                    (1,), pp.tok_len[rid], dtype=torch.int32)
                st_r.req.prefill_layer = L
                st_r.req.prefill_layer_tokens_done = 0
                pp.release(rid)
                done.append(st_r.req)
        if not allow:
            # rows parked mid-layer still hold their chunk residency
            for rid, resident in pplane.resident_tokens().items():
                fp += hbm_footprint_tokens(
                    pplane.tok_len[rid], "layer_segmented", L,
                    layer_tokens_resident=resident)
        return done, fp, prefill_by_layer

    def _stage_writeback_merged(self, lidx: int, parts: List[Tuple],
                                finishers: List[Tuple]) -> None:
        """ONE fused FlashD2H save for layer ``lidx``: every decode
        plane's appended stripe (``parts``: (req_ids, prev, HostCopy))
        merged with every prefill group's fresh chunk (``finishers``:
        (chunk_start, finish)) in a single ``save_new_tokens_fused`` call,
        then the pools' CPU-side flush.  Runs on the host stage worker in
        async mode (it waits on the copies' CUDA events), inline in sync
        mode."""
        kv_merge: Dict[str, Tuple[int, Any, Any]] = {}
        for req_ids, prev, pending in parts:
            k, v = pending.wait()
            for i, rid in enumerate(req_ids):
                kv_merge[rid] = (prev[rid], k[i][:, None, :],
                                 v[i][:, None, :])
        for chunk_start, finish in finishers:
            for rid, (k, v) in finish().items():
                cur = kv_merge.get(rid)
                if cur is None:
                    kv_merge[rid] = (chunk_start, k, v)
                else:
                    # same-rid chunks of one layer are contiguous in plan
                    # order: extend the stripe along tokens
                    s0, k0, v0 = cur
                    kv_merge[rid] = (s0, np.concatenate([k0, k], axis=1),
                                     np.concatenate([v0, v], axis=1))
        if kv_merge:
            self.kv_mgr.save_new_tokens_fused(lidx, kv_merge)
            for rid in kv_merge:
                pool = self.kv_mgr.pools.get(rid)
                if pool is not None:
                    pool.flush()

    # ------------------------------------------------------------------
    # Decode bookkeeping
    # ------------------------------------------------------------------
    def _plane_for(self, sts: List[_ReqState]) -> DevicePoolPlane:
        """Admit any of ``sts`` not yet resident into the decode plane — the
        only full-pool copy in a request's decode lifetime; the plane owns
        the state afterwards.  (Dense models need one plane: the reference
        groups planes by encoder-KV shapes, which they do not have.)"""
        for st in sts:
            if st.req.req_id not in self.plane.rows:
                self.plane.admit(st.req.req_id, st.decode_state)
                st.decode_state = None
        return self.plane

    def _sample(self, st: _ReqState) -> int:
        logits = st.last_logits.numpy()[0]
        if self.eng.greedy:
            return int(np.argmax(logits))
        z = logits - logits.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self.rng.choice(len(p), p=p))

    def _account_selections(self, lidx: int, selections: List[Tuple],
                            pending_evict: Dict[str, set],
                            sel_pairs: Dict[str, List[Tuple[int, int]]]):
        """One layer's DSA selections -> LRU residency and the working-set
        history.  Returns (rounds [(decode run, blocks_by_req,
        missing_by_req)], the misses of every plane merged by request)."""
        merged_missing: Dict[str, List[int]] = {}
        rounds = []
        for d, sel in selections:
            if sel is None:
                continue
            blocks_by_req: Dict[str, List[int]] = {}
            for rid in d.req_ids:
                blocks = dsa_mod.selected_block_ids(sel[d.plane.rows[rid]])
                blocks_by_req[rid] = blocks
                sel_pairs[rid].extend((lidx, x) for x in blocks)
            missing_by_req, evicted_by_req = self.kv_mgr.access_layer(
                lidx, blocks_by_req,
                drain_evicted=self.eng.drop_evicted_device_blocks)
            for rid, ev in evicted_by_req.items():
                pending_evict[rid].update(ev)
            merged_missing.update(missing_by_req)
            rounds.append((d, blocks_by_req, missing_by_req))
        return rounds, merged_missing

    def _drop_pending_evictions(self, plane: DevicePoolPlane,
                                req_ids: List[str],
                                pending: Dict[str, set],
                                protect: Optional[Tuple[int, Dict[str, List[int]]]] = None
                                ) -> None:
        """Physically zero LRU-evicted blocks on the device, mutating
        ``pending`` ((layer, block) keys per request) in place.  A key is
        skipped when the block is LRU-resident again, or kept pending when
        ``protect`` = (lidx, blocks_by_req) marks it as selected by the
        attention about to run."""
        for rid in req_ids:
            cache = self.kv_mgr.caches.get(rid)
            if cache is None:
                pending[rid].clear()
                continue
            keep: set = set()
            by_layer: Dict[int, List[int]] = {}
            for elidx, blk in pending[rid]:
                if cache.resident(elidx, blk):
                    continue
                if (protect is not None and elidx == protect[0]
                        and blk in protect[1].get(rid, ())):
                    keep.add((elidx, blk))
                    continue
                by_layer.setdefault(elidx, []).append(blk)
            for elidx, blks in by_layer.items():
                plane.drop_blocks(rid, elidx, sorted(set(blks)))
            pending[rid] = keep

    # ------------------------------------------------------------------
    # Async host stage
    # ------------------------------------------------------------------
    def _stage_worker(self) -> HostStageWorker:
        """The engine's host-stage worker, created lazily (and again after
        ``close()``)."""
        if self._worker is None or self._worker.closed:
            self._worker = HostStageWorker(name=f"host-stage-{id(self):x}")
        return self._worker

    def close(self) -> None:
        """Drain and join the host-stage worker (re-raising job errors);
        idempotent, and ``run()`` calls it on exit."""
        if self._worker is not None:
            self._worker.close()
            self.worker_jobs_run += self._worker.jobs_run
            self.worker_busy_s += self._worker.busy_s
            self._worker = None

    # ------------------------------------------------------------------
    # Iteration
    # ------------------------------------------------------------------
    def step(self) -> Optional[BatchPlan]:
        """Run ONE engine iteration.  Returns the executed plan, or None
        when no work remains.  Order: admit arrivals -> schedule
        (Algorithm 1) -> mixed layer walk (prefill segments + staged
        decode) -> sample -> finish/release -> charge time."""
        self._admit_arrivals()
        plan = self.scheduler.schedule()
        if not plan.decode_reqs and not plan.prefill_reqs:
            if self._pending:      # idle until the next arrival
                self.now = max(self.now, self._pending[0].arrival_time)
                return self.step()
            return None
        t0 = time.perf_counter()
        self._staged_layer_bytes = {}
        prefill_done, iter_prefill_fp, prefill_by_layer = \
            self._mixed_iteration(plan)
        self.prefill_hbm_peak_tokens = max(self.prefill_hbm_peak_tokens,
                                           iter_prefill_fp)
        for req in prefill_done:
            st = self.states[req.req_id]
            req.phase = Phase.DECODE
            req.prefill_tokens_done = req.prompt_len
            st.out_tokens.append(self._sample(st))       # the first token
            req.generated = 1
            req.first_token_time = self.now   # stamped below
            req.token_times.append(self.now)
        for req in plan.decode_reqs:
            req.generated += 1
            req.token_times.append(self.now)
            if req.generated >= req.max_new_tokens:
                req.finish_time = self.now
                self.scheduler.finish_request(req)
                self.kv_mgr.release(req.req_id)
                if req.req_id in self.plane.rows:
                    self.plane.release(req.req_id)

        if self.eng.charge_real_time:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_iter = time.perf_counter() - t0
        else:
            attended = (min(self.cfg.dsa.token_budget, 1 << 30)
                        if self.cfg.dsa.enabled else 4096)
            t_iter = cm.mixed_iteration_time(
                self.hw, self.mc, len(plan.decode_reqs), attended,
                [self._staged_layer_bytes.get(l, 0)
                 for l in range(self.cfg.num_layers)],
                prefill_time_by_layer=prefill_by_layer)
        self.now += max(t_iter, 1e-9)
        # stamp the times produced "at end of iteration"
        for req in plan.decode_reqs + [r for r, _ in plan.prefill_reqs]:
            if req.token_times and req.token_times[-1] != self.now:
                req.token_times[-1] = self.now
            if req.first_token_time is not None and req.generated == 1:
                req.first_token_time = self.now
            if req.finish_time is not None and req.phase == Phase.FINISHED:
                req.finish_time = self.now
        self.iterations += 1
        return plan

    def run(self, max_iters: int = 10_000) -> ServingMetrics:
        """Step until every submitted request finished (or ``max_iters``),
        then return aggregate metrics (TTFT/TBT in engine-clock seconds)."""
        try:
            for _ in range(max_iters):
                if self.step() is None:
                    break
        finally:
            self.close()
        return compute_metrics([st.req for st in self.states.values()],
                               max(self.now, 1e-9))

    # ------------------------------------------------------------------
    def transfer_stats(self) -> TransferStats:
        return self.kv_mgr.total_stats()

    def metrics_snapshot(self) -> Dict[str, float]:
        """One flat dict of the engine's counters (the reference's names
        for the ones the port keeps)."""
        ts = self.kv_mgr.total_stats()
        w = self._worker
        live = w is not None and not w.closed
        p = self.plane
        return {
            "kv.h2d_calls": float(ts.h2d_calls),
            "kv.h2d_blocks": float(ts.h2d_blocks),
            "kv.h2d_bytes": float(ts.h2d_bytes),
            "kv.d2h_calls": float(ts.d2h_calls),
            "kv.d2h_blocks": float(ts.d2h_blocks),
            "kv.d2h_bytes": float(ts.d2h_bytes),
            "kv.hits": float(ts.hits),
            "kv.misses": float(ts.misses),
            "kv.evictions": float(ts.evictions),
            "kv.hbm_used_bytes": float(self.kv_mgr.hbm_used_bytes()),
            "kv.offload_block_bytes": float(self._offload_block_bytes),
            "engine.iterations": float(self.iterations),
            "engine.now_s": float(self.now),
            "engine.decode_step_calls": float(self.decode_step_calls),
            "engine.decode_tokens": float(self.decode_tokens),
            "engine.prefill_launches": float(self.prefill_launches),
            "engine.admit_embed_launches": float(self.admit_embed_launches),
            "engine.prefill_hbm_peak_tokens":
                float(self.prefill_hbm_peak_tokens),
            "plane.steps": float(p.steps),
            "plane.host_syncs": float(p.host_syncs),
            "plane.d2h_readback_bytes": float(p.d2h_readback_bytes),
            "plane.blocks_dropped": float(p.blocks_dropped),
            "plane.blocks_restored": float(p.blocks_restored),
            "plane.blocks_restored_before_use":
                float(p.blocks_restored_before_use),
            "worker.jobs_run": float(self.worker_jobs_run
                                     + (w.jobs_run if live else 0)),
            "worker.busy_s": (self.worker_busy_s
                              + (w.busy_s if live else 0.0)),
        }
