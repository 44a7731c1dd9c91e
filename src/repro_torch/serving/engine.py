"""Real-execution serving engine of the port: continuous batching with
dynamic sparse attention decode over a hierarchical HBM/DRAM KV cache.

Counterpart of ``repro/serving/engine.py`` for dense GQA and MLA
decoders, Jamba's Mamba + attention hybrid, the attention-free RWKV6,
the VLM's patch prefix and Whisper's encoder-decoder on one device.  By default every iteration is
ONE mixed layer walk (``core.hybrid_plane``) carrying the staged decode
plane's rows (select -> host stage -> attend per layer) and the batched
layer-segmented prefill plane's segments, with one host stage per
attention layer:

1. one merged fused FlashD2H save of the layer's new KV (decode write-back
   plus fresh prefill chunks) — on the ``HostStageWorker`` thread when
   ``stage_dispatch="async"`` (the default), inline when ``"sync"`` (the
   equivalence oracle; async must give byte-identical greedy tokens).
   Under ``offload_quant="int8"`` on the GPU the save always runs inline:
   the stripes stay on the device and the touched blocks requantize
   through the quant kernels on the current stream, ahead of the layer's
   gather;
2. the LRU round for every decode row's DSA selection, then at most ONE
   fused FlashH2D load of the misses (the ``gather_blocks_hkv`` kernel
   reading the pinned host pools) scattered into the device slots
   (``scatter_blocks_hkv``) BEFORE the attention that selected them;
3. the one-stage-deferred physical drop of LRU-evicted blocks;
4. the end-of-layer decode-pool builds of prefill rows and their HBM
   layer eviction (the one-layer prefill bound).

The reference's oracle paths run here too, resolved as the reference
resolves them (``resolve_config``): ``hybrid_plane="split"`` (the prefill
plane's iteration, then the staged decode plane's), the fused
``decode_plane="persistent"`` forward whose restores land after it, the
``"stacked"`` pad + concat of every pool each step,
``batched_decode=False`` (one B=1 forward per request),
``prefill_exec="legacy"`` (one request's whole layer at a time) and
``prefill_mode="chunked"`` (every layer over a chunk of tokens, with the
earlier chunks' KV as dense context).  MLA models run whole-layer
prefill segments and raise ``NotImplementedError`` for the chunked
baseline, as the reference does: the latent cache has no chunked-context
attention.  Their host pools hold the one latent head (see
``core.kv_cache.KVGeometry.stored_heads``) while the geometry and every
transfer counter keep the reference's ``max(num_kv_heads, 1)`` heads.

A hybrid's KV manager and HBM cache count attention layers only: model
layer ``l`` is KV layer ``_layer_to_lidx[l]`` (its attention ordinal) and
an eviction key's KV layer maps back through ``_lidx_to_layer``, as in
the reference.  Its Mamba layers save no KV: their prefill groups only
advance the rows' recurrent states, which join the decode state at
finalize (``PrefillPlane.rec_state``; the legacy executor's and the
chunked baseline's own carries), and a decode step runs them as one
stage.  RWKV6's layers are all recurrent: the geometry keeps the
reference's one KV layer of zero-byte blocks (head_dim 0), nothing is
saved or restored, and a decode step runs no host stage.

Frontend models take their tensors at ``submit`` (``patch_embeds`` for
the VLM, whose patches count into the request's host pool; ``frames``
for Whisper).  Their requests are embedded one at a time (the encoder
runs there) while pure-text admissions share one batched embed.  As in
the reference, prefill planes are keyed by the shapes of a request's
encoder KV and decode planes by the shapes of its decode state's
``extra``: Whisper requests of unequal encoder lengths ride separate
planes, all in one mixed walk.  The chunked baseline keeps the
reference's behaviour for frontend models: it embeds the prompt tokens
only and runs no cross-attention.

Iteration latency is charged from the copied analytic cost model unless
``charge_real_time`` is set (the GPU launcher sets it, and then TTFT/TBT
are the card's wall clock).  A plane mesh is not ported and raises
``NotImplementedError``.

The obs layer (``repro_torch.obs``) is the reference's: with
``EngineConfig(obs=True)`` (or ``obs=None`` and ``REPRO_OBS=1``) the
engine installs a ``Tracer`` into the planes, the KV manager and the
host-stage worker, and records one ``iteration`` span per step; the
scheduler gauges and the iteration-time histogram flow into a
``MetricsRegistry`` either way (``metrics_snapshot``,
``metrics_prometheus``).  Every span is a host wall-clock span; none adds
a device sync.
"""
from __future__ import annotations

import dataclasses
import os
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
from repro_torch.core.layer_prefill import (LayerPrefillState,
                                            hbm_footprint_tokens,
                                            plan_segments)
from repro_torch.core.prefill_plane import (PrefillIterationResult,
                                            PrefillPlane, admit_embed)
from repro_torch.core.scheduler import BatchPlan, Scheduler, SchedulerConfig
from repro_torch.device import dispatch_window, host_to_device
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace_analysis import achieved_overlap_fraction
from repro_torch.obs.tracing import NULL_TRACER, Tracer
from repro_torch.serving import costmodel as cm
from repro_torch.serving.metrics import ServingMetrics, compute_metrics
from repro_torch.serving.request import Phase, Request


@dataclasses.dataclass
class EngineConfig:
    """The reference's ``EngineConfig`` fields and defaults, less the
    ``attn_impl`` knob (the device of the tensors decides).  A mesh_spec
    raises ``NotImplementedError`` in ``ServingEngine``: the staged
    planes' sharded stages are not ported."""
    prefill_mode: str = "layer_segmented"    # | "chunked" (the baseline)
    prefill_exec: str = "plane"              # | "legacy" (per-request
                                             # whole layers, the oracle)
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
    batched_decode: bool = True              # False: one B=1 forward per
                                             # request (the oracle)
    decode_plane: str = "staged"             # | "persistent" (one fused
                                             # forward, restores after it)
                                             # | "stacked" (pad + concat
                                             # every step)
    bucketing: BucketingPolicy = dataclasses.field(
        default_factory=BucketingPolicy)
    decode_write_back: bool = True           # FlashD2H of decode KV
    mesh_spec: Any = None
    hybrid_plane: str = "mixed"              # | "split" (prefill plane,
                                             # then decode plane: the
                                             # oracle)
    stage_dispatch: str = "async"            # "async" | "sync" (oracle)
    drop_evicted_device_blocks: Optional[bool] = None   # None -> on for
                                             # the batched staged plane
    # DRAM offload tier: "none" (float32 host pools) or "int8" (int8 host
    # pools with one f32 scale per (layer, kv-head, block); touched blocks
    # requantize on the FlashD2H save and dequantize where the FlashH2D
    # restore lands, so each moved element costs 1 wire byte, not 4)
    offload_quant: str = "none"
    # True: the engine builds a Tracer (Chrome trace-event JSON, one lane
    # per thread) and installs it into the planes, the KV manager and the
    # host-stage worker.  None resolves from REPRO_OBS=1 into a copy.
    # Off, each instrumentation point costs one `tracer.enabled` read;
    # `metrics_snapshot()` works either way.
    obs: Optional[bool] = None


_VALUES = {
    "prefill_mode": ("layer_segmented", "chunked"),
    "prefill_exec": ("plane", "legacy"),
    "decode_plane": ("staged", "persistent", "stacked"),
    "hybrid_plane": ("mixed", "split"),
    "stage_dispatch": ("async", "sync"),
    "offload_quant": ("none", "int8"),
}


def resolve_config(eng: EngineConfig) -> EngineConfig:
    """Validate ``eng`` and resolve it as the reference engine does, into
    a COPY (the caller's config stays as given):

    - ``hybrid_plane="mixed"`` becomes ``"split"`` unless the batched
      staged decode plane and the layer-segmented prefill plane run: the
      mixed walk drives exactly those two;
    - ``drop_evicted_device_blocks=None`` becomes True only on the batched
      staged plane with decode write-back, where restores land before the
      attention that selected them (elsewhere a drop would change the
      outputs, or has no device plane to act on);
    - an explicit drop without write-back, or without a device plane,
      raises ``ValueError``;
    - ``obs=None`` becomes True when the environment sets
      ``REPRO_OBS=1``, False otherwise."""
    for field, allowed in _VALUES.items():
        val = getattr(eng, field)
        if val not in allowed:
            raise ValueError(f"unknown {field} {val!r}; expected one of "
                             f"{allowed}")
    if eng.mesh_spec is not None:
        raise NotImplementedError(
            "mesh_spec: the staged planes' sharded stages are not ported; "
            "the reference's own sharded staged tests fail under jax 0.9.0 "
            "(tests/test_plane_mesh.py), so there are no tokens to hold "
            "them against (ROADMAP.md, queue 1 item 9).  The fused mesh "
            "bodies run through "
            "models.model.decode_step(plane_mesh=...), "
            "prefill_attn_layer_batched(plane_mesh=...) and "
            "ffn.moe_apply_ep (launch/plane_mesh.py)")
    if eng.obs is None:
        eng = dataclasses.replace(
            eng, obs=os.environ.get("REPRO_OBS", "") == "1")
    if eng.hybrid_plane == "mixed" and not (
            eng.batched_decode and eng.decode_plane == "staged"
            and eng.prefill_mode == "layer_segmented"
            and eng.prefill_exec == "plane"):
        eng = dataclasses.replace(eng, hybrid_plane="split")
    if eng.drop_evicted_device_blocks is None:
        eng = dataclasses.replace(eng, drop_evicted_device_blocks=(
            eng.decode_plane == "staged" and eng.batched_decode
            and eng.decode_write_back))
    if eng.drop_evicted_device_blocks and not eng.decode_write_back:
        raise ValueError(
            "drop_evicted_device_blocks requires decode_write_back: "
            "restores come from the host pool, which is only a superset "
            "of device KV when decode write-back is on")
    if eng.drop_evicted_device_blocks and not (
            eng.batched_decode
            and eng.decode_plane in ("staged", "persistent")):
        raise ValueError(
            "drop_evicted_device_blocks only acts on a device plane "
            "(batched_decode=True, decode_plane='staged' or 'persistent')")
    return eng


@dataclasses.dataclass
class _ReqState:
    """Engine-side state for one request."""
    req: Request
    tokens: np.ndarray                              # prompt token ids
    decode_state: Optional[Dict] = None             # B=1 pools until the
                                                    # decode plane owns them
    lp: Optional[LayerPrefillState] = None          # legacy executor cursor
    prefill_carry: int = 0                          # unspent token budget
    chunk_ctx: Optional[List] = None                # chunked: per-layer
                                                    # dense (k, v) context
    chunk_rec: Optional[List] = None                # chunked: recurrent
                                                    # states (none: dense)
    last_logits: Optional[torch.Tensor] = None      # (1, V) on the host
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    num_blocks: int = 0
    inputs_extra: Dict[str, Any] = dataclasses.field(
        default_factory=dict)                       # frames / patch_embeds
    group_key: Optional[Tuple] = None               # its decode plane's key


class ServingEngine:
    """Continuous-batching engine over real model forwards.  Runs on the
    device of ``params``."""

    def __init__(self, params: Dict, cfg: ModelConfig, eng: EngineConfig,
                 hw: cm.HardwareSpec = cm.TPU_V5E):
        M.check_supported(cfg)
        eng = resolve_config(eng)
        if eng.prefill_mode == "chunked" and cfg.attention_type == "mla":
            raise NotImplementedError(
                "chunked prefill does not support MLA models; use "
                "prefill_mode='layer_segmented'")
        self.params = params
        self.cfg = cfg
        self.hw = hw                 # the modelled clock's preset
        self.device = params["embed"].device
        self.kv_dtype = params["embed"].dtype
        self.eng = eng
        self.tracer = Tracer() if eng.obs else NULL_TRACER
        self.metrics = MetricsRegistry()
        self.mc = cm.ModelCost.from_config(cfg)
        self.rng = np.random.default_rng(eng.seed)
        self.geom = KVGeometry.of_model(cfg)
        inject = (eng.max_inject_tokens if eng.max_inject_tokens > 0
                  else eng.chunk_size * cfg.num_layers)
        self._plane_prefill = (eng.prefill_mode == "layer_segmented"
                               and eng.prefill_exec == "plane")
        # MLA keeps whole-layer prefill segments (no chunked context)
        self._seg_tokens = (eng.prefill_max_tokens_per_step
                            if cfg.attention_type != "mla" else 0)
        self.scheduler = Scheduler(
            SchedulerConfig(
                r_max=eng.r_max, t_max=eng.t_max,
                m_avl_bytes=eng.hbm_budget_bytes if eng.ws_control else 0,
                prefill_mode=eng.prefill_mode, chunk_size=eng.chunk_size,
                max_inject_tokens=inject,
                segment_tokens=(self._seg_tokens
                                if self._plane_prefill else 0),
                ws_control=eng.ws_control),
            self.geom, cfg.num_layers, cfg.dsa.top_k_blocks)
        self.kv_mgr = KVCacheManager(self.geom, eng.hbm_budget_bytes,
                                     offload_quant=eng.offload_quant,
                                     device=self.device)
        self.kv_mgr.tracer = self.tracer
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
        self.stack_calls = 0          # full-pool stack/unstack round trips
        self.prefill_launches = 0
        self.admit_embed_launches = 0
        # decode planes keyed by _decode_group_key, prefill planes by
        # _prefill_group_key, each made at its group's first use
        self.planes: Dict[Tuple, DevicePoolPlane] = {}
        self.prefill_planes: Dict[Tuple, PrefillPlane] = {}
        self._req_plane: Dict[str, DevicePoolPlane] = {}
        self._req_prefill_plane: Dict[str, PrefillPlane] = {}
        self.hybrid = (HybridPlane(cfg) if eng.hybrid_plane == "mixed"
                       else None)
        if self.hybrid is not None:
            self.hybrid.tracer = self.tracer
        self._stage_async = eng.stage_dispatch == "async"
        self._worker: Optional[HostStageWorker] = None
        self.worker_jobs_run = 0
        self.worker_busy_s = 0.0
        # per-iteration scheduler gauges (one .set() each per iteration)
        _m = self.metrics
        self._g_queue = _m.gauge(
            "sched.queue_depth", "requests waiting for admission")
        self._g_running = _m.gauge(
            "sched.running", "requests admitted (prefill+decode)")
        self._g_batch_decode = _m.gauge(
            "sched.batch_decode_rows", "decode rows this iteration")
        self._g_batch_prefill = _m.gauge(
            "sched.batch_prefill_rows", "prefill rows this iteration")
        self._g_ws_decode = _m.gauge(
            "sched.ws_decode_bytes", "estimated decode working set")
        self._g_ws_prefill = _m.gauge(
            "sched.ws_prefill_bytes", "estimated prefill working set")
        self._g_hbm_used = _m.gauge(
            "kv.hbm_used_bytes", "actual HBM residency after the iteration")
        self._h_iter = _m.histogram(
            "engine.iteration_s", "wall-clock seconds per engine iteration")
        self._staged_layer_bytes: Dict[int, int] = {}
        # per mixed iteration: row counts, prefill groups and finalizes,
        # the stage launches, and per layer its fused d2h / h2d calls and
        # prefill groups (plane_contract.mixed_launch_mismatches reads it)
        self.mixed_iter_log: List[Dict[str, Any]] = []
        # test hook: called between a layer's restore and its attend as
        # probe(engine, plane, layer, sts, blocks_by_req)
        self.staged_probe = None
        # model layer -> attention ordinal (the KV manager's layer; a
        # recurrent layer maps to the next attention layer's, as in the
        # reference, and is never used) and back, for eviction keys
        self._layer_to_lidx: Dict[int, int] = {}
        self._lidx_to_layer: Dict[int, int] = {}
        n = 0
        for i in range(cfg.num_layers):
            self._layer_to_lidx[i] = min(n, self.geom.num_layers - 1)
            if M.layer_kind(cfg, i) == "attn":
                self._lidx_to_layer[n] = i
                n += 1

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------
    @property
    def plane(self) -> DevicePoolPlane:
        """The decode plane of the group without encoder KV (key ()),
        which holds every request of a decoder-only model."""
        return self._decode_plane(())

    @property
    def prefill_plane(self) -> PrefillPlane:
        """The prefill plane of the group without encoder KV."""
        return self._prefill_plane(())

    def _decode_plane(self, key: Tuple) -> DevicePoolPlane:
        """The decode plane of group ``key``, made at its first use."""
        plane = self.planes.get(key)
        if plane is None:
            plane = self.planes[key] = DevicePoolPlane(self.cfg,
                                                       self.eng.bucketing)
            plane.tracer = self.tracer
        return plane

    def _prefill_plane(self, key: Tuple) -> PrefillPlane:
        """The prefill plane of group ``key``, made at its first use."""
        plane = self.prefill_planes.get(key)
        if plane is None:
            plane = self.prefill_planes[key] = PrefillPlane(
                self.cfg, self.eng.bucketing)
            plane.tracer = self.tracer
        return plane

    def submit(self, req: Request, tokens: Optional[np.ndarray] = None,
               **inputs_extra) -> None:
        """Register a request (it joins the scheduler queue at
        ``req.arrival_time``, engine-clock seconds).  ``tokens``: prompt
        ids of length ``req.prompt_len`` (drawn at random when omitted).
        ``inputs_extra``: the frontend tensors (``frames`` for Whisper,
        ``patch_embeds`` for the VLM), host arrays with a leading batch
        axis of 1.  The host pool is sized for ``prompt_len +
        max_new_tokens`` (+ the VLM's patches)."""
        if tokens is None:
            tokens = self.rng.integers(
                4, self.cfg.vocab_size, size=req.prompt_len).astype(np.int32)
        if len(tokens) != req.prompt_len:
            raise ValueError(f"{req.req_id}: {len(tokens)} tokens for "
                             f"prompt_len {req.prompt_len}")
        st = _ReqState(req=req, tokens=np.asarray(tokens, np.int32),
                       inputs_extra=dict(inputs_extra))
        total = req.prompt_len + req.max_new_tokens
        if self.cfg.frontend == "vit_patch_stub":
            total += self.cfg.num_patches
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
    # Prefill: the legacy executor and the chunked baseline
    # ------------------------------------------------------------------
    def _model_inputs(self, st: _ReqState) -> Dict[str, torch.Tensor]:
        """The request's prompt (1, S) and frontend tensors on the
        engine's device."""
        d = {"tokens": host_to_device(st.tokens[None, :], self.device)}
        d.update({k: host_to_device(v, self.device, torch.float32)
                  for k, v in st.inputs_extra.items()})
        return d

    def _kv_to_layer_cache(self, st: _ReqState, kv_out: Tuple) -> Dict:
        return M.kv_to_cache(self.cfg, kv_out, st.num_blocks, self.kv_dtype)

    def _save_prompt_layer(self, rid: str, lidx: int, kv: Tuple) -> None:
        """FlashD2H of one request's whole-prompt KV of KV layer ``lidx``
        (k, v each (1, S, Hkv, D); MLA's latent with v None) from token 0:
        one contiguous save on its host pool (``HostPool.save_contiguous``),
        flushed by the caller."""
        host = self.kv_mgr.pools.get(rid)
        if host is None:
            return
        k, v = self.kv_mgr.ship(*(None if t is None
                                  else t[0].permute(1, 0, 2).float()
                                  for t in kv)).wait()
        host.save_contiguous(lidx, 0, k, v)

    def _start_layer_segmented(self, st: _ReqState,
                               tokens_per_step: int) -> None:
        h, positions, enc_kvs = M.prefill_embed(self.params, self.cfg,
                                                self._model_inputs(st))
        segs = plan_segments(st.req.prompt_len, self.cfg.num_layers,
                             tokens_per_step)
        st.lp = LayerPrefillState(
            segments=segs, hidden=h, positions=positions, enc_kvs=enc_kvs,
            rec_states=M._init_rec_states(self.cfg, 1, h.dtype, h.device))
        st.decode_state = {"caches": [None] * self.cfg.num_layers,
                           "cur_len": None,
                           "extra": {"enc_kvs": enc_kvs} if enc_kvs else {}}

    def _run_layer_segment(self, st: _ReqState) -> bool:
        """The legacy executor: the request's next whole layer, its KV
        saved to DRAM (one contiguous save, then the pool's flush: in the
        int8 tier one ``quant_save_blocks`` call) and evicted from HBM; a
        Mamba or RWKV layer's new state goes into the decode state.  Returns True
        when the prefill is done."""
        seg = st.lp.advance()
        l = seg.layer
        h, kv_out, new_rec = M.prefill_layer(
            self.params, self.cfg, l, st.lp.hidden, st.lp.positions,
            rec_state=st.lp.rec_states[l],
            enc_kv=M.index_enc_kvs(st.lp.enc_kvs, l), moe_drop_free=True)
        st.lp.hidden = h
        st.lp.rec_states[l] = new_rec
        rid = st.req.req_id
        if kv_out is None:
            st.decode_state["caches"][l] = new_rec
        else:
            lidx = self._layer_to_lidx[l]
            st.decode_state["caches"][l] = self._kv_to_layer_cache(st, kv_out)
            # plane-contract: allow(fused-transfer) the legacy executor runs one request's whole layer: its one save is per request by design (the oracle of the plane's fused saves)
            self._save_prompt_layer(rid, lidx, kv_out)
            host = self.kv_mgr.pools.get(rid)
            if host is not None:
                host.flush()
            cache = self.kv_mgr.caches.get(rid)
            if cache is not None:
                cache.drop_layer(lidx)
        if seg.is_last:
            st.last_logits = M.prefill_finalize(
                self.params, self.cfg, st.lp.hidden).float().cpu()
            st.decode_state["cur_len"] = torch.full(
                (1,), int(st.lp.hidden.shape[1]), dtype=torch.int32)
            st.lp = None
            return True
        return False

    def _run_chunked_prefill(self, st: _ReqState, inject: int) -> bool:
        """Chunked-prefill baseline: ``inject`` new prompt tokens through
        ALL layers, each layer attending to its dense KV of the earlier
        chunks (``flash_prefill`` with the context and ``q_offset`` on the
        GPU); a Mamba or RWKV layer runs the chunk from its carried state
        (``chunk_rec``, float32 zeros at the start as in the reference).
        At the last chunk the pools are built and the prompt KV is saved to
        DRAM, one contiguous save per attention layer and one flush.  As in
        the reference, a frontend model's chunks embed the prompt tokens
        only (no patches) and run no cross-attention.  Returns True when
        the prefill is done."""
        cfg = self.cfg
        r = st.req
        start = r.prefill_tokens_done
        end = min(start + inject, r.prompt_len)
        if st.chunk_ctx is None:
            st.chunk_ctx = [None] * cfg.num_layers
            st.chunk_rec = M._init_rec_states(cfg, 1, torch.float32,
                                              self.device)
        toks = host_to_device(st.tokens[None, start:end], self.device)
        h = self.params["embed"][toks.long()]
        positions = torch.arange(start, end, dtype=torch.int32,
                                 device=self.device)[None, :]
        for l in range(cfg.num_layers):
            kind = M.layer_kind(cfg, l)
            if kind != "attn":
                h, st.chunk_rec[l] = M.layer_forward(
                    M.get_layer(self.params, l), cfg, h, positions,
                    kind=kind, rec_state=st.chunk_rec[l],
                    moe_drop_free=True)
                continue
            ctx = st.chunk_ctx[l]
            h, (k, v) = M.layer_forward(
                M.get_layer(self.params, l), cfg, h, positions,
                k_ctx=None if ctx is None else ctx[0],
                v_ctx=None if ctx is None else ctx[1], q_offset=start,
                return_kv=True, moe_drop_free=True)
            st.chunk_ctx[l] = ((k, v) if ctx is None else
                               (torch.cat([ctx[0], k], dim=1),
                                torch.cat([ctx[1], v], dim=1)))
        r.prefill_tokens_done = end
        if end < r.prompt_len:
            return False
        st.last_logits = M.lm_head(self.params, cfg,
                                   h[:, -1:, :])[:, 0].float().cpu()
        caches = []
        for l in range(cfg.num_layers):
            if st.chunk_ctx[l] is None:             # a recurrent layer
                caches.append(st.chunk_rec[l])
                continue
            caches.append(self._kv_to_layer_cache(st, st.chunk_ctx[l]))
            # plane-contract: allow(fused-transfer) the chunked baseline saves one request's prompt per layer at its last chunk, as the reference's baseline does
            self._save_prompt_layer(r.req_id, self._layer_to_lidx[l],
                                    st.chunk_ctx[l])
        host = self.kv_mgr.pools.get(r.req_id)
        if host is not None:
            host.flush()
        st.decode_state = {
            "caches": caches,
            "cur_len": torch.full((1,), r.prompt_len, dtype=torch.int32),
            "extra": {}}
        st.chunk_ctx = st.chunk_rec = None
        return True

    # ------------------------------------------------------------------
    # Prefill plane (batched layer-segmented prefill, the default)
    # ------------------------------------------------------------------
    def _batched_admit_embed(self, sts: List[_ReqState]
                             ) -> Dict[str, torch.Tensor]:
        """{req_id: h (1, S, d)} for an admission batch's pure-text rows,
        embedded in ONE bucketed launch.  Requests with frontend tensors
        (Whisper's frames, the VLM's patches) take the per-request
        ``prefill_embed`` in ``_admit_prefill_plane``."""
        cfg = self.cfg
        text = [st for st in sts
                if not st.inputs_extra and cfg.frontend == "none"
                and not cfg.is_encoder_decoder]
        if not text:
            return {}
        pol = self.eng.bucketing
        n_cap = pol.bucket_batch(len(text))
        s_cap = pol.bucket_tokens(max(len(st.tokens) for st in text))
        toks = np.zeros((n_cap, s_cap), np.int32)
        for i, st in enumerate(text):
            toks[i, :len(st.tokens)] = st.tokens
        h_all = admit_embed(self.params, host_to_device(toks, self.device))
        self.admit_embed_launches += 1
        return {st.req.req_id: h_all[i:i + 1, :len(st.tokens)]
                for i, st in enumerate(text)}

    @staticmethod
    def _prefill_group_key(enc_kvs: Optional[List[Tuple]]) -> Tuple:
        """Requests share a prefill plane when their encoder KV shapes
        agree (the decode planes' grouping, at admission)."""
        if not enc_kvs:
            return ()
        return tuple((tuple(a.shape[1:]), str(a.dtype))
                     for kv in enc_kvs for a in kv)

    def _admit_prefill_plane(self, st: _ReqState,
                             h: Optional[torch.Tensor]) -> PrefillPlane:
        """Plan the request's (layer, chunk) segments and admit it into its
        group's prefill plane.  ``h``: its row of the admission batch's
        embed; None embeds it alone (``prefill_embed``: the patches, or
        the encoder and every layer's cross keys and values)."""
        cfg = self.cfg
        enc_kvs = None
        if h is None:
            h, _, enc_kvs = M.prefill_embed(self.params, cfg,
                                            self._model_inputs(st))
        S = int(h.shape[1])                     # prompt (+ patches)
        plane = self._prefill_plane(self._prefill_group_key(enc_kvs))
        plane.admit(st.req.req_id, h,
                    plan_segments(S, cfg.num_layers, self._seg_tokens or S),
                    enc_kvs)
        self._req_prefill_plane[st.req.req_id] = plane
        st.decode_state = {"caches": [None] * cfg.num_layers,
                           "cur_len": None,
                           "extra": {"enc_kvs": enc_kvs} if enc_kvs else {}}
        return plane

    def _admit_prefill_planes(self, prefill_reqs
                              ) -> Dict[int, Tuple[PrefillPlane,
                                                   Dict[str, int]]]:
        """Admit the plan's new prefill requests into their planes' rows
        (one batched embed for the pure-text ones) and grant every
        scheduled row its token budget.  Returns {id(plane): (plane,
        {req_id: tokens})} in the plan's order."""
        pre_h = self._batched_admit_embed(
            [self.states[req.req_id] for req, _ in prefill_reqs
             if req.req_id not in self._req_prefill_plane])
        by_plane: Dict[int, Tuple[PrefillPlane, Dict[str, int]]] = {}
        for req, inject in prefill_reqs:
            st = self.states[req.req_id]
            if req.scheduled_time is None:
                req.scheduled_time = self.now
            plane = self._req_prefill_plane.get(req.req_id)
            if plane is None:
                plane = self._admit_prefill_plane(st,
                                                  pre_h.get(req.req_id))
            st.prefill_carry += max(int(inject), 1)
            _, allow = by_plane.setdefault(id(plane), (plane, {}))
            allow[req.req_id] = st.prefill_carry
        return by_plane

    def _group_prefill_time(self, g) -> float:
        return cm.batched_prefill_time(
            self.hw, self.mc,
            [(g.segs[rid].chunk_len, g.chunk_start + g.segs[rid].chunk_len)
             for rid in g.req_ids], layers=1)

    def _end_of_layer(self, pp: PrefillPlane, g) -> None:
        """A group's rows that finished their layer: build the decode pool
        from the plane's one-layer context, then evict the layer from HBM
        (the one-layer bound).  Nothing for a recurrent layer's group."""
        if g.kind != "attn":
            return
        for rid in g.req_ids:
            if not g.segs[rid].is_last_chunk_of_layer:
                continue
            st_r = self.states[rid]
            st_r.decode_state["caches"][g.layer] = \
                self._kv_to_layer_cache(st_r, pp.layer_ctx(rid))
            cache = self.kv_mgr.caches.get(rid)
            if cache is not None:
                cache.drop_layer(self._layer_to_lidx[g.layer])

    def _prefill_epilogue(self, pp: PrefillPlane,
                          pres: PrefillIterationResult,
                          allow: Dict[str, int], spent: Dict[str, int],
                          done: List[Request]) -> int:
        """After an iteration of prefill plane ``pp``: carry the unspent
        budgets, mirror the row cursors into the scheduler's pacing state,
        take the finished rows' logits and recurrent states and release
        them (appended to ``done``).  Returns the plane's HBM footprint in
        token-layer units."""
        L = self.cfg.num_layers
        fp = 0
        for rid in allow:
            st_r = self.states[rid]
            st_r.prefill_carry = max(0, st_r.prefill_carry
                                     - spent.get(rid, 0))
            req = st_r.req
            if not pp.done(rid):
                seg = pp.segments[rid][pp.next_idx[rid]]
                req.prefill_layer = seg.layer
                req.prefill_layer_tokens_done = min(
                    seg.chunk_start, max(req.prompt_len - 1, 0))
        for rid, peak in pres.peaks.items():
            fp += hbm_footprint_tokens(pp.tok_len[rid], "layer_segmented", L,
                                       layer_tokens_resident=peak)
        host_logits = (pres.logits.float().cpu() if pres.finished
                       else None)
        for rid in pres.finished:
            st_r = self.states[rid]
            row = pp.rows[rid]
            st_r.last_logits = host_logits[row:row + 1]
            caches = st_r.decode_state["caches"]
            for l in range(L):
                if caches[l] is None and M.layer_kind(self.cfg, l) != "attn":
                    caches[l] = pp.rec_state(rid, l)
            st_r.decode_state["cur_len"] = torch.full(
                (1,), pp.tok_len[rid], dtype=torch.int32)
            st_r.req.prefill_layer = L
            st_r.req.prefill_layer_tokens_done = 0
            pp.release(rid)
            self._req_prefill_plane.pop(rid, None)
            done.append(st_r.req)
        return fp

    def _idle_prefill_footprint(self, by_plane: Dict[int, Any]) -> int:
        """Token-layers held by the rows of the prefill planes with no
        scheduled prefill this iteration (not in ``by_plane``), parked
        mid-layer."""
        return sum(hbm_footprint_tokens(pp.tok_len[rid], "layer_segmented",
                                        self.cfg.num_layers,
                                        layer_tokens_resident=resident)
                   for pp in self.prefill_planes.values()
                   if id(pp) not in by_plane
                   for rid, resident in pp.resident_tokens().items())

    def _prefill_plane_iteration(self, prefill_reqs
                                 ) -> Tuple[float, List[Request], int]:
        """The split path's prefill: one iteration of each prefill plane
        with scheduled rows (``PrefillPlane.run_iteration``).  Per (layer,
        chunk) group: one batched launch, ONE fused FlashD2H save of the
        group's stripes and the pools' flush (in the int8 tier one
        ``quant_save_blocks`` call), then the end-of-layer pool builds and
        layer evictions.  Returns (modelled seconds, finished requests,
        HBM footprint in token-layer units)."""
        done: List[Request] = []
        by_plane = self._admit_prefill_planes(prefill_reqs)
        t = [0.0]
        fp = 0
        for pp, allow in by_plane.values():
            spent: Dict[str, int] = {}

            def group_cb(g, pp=pp, spent=spent) -> None:
                # runs while the plane's one-layer context still holds
                # the group's layer
                t[0] += self._group_prefill_time(g)
                self.prefill_launches += 1
                for rid in g.req_ids:
                    spent[rid] = spent.get(rid, 0) + g.segs[rid].chunk_len
                if g.kind != "attn":
                    return
                lidx = self._layer_to_lidx[g.layer]
                kv_by_req = pp.read_group_kv(g, self.kv_mgr.ship)
                self.kv_mgr.save_new_tokens_fused(lidx, {
                    rid: (g.chunk_start, k, v)
                    for rid, (k, v) in kv_by_req.items()})
                self.kv_mgr.flush_fused(lidx, list(g.req_ids))
                self._end_of_layer(pp, g)

            res = pp.run_iteration(self.params, allow, group_cb)
            fp += self._prefill_epilogue(pp, res, allow, spent, done)
        return t[0], done, fp + self._idle_prefill_footprint(by_plane)

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
        prefill_by_layer = [0.0] * L
        spent: Dict[str, int] = {}

        by_plane = self._admit_prefill_planes(plan.prefill_reqs)
        prefill_jobs = [PrefillJob(pp, allow)
                        for pp, allow in by_plane.values()]

        # decode jobs, one per group: each plane admits its new rows and
        # takes their state
        decode_sts: List[List[_ReqState]] = []
        decode_jobs: List[DecodeJob] = []
        pending_evict: Dict[str, set] = {}
        sel_pairs: Dict[str, List[Tuple[int, int]]] = {}
        for key, sts in self._decode_groups(plan.decode_reqs).items():
            decode_jobs.append(DecodeJob(self._plane_for(key, sts), {
                st.req.req_id: st.out_tokens[-1] for st in sts}))
            decode_sts.append(sts)
            pending_evict.update({st.req.req_id: set() for st in sts})
            sel_pairs.update({st.req.req_id: [] for st in sts})
        entry: Dict[str, Any] = {
            "layers": {}, "decode_planes": len(decode_jobs),
            "decode_rows": len(plan.decode_reqs),
            "prefill_rows": len(plan.prefill_reqs),
            "groups": 0, "finalize": 0, "launches": 0}

        worker = self._stage_worker() if self._stage_async else None

        def layer_cb(win: LayerWindow) -> None:
            # in async mode this is the dispatch window: nothing in it may
            # wait for the device (on the GPU a sync there raises)
            with dispatch_window(self.device, armed=worker is not None):
                # a recurrent layer has only prefill groups, which save no KV
                lidx = self._layer_to_lidx[win.layer]
                lay_log = {"d2h": 0, "h2d": 0, "groups": len(win.groups),
                           "attn": win.kind == "attn",
                           "decode": bool(win.selections)}
                entry["layers"][win.layer] = lay_log
                for _, g in win.groups:
                    prefill_by_layer[win.layer] += \
                        self._group_prefill_time(g)
                    self.prefill_launches += 1
                    for rid in g.req_ids:
                        spent[rid] = (spent.get(rid, 0)
                                      + g.segs[rid].chunk_len)
                # 1. ONE merged fused FlashD2H: decode write-back + fresh
                #    prefill-chunk KV of this layer
                ship = self.kv_mgr.ship
                parts = []
                if self.eng.decode_write_back:
                    for d, _ in win.selections:
                        parts.append((list(d.req_ids), dict(d.prev),
                                      d.plane.new_token_kv_async(
                                          d.req_ids, d.prev,
                                          layers=[win.layer],
                                          ship=ship)[win.layer]))
                finishers = [(g.chunk_start, pp.read_group_kv_async(g, ship))
                             for pp, g in win.groups if g.kind == "attn"]
                if parts or finishers:
                    self._stage_writeback(worker, lidx, parts, finishers)
                    lay_log["d2h"] += 1
                # 2.-3. LRU round, at most ONE merged FlashH2D restored before
                #    use, the deferred eviction drop and the probe
                lay_log["h2d"] += bool(self._stage_decode_layer(
                    worker, win.layer,
                    [(d.plane, {rid: sel[d.plane.rows[rid]]
                                for rid in d.req_ids})
                     for d, sel in win.selections if sel is not None],
                    pending_evict, sel_pairs))
                # 4. prefill end-of-layer: decode pool builds + HBM layer evict
                for pp, g in win.groups:
                    self._end_of_layer(pp, g)

        # the stage launches of the walk, counted by the planes it drives
        involved = {id(p): p for p in
                    [j.plane for j in decode_jobs]
                    + [j.plane for j in prefill_jobs]}.values()
        launches0 = sum(p.stage_launches for p in involved)
        res = self.hybrid.run_iteration(self.params, decode_jobs,
                                        prefill_jobs, layer_cb)
        if worker is not None:
            # iteration fence: every merged write-back has landed before
            # sampling or a release can drop a DRAM pool
            worker.drain()
        entry["launches"] = sum(p.stage_launches for p in involved) - launches0

        # decode epilogue
        for (dplane, logits, _info, _prev), sts in zip(res.decode,
                                                      decode_sts):
            self._decode_epilogue(dplane, sts, logits, pending_evict,
                                  sel_pairs)

        # prefill epilogue
        fp = 0
        for pp, pres in res.prefill:
            entry["groups"] += len(pres.groups)
            entry["finalize"] += 1 if pres.finished else 0
            fp += self._prefill_epilogue(pp, pres, by_plane[id(pp)][1],
                                         spent, done)
        # the rows of planes with nothing scheduled still hold their
        # chunk residency
        fp += self._idle_prefill_footprint(by_plane)
        self.mixed_iter_log.append(entry)
        return done, fp, prefill_by_layer

    # ------------------------------------------------------------------
    # Host stage
    # ------------------------------------------------------------------
    def _stage_writeback(self, worker: Optional[HostStageWorker],
                         lidx: int, parts: List[Tuple],
                         finishers: List[Tuple]) -> None:
        """Dispatch layer ``lidx``'s ONE fused FlashD2H (the reference's
        ``_stage_writeback_async`` and its merged form): on ``worker``
        when there is one and the save runs on the host, inline otherwise
        (sync mode, and the int8 tier on the GPU, whose save kernels run
        on the current stream).  Completion is fenced by ``fence(lidx)``
        before a same-layer gather and ``drain()`` before sampling."""
        if worker is not None and not self.kv_mgr.device_save:
            worker.submit(lidx, self._stage_writeback_merged, lidx, parts,
                          finishers)
        else:
            self._stage_writeback_merged(lidx, parts, finishers)

    def _stage_writeback_merged(self, lidx: int, parts: List[Tuple],
                                finishers: List[Tuple]) -> None:
        """ONE fused FlashD2H save for layer ``lidx``: every decode
        plane's appended stripe (``parts``: (req_ids, prev, what
        ``KVCacheManager.ship`` returned)) merged with every prefill
        group's fresh chunk
        (``finishers``: (chunk_start, finish)) in a single
        ``save_new_tokens_fused`` call, then the pools' flush (one
        ``flush_fused`` call: in the int8 tier one ``quant_save_blocks``
        launch for every request's stripes).  Runs on the
        host stage worker in async mode (it waits on the copies' CUDA
        events), inline in sync mode and for the int8 tier on the GPU."""
        kv_merge: Dict[str, Tuple[int, Any, Any]] = {}
        for req_ids, prev, pending in parts:
            k, v = pending.wait()
            for i, rid in enumerate(req_ids):
                kv_merge[rid] = (prev[rid], k[i][:, None, :],
                                 None if v is None else v[i][:, None, :])
        for chunk_start, finish in finishers:
            for rid, (k, v) in finish().items():
                cur = kv_merge.get(rid)
                if cur is None:
                    kv_merge[rid] = (chunk_start, k, v)
                else:
                    # same-rid chunks of one layer are contiguous in plan
                    # order: extend the stripe along tokens
                    s0, k0, v0 = cur
                    kv_merge[rid] = (s0, torch.cat([k0, k], dim=1),
                                     None if v is None
                                     else torch.cat([v0, v], dim=1))
        if kv_merge:
            self.kv_mgr.save_new_tokens_fused(lidx, kv_merge)
            self.kv_mgr.flush_fused(lidx, list(kv_merge))

    def _stage_decode_layer(self, worker: Optional[HostStageWorker],
                            layer: int, selections: List[Tuple],
                            pending_evict: Dict[str, set],
                            sel_pairs: Dict[str, List[Tuple[int, int]]],
                            fused: bool = False) -> int:
        """The decode half of one layer's host stage, between its select
        and attend: the LRU round for every (plane, {req_id: host
        selection (Hkv, K)}), at most ONE merged FlashH2D of the misses
        (behind ``worker.fence``: the layer's write-back must be in DRAM
        first, as a 1-block LRU can miss on the block the token was just
        appended to) restored into the slots BEFORE the attention, then the
        deferred eviction drop and the ``staged_probe`` hook.  ``fused``:
        the selections of a finished fused forward (``_account_selections``)
        — the restores land AFTER it, on a plane of None they are
        discarded, and drops and probe are the caller's.  Returns the
        blocks loaded."""
        lidx = self._layer_to_lidx[layer]
        drop = self.eng.drop_evicted_device_blocks
        merged_missing: Dict[str, List[int]] = {}
        rounds = []
        for plane, sel_by_req in selections:
            blocks_by_req: Dict[str, List[int]] = {}
            for rid, sel in sel_by_req.items():
                blocks = dsa_mod.selected_block_ids(sel)
                blocks_by_req[rid] = blocks
                sel_pairs[rid].extend((lidx, x) for x in blocks)
            missing_by_req, evicted_by_req = self.kv_mgr.access_layer(
                lidx, blocks_by_req, drain_evicted=drop)
            for rid, ev in evicted_by_req.items():
                pending_evict[rid].update(ev)
            merged_missing.update(missing_by_req)
            rounds.append((plane, blocks_by_req, missing_by_req))
        loads = sum(len(m) for m in merged_missing.values())
        if merged_missing:
            self._staged_layer_bytes[layer] = (
                self._staged_layer_bytes.get(layer, 0)
                + loads * self._offload_block_bytes)
            if worker is not None:
                worker.fence(lidx)
            payloads = self.kv_mgr.load_blocks_fused(lidx, merged_missing)
            if self.eng.decode_write_back:
                for plane, _, missing_by_req in rounds:
                    if plane is not None and missing_by_req:
                        plane.restore_blocks_fused(
                            layer, {rid: (missing_by_req[rid], k, v)
                                    for rid, (k, v) in payloads.items()
                                    if rid in missing_by_req},
                            before_use=not fused)
        if fused:
            return loads
        for plane, blocks_by_req, _ in rounds:
            req_ids = list(blocks_by_req)
            if drop:
                # blocks the imminent attend selected stay until the next
                # stage boundary
                self._drop_pending_evictions(
                    plane, req_ids, pending_evict,
                    protect=(lidx, blocks_by_req))
            if self.staged_probe is not None:
                if worker is not None:
                    worker.fence(lidx)   # probes compare device and host
                self.staged_probe(self, plane, layer,
                                  [self.states[r] for r in req_ids],
                                  blocks_by_req)
        return loads

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    @staticmethod
    def _decode_group_key(st: _ReqState) -> Tuple:
        """Requests batch together when their decode state's ``extra``
        agrees in every shape but batch (Whisper's encoder length); pool
        block counts may differ (padded to the plane's)."""
        return tuple((tuple(x.shape[1:]), str(x.dtype)) for x in
                     M.extra_leaves(st.decode_state.get("extra") or {}))

    def _decode_groups(self, decode_reqs: List[Request]
                       ) -> Dict[Tuple, List[_ReqState]]:
        """The plan's decode requests by group key, in plan order."""
        groups: Dict[Tuple, List[_ReqState]] = {}
        for req in decode_reqs:
            st = self.states[req.req_id]
            if st.group_key is None:
                st.group_key = self._decode_group_key(st)
            groups.setdefault(st.group_key, []).append(st)
        return groups

    def _plane_for(self, key: Tuple, sts: List[_ReqState]
                   ) -> DevicePoolPlane:
        """Admit any of ``sts`` not yet resident into the decode plane of
        group ``key`` — the only full-pool copy in a request's decode
        lifetime; the plane owns the state afterwards."""
        plane = self._decode_plane(key)
        for st in sts:
            rid = st.req.req_id
            if rid not in plane.rows:
                plane.admit(rid, st.decode_state)
                st.decode_state = None
                self._req_plane[rid] = plane
        return plane

    def _sample(self, st: _ReqState) -> int:
        logits = st.last_logits.numpy()[0]
        if self.eng.greedy:
            return int(np.argmax(logits))
        z = logits - logits.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self.rng.choice(len(p), p=p))

    def _decode_epilogue(self, plane: DevicePoolPlane,
                         sts: List[_ReqState], logits: torch.Tensor,
                         pending_evict: Dict[str, set],
                         sel_pairs: Dict[str, List[Tuple[int, int]]]
                         ) -> None:
        """After a step over ``plane`` (staged or persistent): the drops
        deferred past their own attend, then sample each row (reading the
        logits is a stream sync: the int8 save's kernels, which write the
        pinned pools in place, are done before any release drops one) and
        feed the working-set estimator."""
        self.decode_step_calls += 1
        self.decode_tokens += len(sts)
        if self.eng.drop_evicted_device_blocks:
            self._drop_pending_evictions(
                plane, [st.req.req_id for st in sts], pending_evict)
        host_logits = logits.float().cpu()
        for st in sts:
            row = plane.rows[st.req.req_id]
            st.last_logits = host_logits[row:row + 1]
            st.out_tokens.append(self._sample(st))
        self._observe_selections(sts, sel_pairs)

    def _observe_selections(self, sts: List[_ReqState],
                            sel_pairs: Dict[str, List[Tuple[int, int]]]
                            ) -> None:
        """Feed each request's (layer, block) selections of the step to
        the scheduler's working-set estimator."""
        for st in sts:
            if sel_pairs[st.req.req_id]:
                self.scheduler.observe_selection(st.req,
                                                 sel_pairs[st.req.req_id])

    def _decode_batch_staged(self, key: Tuple, sts: List[_ReqState]
                             ) -> None:
        """The split path's decode: the staged per-layer pipeline over the
        device plane (``DevicePoolPlane.step_staged``); between a layer's
        select and attend the stage callback saves the layer's new KV (one
        fused FlashD2H, on the worker in async mode) and runs the decode
        host stage (``_stage_decode_layer``)."""
        plane = self._plane_for(key, sts)
        tok_by_req = {st.req.req_id: st.out_tokens[-1] for st in sts}
        req_ids = list(tok_by_req)
        sel_pairs: Dict[str, List[Tuple[int, int]]] = \
            {rid: [] for rid in req_ids}
        pending_evict: Dict[str, set] = {rid: set() for rid in req_ids}
        worker = self._stage_worker() if self._stage_async else None

        def stage_cb(layer: int, sel: Optional[np.ndarray],
                     prev: Dict[str, int]) -> None:
            # in async mode this is the dispatch window: nothing in it may
            # wait for the device (on the GPU a sync there raises)
            with dispatch_window(self.device, armed=worker is not None):
                if self.eng.decode_write_back:
                    pending = plane.new_token_kv_async(
                        req_ids, prev, [layer], self.kv_mgr.ship)[layer]
                    self._stage_writeback(worker, self._layer_to_lidx[layer],
                                          [(req_ids, dict(prev), pending)],
                                          [])
                if sel is not None:
                    self._stage_decode_layer(
                        worker, layer,
                        [(plane, {rid: sel[plane.rows[rid]]
                                  for rid in req_ids})],
                        pending_evict, sel_pairs)

        logits, _info, _prev = plane.step_staged(self.params, tok_by_req,
                                                 stage_cb)
        if worker is not None:
            # iteration fence: every write-back has landed before sampling
            # and before a release can retire a DRAM pool
            worker.drain()
        self._decode_epilogue(plane, sts, logits, pending_evict, sel_pairs)

    def _decode_batch_persistent(self, key: Tuple,
                                 sts: List[_ReqState]) -> int:
        """The fused plane: ONE forward over the device plane's padded
        rows (``DevicePoolPlane.step``), then the write-back of the step's
        KV (one fused FlashD2H per layer), the selections' restores,
        which land in the device slots AFTER the forward that selected
        them, and the staged plane's epilogue.  Returns blocks loaded."""
        plane = self._plane_for(key, sts)
        tok_by_req = {st.req.req_id: st.out_tokens[-1] for st in sts}
        logits, info, prev = plane.step(self.params, tok_by_req)
        if self.eng.decode_write_back:
            self._write_back_new_kv(plane, list(tok_by_req), prev)
        loads, evicted, sel_pairs = self._account_selections(
            sts, info["selected"], plane=plane)
        self._decode_epilogue(plane, sts, logits, evicted, sel_pairs)
        return loads

    def _write_back_new_kv(self, plane: DevicePoolPlane, req_ids: List[str],
                           prev: Dict[str, int]) -> None:
        """FlashD2H decode save of the fused plane: the step's appended KV
        of every attention layer, one fused save and flush per layer (in
        the int8 tier one ``quant_save_blocks`` call), keeping DRAM a
        superset of device KV."""
        payload = plane.new_token_kv(req_ids, prev,
                                     sorted(self._lidx_to_layer.values()),
                                     self.kv_mgr.ship)
        for l, (k, v) in payload.items():
            lidx = self._layer_to_lidx[l]
            self.kv_mgr.save_new_tokens_fused(lidx, {
                rid: (prev[rid], k[i][:, None, :],
                      None if v is None else v[i][:, None, :])
                for i, rid in enumerate(req_ids)})
            self.kv_mgr.flush_fused(lidx, req_ids)

    def _device_state(self, st: _ReqState) -> Dict:
        """The request's own decode state with ``cur_len`` on the engine's
        device (prefill leaves it on the host, where the plane's admission
        reads it)."""
        state = st.decode_state
        if state["cur_len"].device != self.device:
            state["cur_len"] = state["cur_len"].to(self.device)
        return state

    def _decode_batch(self, sts: List[_ReqState]) -> int:
        """The ``"stacked"`` path: ONE batched forward over a padded pool
        stacked from every request's own pools and unstacked after it, a
        copy of every pool twice per step (the equivalence oracle of the
        persistent plane).  Returns blocks loaded."""
        toks = host_to_device([st.out_tokens[-1] for st in sts],
                              self.device)
        batched, layout = M.stack_decode_states(
            [self._device_state(st) for st in sts])
        self.stack_calls += 1
        logits, new_state, info = M.decode_step(
            self.params, self.cfg, toks, batched, return_info=True)
        self.decode_step_calls += 1
        self.decode_tokens += len(sts)
        host_logits = logits.float().cpu()
        for row, (st, ns) in enumerate(
                zip(sts, M.unstack_decode_states(new_state, layout))):
            st.decode_state = ns
            st.last_logits = host_logits[row:row + 1]
            st.out_tokens.append(self._sample(st))
        loads, _, sel_pairs = self._account_selections(sts, info["selected"])
        self._observe_selections(sts, sel_pairs)
        return loads

    def _decode_one(self, st: _ReqState) -> int:
        """``batched_decode=False``: one B=1 forward over the request's own
        pools, then its selections' accounting.  Returns blocks loaded."""
        toks = host_to_device([st.out_tokens[-1]], self.device)
        logits, new_state, info = M.decode_step(
            self.params, self.cfg, toks, self._device_state(st),
            return_info=True)
        self.decode_step_calls += 1
        self.decode_tokens += 1
        st.decode_state = new_state
        st.last_logits = logits.float().cpu()
        st.out_tokens.append(self._sample(st))
        loads, _, sel_pairs = self._account_selections([st],
                                                       info["selected"])
        self._observe_selections([st], sel_pairs)
        return loads

    def _account_selections(self, sts: List[_ReqState],
                            selected: Dict[int, torch.Tensor],
                            plane: Optional[DevicePoolPlane] = None
                            ) -> Tuple[int, Dict[str, set],
                                       Dict[str, List[Tuple[int, int]]]]:
        """A fused forward's DSA selections, layer by layer, through the
        host stage's decode half (``_stage_decode_layer``, ``fused``): LRU
        residency and ONE fused FlashH2D load of each layer's misses.
        ``selected[l]`` is (B, Hkv, K); batch row b is ``sts[b]`` unless
        ``plane`` is given, whose rows it then follows and whose slots the
        payloads land in (after the forward: the persistent plane).
        Without a plane (the sequential and stacked paths) the payloads
        are discarded, as the reference discards them: their pools never
        lose a block.  Returns (blocks loaded, the evicted (layer, block)
        keys and the (layer, block) selections, each by request)."""
        sel_pairs: Dict[str, List[Tuple[int, int]]] = \
            {st.req.req_id: [] for st in sts}
        evicted: Dict[str, set] = {st.req.req_id: set() for st in sts}
        loads = 0
        rows = [b if plane is None else plane.rows[st.req.req_id]
                for b, st in enumerate(sts)]
        for l in sorted(selected):
            sel = selected[l].cpu().numpy()
            loads += self._stage_decode_layer(
                None, l, [(plane, {st.req.req_id: sel[r]
                                   for st, r in zip(sts, rows)})],
                evicted, sel_pairs, fused=True)
        return loads, evicted, sel_pairs

    def _drop_pending_evictions(self, plane: DevicePoolPlane,
                                req_ids: List[str],
                                pending: Dict[str, set],
                                protect: Optional[Tuple[int, Dict[str, List[int]]]] = None
                                ) -> None:
        """Physically zero LRU-evicted blocks on the device, mutating
        ``pending`` ((KV layer, block) keys per request) in place.  A key is
        skipped when the block is LRU-resident again, or kept pending when
        ``protect`` = (lidx, blocks_by_req) marks it as selected by the
        attention about to run.  The round's drops, every request and
        layer, go to the plane at once (one launch on the GPU)."""
        round_: Dict[Tuple[str, int], List[int]] = {}
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
                round_[(rid, self._lidx_to_layer[elidx])] = sorted(set(blks))
            pending[rid] = keep
        plane.drop_blocks_many(round_)

    # ------------------------------------------------------------------
    # Async host stage
    # ------------------------------------------------------------------
    def _stage_worker(self) -> HostStageWorker:
        """The engine's host-stage worker, created lazily (and again after
        ``close()``)."""
        if self._worker is None or self._worker.closed:
            self._worker = HostStageWorker(name=f"host-stage-{id(self):x}",
                                           tracer=self.tracer)
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
    def _legacy_or_chunked_prefill(self, prefill_reqs
                                   ) -> Tuple[float, List[Request], int]:
        """The per-request prefill executors: the legacy layer-segmented
        loop (whole layers; the scheduler's token-layer cursor decides how
        many run) or the chunked baseline.  Returns (modelled seconds,
        finished requests, HBM footprint in token-layer units)."""
        L = self.cfg.num_layers
        t = 0.0
        done: List[Request] = []
        fp = 0
        for req, inject in prefill_reqs:
            st = self.states[req.req_id]
            if req.scheduled_time is None:
                req.scheduled_time = self.now
            if self.eng.prefill_mode == "layer_segmented":
                if st.lp is None:
                    self._start_layer_segmented(st, req.prompt_len)
                # advance the cursor by `inject` token-layers, at least one
                # whole layer, then run segments to catch up with it
                req.prefill_layer_tokens_done += max(inject, req.prompt_len)
                while (req.prefill_layer_tokens_done >= req.prompt_len
                       and req.prefill_layer < L):
                    req.prefill_layer += 1
                    req.prefill_layer_tokens_done -= req.prompt_len
                finished = ran = False
                while (st.lp is not None and not finished
                       and st.lp.next_idx < req.prefill_layer):
                    finished = self._run_layer_segment(st)
                    ran = True
                    t += cm.batched_prefill_time(
                        self.hw, self.mc,
                        [(req.prompt_len, req.prompt_len)], layers=1)
                if ran:
                    # the whole layer's KV is live while a segment runs
                    fp += hbm_footprint_tokens(req.prompt_len,
                                               "layer_segmented", L)
            else:
                finished = self._run_chunked_prefill(st, inject)
                t += cm.prefill_time(self.hw, self.mc, inject,
                                     req.prefill_tokens_done)
                fp += hbm_footprint_tokens(req.prompt_len, "chunked", L,
                                           req.prefill_tokens_done)
            if finished:
                done.append(req)
        return t, done, fp

    def step(self) -> Optional[BatchPlan]:
        """Run ONE engine iteration.  Returns the executed plan, or None
        when no work remains.  Order: admit arrivals -> schedule
        (Algorithm 1) -> the mixed layer walk, or on the split path the
        prefill executor then the decode path -> sample -> finish/release
        -> charge time."""
        self._admit_arrivals()
        plan = self.scheduler.schedule()
        if not plan.decode_reqs and not plan.prefill_reqs:
            if self._pending:      # idle until the next arrival
                self.now = max(self.now, self._pending[0].arrival_time)
                return self.step()
            return None
        t0 = time.perf_counter()
        self._staged_layer_bytes = {}
        L = self.cfg.num_layers
        mixed = self.hybrid is not None
        iter_loads = 0
        t_prefill = 0.0
        prefill_by_layer: Optional[List[float]] = None
        if mixed:
            # decode sampling and the prefill epilogue ran inside
            prefill_done, iter_prefill_fp, prefill_by_layer = \
                self._mixed_iteration(plan)
        elif self._plane_prefill:
            t_prefill, prefill_done, iter_prefill_fp = \
                self._prefill_plane_iteration(plan.prefill_reqs)
        else:
            t_prefill, prefill_done, iter_prefill_fp = \
                self._legacy_or_chunked_prefill(plan.prefill_reqs)
        # chunked prefill keeps every processed token's KV of all layers
        # resident between iterations too: count unscheduled holders
        scheduled = {req.req_id for req, _ in plan.prefill_reqs}
        for st in self.states.values():
            if st.chunk_ctx is not None and st.req.req_id not in scheduled:
                iter_prefill_fp += hbm_footprint_tokens(
                    st.req.prompt_len, "chunked", L,
                    st.req.prefill_tokens_done)
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

        decode_sts = [self.states[req.req_id] for req in plan.decode_reqs]
        if mixed or not decode_sts:
            pass
        elif not self.eng.batched_decode:
            for st in decode_sts:
                iter_loads += self._decode_one(st)
        else:
            # one batched forward per group (several only where the
            # requests' extra shapes differ: Whisper's encoder lengths)
            for key, sts in self._decode_groups(plan.decode_reqs).items():
                if self.eng.decode_plane == "staged":
                    self._decode_batch_staged(key, sts)
                elif self.eng.decode_plane == "persistent":
                    iter_loads += self._decode_batch_persistent(key, sts)
                else:
                    iter_loads += self._decode_batch(sts)
        for req in plan.decode_reqs:
            req.generated += 1
            req.token_times.append(self.now)
            if req.generated >= req.max_new_tokens:
                req.finish_time = self.now
                self.scheduler.finish_request(req)
                self.kv_mgr.release(req.req_id)
                plane = self._req_plane.pop(req.req_id, None)
                if plane is not None:
                    plane.release(req.req_id)

        if self.eng.charge_real_time:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_iter = time.perf_counter() - t0
        else:
            attended = (min(self.cfg.dsa.token_budget, 1 << 30)
                        if self.cfg.dsa.enabled else 4096)
            staged_bytes = [self._staged_layer_bytes.get(l, 0)
                            for l in range(L)]
            n_dec = len(plan.decode_reqs)
            if mixed:
                # one shared walk: per layer, the union of decode and
                # prefill compute overlaps the ONE fused transfer stage
                t_iter = cm.mixed_iteration_time(
                    self.hw, self.mc, n_dec, attended, staged_bytes,
                    prefill_time_by_layer=prefill_by_layer)
            elif (n_dec and self.eng.batched_decode
                    and self.eng.decode_plane == "staged"):
                # staged pipeline: per layer, restores overlap compute
                t_iter = cm.overlapped_decode_time(
                    self.hw, self.mc, n_dec, attended,
                    staged_bytes) + t_prefill
            else:
                t_dec = (cm.decode_time(self.hw, self.mc, n_dec, attended)
                         if n_dec else 0.0)
                t_load = (cm.fused_transfer_time(
                    self.hw, iter_loads * self._offload_block_bytes)
                    if iter_loads else 0.0)
                t_iter = t_dec + t_load + t_prefill
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
        # obs epilogue: after the planes and the worker have returned and,
        # when the wall clock is charged, after the device sync above, so
        # the span covers the iteration's device work
        wall_s = time.perf_counter() - t0
        self._h_iter.observe(wall_s)
        waiting, running = self.scheduler.queue_depths()
        self._g_queue.set(waiting)
        self._g_running.set(running)
        self._g_batch_decode.set(len(plan.decode_reqs))
        self._g_batch_prefill.set(len(plan.prefill_reqs))
        self._g_ws_decode.set(plan.ws_decode_bytes)
        self._g_ws_prefill.set(plan.ws_prefill_bytes)
        self._g_hbm_used.set(self.kv_mgr.hbm_used_bytes())
        if self.tracer.enabled:
            self.tracer.complete_at(
                "iteration", "engine", t0, wall_s, i=self.iterations - 1,
                decode_rows=len(plan.decode_reqs),
                prefill_rows=len(plan.prefill_reqs))
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

    # ------------------------------------------------------------------
    # Observability surface (repro_torch.obs)
    # ------------------------------------------------------------------
    def _stage_planes(self) -> List[Any]:
        """The planes that time a host stage: the decode planes and the
        mixed walk."""
        return list(self.planes.values()) + (
            [self.hybrid] if self.hybrid is not None else [])

    def metrics_snapshot(self) -> Dict[str, float]:
        """One flat dict over every subsystem's counters, under the
        reference's keys: the registry's instruments (``sched.*`` gauges,
        ``kv.hbm_used_bytes``, the ``engine.iteration_s`` histogram) and
        reads of the counters where the hot paths keep them.  Works with
        obs off.  ``plane.trace_count`` (the reference's jit traces) is
        0: the port compiles nothing per shape."""
        self._g_hbm_used.set(self.kv_mgr.hbm_used_bytes())
        snap = self.metrics.snapshot()
        ts = self.kv_mgr.total_stats()
        w = self._worker
        live = w is not None and not w.closed
        planes = list(self.planes.values())

        def total(field: str) -> float:
            return float(sum(getattr(p, field) for p in planes))
        snap.update({
            "kv.h2d_calls": float(ts.h2d_calls),
            "kv.h2d_blocks": float(ts.h2d_blocks),
            "kv.h2d_bytes": float(ts.h2d_bytes),
            "kv.d2h_calls": float(ts.d2h_calls),
            "kv.d2h_blocks": float(ts.d2h_blocks),
            "kv.d2h_bytes": float(ts.d2h_bytes),
            "kv.hits": float(ts.hits),
            "kv.misses": float(ts.misses),
            "kv.evictions": float(ts.evictions),
            "kv.hbm_budget_bytes": float(self.eng.hbm_budget_bytes),
            "kv.offload_block_bytes": float(self._offload_block_bytes),
            "engine.iterations": float(self.iterations),
            "engine.now_s": float(self.now),
            "engine.decode_step_calls": float(self.decode_step_calls),
            "engine.decode_tokens": float(self.decode_tokens),
            "engine.stack_calls": float(self.stack_calls),
            "engine.prefill_launches": float(self.prefill_launches),
            "engine.admit_embed_launches": float(self.admit_embed_launches),
            "engine.prefill_hbm_peak_tokens":
                float(self.prefill_hbm_peak_tokens),
            # the reference makes a plane at its group's first decode
            "plane.count": float(sum(p.state is not None for p in planes)),
            "plane.steps": total("steps"),
            "plane.host_syncs": total("host_syncs"),
            "plane.d2h_readback_bytes": total("d2h_readback_bytes"),
            "plane.blocks_dropped": total("blocks_dropped"),
            "plane.blocks_restored": total("blocks_restored"),
            "plane.blocks_restored_before_use":
                total("blocks_restored_before_use"),
            "plane.trace_count": 0.0,
            "plane.dispatch_sync_s": sum(x.dispatch_sync_s
                                         for x in self._stage_planes()),
            "plane.host_stage_s": sum(x.host_stage_s
                                      for x in self._stage_planes()),
            "worker.jobs_run": float(self.worker_jobs_run
                                     + (w.jobs_run if live else 0)),
            "worker.busy_s": (self.worker_busy_s
                              + (w.busy_s if live else 0.0)),
            "obs.enabled": 1.0 if self.tracer.enabled else 0.0,
            "obs.trace_events": float(len(self.tracer.events())),
        })
        return snap

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of :meth:`metrics_snapshot`."""
        snap = self.metrics_snapshot()
        reg_keys = set(self.metrics.snapshot())
        return self.metrics.prometheus_text(
            {k: v for k, v in snap.items() if k not in reg_keys})

    def stage_overlap_measured(self) -> Optional[float]:
        """Counter instrument of the async host stage's overlap: the share
        of host-stage work that ran on the worker thread, ``busy_s /
        (busy_s + the planes' host_stage_s)``.  None when no worker job
        ran (sync mode, or no staged decode)."""
        w = self._worker
        busy = self.worker_busy_s + (w.busy_s if w is not None
                                     and not w.closed else 0.0)
        if busy <= 0.0:
            return None
        stage_s = sum(x.host_stage_s for x in self._stage_planes())
        return busy / (busy + stage_s)

    def stage_overlap_from_trace(self) -> Optional[float]:
        """Trace instrument of the same overlap: the worker lane's
        host-stage spans intersected with the iteration spans
        (``obs.trace_analysis``).  None with obs off or no worker span."""
        if not self.tracer.enabled:
            return None
        return achieved_overlap_fraction(self.tracer.events())

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (empty when obs is off)."""
        return self.tracer.chrome_trace()

    def dump_trace(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path`` (blocking file I/O:
        call it between or after iterations); returns the event count."""
        return self.tracer.dump_trace(path)
