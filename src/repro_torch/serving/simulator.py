"""Discrete-event serving simulator (the paper's section 4 experiments
on the cost model), a copy of the reference package's
``repro/serving/simulator.py`` over the port's own scheduler, KV
geometry, LRU HBM cache, cost model, metrics and requests; numpy only.

Replays a request trace through the full SparseServe control plane —
FCFS hybrid batching, Algorithm-1 working-set admission, LRU HBM caching,
layer-segmented prefill — advancing simulated time by the analytic cost
model (``costmodel.py``), under any of its ``HardwareSpec``s: the
reference's ``A100_40G`` (the paper's testbed, the default) and
``TPU_V5E``, and the port's ``H100_80G``.  Its times are the model's,
not measurements of any device.  The systems ladder matches the paper:

    vllm        full attention, chunked prefill, KV resident in HBM
    vllm-s      + dynamic sparse attention (SA)          [still resident]
    vllm-so     + KV offloading to DRAM, memcpy transfers
    +ft         + fragmentation-aware transfer (FlashH2D/D2H)
    +wc         + working-set-aware batch size control
    +lp         + layer-segmented prefill  == sparseserve

Block-selection traces are synthesized with the temporal locality the paper
measures (Fig. 8): each step keeps a block from the previous selection with
probability ``p_keep`` and always includes sink+recent blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.kv_cache import HBMCache, KVGeometry
from repro_torch.core.scheduler import BatchPlan, Scheduler, SchedulerConfig
from repro_torch.serving import costmodel as cm
from repro_torch.serving.metrics import ServingMetrics, compute_metrics
from repro_torch.serving.request import Phase, Request


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str
    sparse_attention: bool = False
    offload: bool = False
    fragmentation_aware: bool = False
    ws_control: bool = False
    layer_segmented: bool = False


SYSTEMS: Dict[str, SystemConfig] = {
    "vllm": SystemConfig("vllm"),
    "vllm-s": SystemConfig("vllm-s", sparse_attention=True),
    "vllm-so": SystemConfig("vllm-so", sparse_attention=True, offload=True),
    "vllm-so+ft": SystemConfig("vllm-so+ft", sparse_attention=True,
                               offload=True, fragmentation_aware=True),
    "vllm-so+ft+wc": SystemConfig("vllm-so+ft+wc", sparse_attention=True,
                                  offload=True, fragmentation_aware=True,
                                  ws_control=True),
    "sparseserve": SystemConfig("sparseserve", sparse_attention=True,
                                offload=True, fragmentation_aware=True,
                                ws_control=True, layer_segmented=True),
}


@dataclasses.dataclass
class SimConfig:
    block_size: int = 32
    token_budget: int = 2048
    window: int = 12
    p_keep: float = 0.95            # selection temporal locality: the paper
                                    # (Fig. 8) and the reference's engine
                                    # replica (its benchmarks/bench_overlap.py)
                                    # both measure ~95% overlap with the
                                    # window-12 union, which is what the LRU
                                    # cache sees
    chunk_size: int = 2048
    r_max: int = 64
    t_max: int = 4096
    hbm_reserve_frac: float = 0.10  # activations/workspace
    seed: int = 0
    max_sim_time: float = 36000.0


@dataclasses.dataclass
class _ReqSim:
    """Simulator-side per-request state."""
    req: Request
    prev_sel: Set[int] = dataclasses.field(default_factory=set)
    cache: Optional[HBMCache] = None


class ServingSimulator:
    def __init__(self, model_cfg, system: SystemConfig,
                 hw: cm.HardwareSpec = cm.A100_40G,
                 sim: Optional[SimConfig] = None):
        sim = SimConfig() if sim is None else sim
        self.cfg = model_cfg
        self.sys = system
        self.hw = hw
        self.sim = sim
        self.mc = cm.ModelCost.from_config(model_cfg)
        self.rng = np.random.default_rng(sim.seed)

        L = model_cfg.num_attention_layers()
        self.geom = KVGeometry(
            num_layers=max(L, 1),
            num_kv_heads=max(model_cfg.num_kv_heads, 1),
            block_size=sim.block_size,
            head_dim=model_cfg.kv_cache_dim,
            kv_factor=1 if model_cfg.attention_type == "mla" else 2)
        self.top_k = max(1, sim.token_budget // sim.block_size)

        hbm_free = hw.hbm_capacity * (1 - sim.hbm_reserve_frac) \
            - self.mc.param_bytes
        if hbm_free <= 0:
            raise ValueError("model does not fit in HBM")
        self.hbm_kv_budget = hbm_free

        prefill_mode = ("layer_segmented" if system.layer_segmented
                        else "chunked")
        self.scheduler = Scheduler(
            SchedulerConfig(
                r_max=sim.r_max, t_max=sim.t_max,
                m_avl_bytes=int(hbm_free) if system.ws_control else 0,
                prefill_mode=prefill_mode, chunk_size=sim.chunk_size,
                max_inject_tokens=sim.chunk_size * model_cfg.num_layers,
                ws_control=system.ws_control),
            self.geom, model_cfg.num_layers, self.top_k)

        # per-request LRU cache capacity: share of the HBM KV budget
        self._cache_blocks = max(
            self.top_k + 4,
            int(hbm_free / max(1, self.geom.block_bytes) / max(1, sim.r_max)))
        self.states: Dict[str, _ReqSim] = {}
        self.loads_per_iter: List[int] = []
        self.batch_sizes: List[int] = []
        self.decode_iter_time: float = 0.0   # last pure-decode iter (SLO ref)

    # ------------------------------------------------------------------
    def _resident_kv_bytes(self) -> float:
        """KV bytes pinned in HBM for non-offload systems."""
        tot = 0.0
        for st in self.states.values():
            r = st.req
            if r.phase == Phase.DECODE:
                tot += r.total_len * self.mc.kv_bytes_per_token
            elif r.phase == Phase.PREFILL:
                tot += r.prefill_tokens_done * self.mc.kv_bytes_per_token
        return tot

    def _admit_resident(self, plan: BatchPlan) -> BatchPlan:
        """vLLM-style HBM admission: a prefill may proceed only if its FULL
        prompt KV (+ current residency) fits — head-of-line blocking.
        Decode requests whose aggregate resident KV exceeds HBM are
        preempted (stalled) for the iteration, FCFS."""
        # decode residency cap (vLLM preemption when HBM overflows)
        ok_decode = []
        resident = 0.0
        for r in plan.decode_reqs:
            need = r.total_len * self.mc.kv_bytes_per_token
            if resident + need <= self.hbm_kv_budget:
                ok_decode.append(r)
                resident += need
        plan = BatchPlan(ok_decode, plan.prefill_reqs, rejected=plan.rejected)
        free = self.hbm_kv_budget - self._resident_kv_bytes()
        ok_prefills = []
        for req, inject in plan.prefill_reqs:
            need = ((req.prompt_len - req.prefill_tokens_done)
                    * self.mc.kv_bytes_per_token)
            if need <= free:
                ok_prefills.append((req, inject))
                free -= need
            else:
                # demote: back to waiting (blocked on HBM)
                if req.phase == Phase.PREFILL and req.prefill_tokens_done == 0:
                    req.phase = Phase.WAITING
                    if req in self.scheduler.running:
                        self.scheduler.running.remove(req)
                    if req not in self.scheduler.waiting:
                        self.scheduler.waiting.insert(0, req)
        return BatchPlan(plan.decode_reqs, ok_prefills,
                         rejected=plan.rejected)

    # ------------------------------------------------------------------
    def _synth_selection(self, st: _ReqSim) -> Set[int]:
        n_blocks = max(1, st.req.total_len // self.sim.block_size)
        k = min(self.top_k, n_blocks)
        forced = {0, max(0, n_blocks - 1), max(0, n_blocks - 2)}
        keep = {b for b in st.prev_sel
                if b < n_blocks and self.rng.random() < self.sim.p_keep}
        sel = set(sorted(forced | keep)[:k])
        while len(sel) < k:
            sel.add(int(self.rng.integers(n_blocks)))
        st.prev_sel = sel
        return sel

    # ------------------------------------------------------------------
    def _decode_cost(self, reqs: List[Request]) -> Tuple[float, int]:
        """Returns (iteration seconds, blocks loaded)."""
        if not reqs:
            return 0.0, 0
        L = self.geom.num_layers
        if self.sys.sparse_attention:
            attended = min(self.sim.token_budget,
                           int(np.mean([r.total_len for r in reqs])))
        else:
            attended = int(np.mean([r.total_len for r in reqs]))
        t = cm.decode_time(self.hw, self.mc, len(reqs), attended)
        self.decode_iter_time = t

        loads = 0
        t_load = 0.0
        if self.sys.offload:
            blk_bytes_all_layers = (self.geom.block_bytes_per_head
                                    * self.geom.num_kv_heads * L)
            per_head_bytes = self.geom.block_bytes_per_head
            # the HBM cache is SHARED: more running requests -> smaller
            # per-request share -> contention/thrashing (paper Fig. 1)
            share = max(4, int(self.hbm_kv_budget / blk_bytes_all_layers
                               / max(1, len(reqs))))
            for r in reqs:
                self.states[r.req_id].cache.capacity = share
            for r in reqs:
                st = self.states[r.req_id]
                sel = self._synth_selection(st)
                missing = st.cache.access(0, sorted(sel))
                # temporal locality is shared across layers (consecutive
                # queries select similar blocks in EVERY layer) — the working
                # set spans all L layers of the selected block ids.
                self.scheduler.observe_selection(
                    r, [(l, b) for l in range(L) for b in sel])
                if missing:
                    loads += len(missing) * L
                    mb = len(missing) * blk_bytes_all_layers
                    if self.sys.fragmentation_aware:
                        # one fused FlashH2D launch per layer
                        t_load += L * cm.fused_transfer_time(
                            self.hw, mb / L)
                    else:
                        # one memcpy per (block, head, layer)
                        n_copies = len(missing) * self.geom.num_kv_heads * L
                        t_load += cm.memcpy_transfer_time(
                            self.hw, n_copies, per_head_bytes)
        return t + t_load, loads

    def _prefill_cost(self, plan: BatchPlan) -> float:
        t = 0.0
        for req, inject in plan.prefill_reqs:
            if self.sys.layer_segmented:
                # one layer over `inject` prompt tokens (+ chunk split);
                # causal attention averages to prompt/2 context
                t_cmp = cm.prefill_time(self.hw, self.mc, inject,
                                        max(req.prompt_len // 2, 1), layers=1)
                if self.sys.offload:
                    save_bytes = inject * self.mc.kv_bytes_per_token \
                        / self.geom.num_layers
                    t_save = cm.fused_transfer_time(self.hw, save_bytes) \
                        if self.sys.fragmentation_aware else \
                        cm.memcpy_transfer_time(
                            self.hw,
                            max(1, inject // self.sim.block_size)
                            * self.geom.num_kv_heads,
                            self.geom.block_bytes_per_head)
                    t_cmp += max(0.0, t_save - t_cmp)  # async, may stall
            else:
                ctx = req.prefill_tokens_done + inject
                t_cmp = cm.prefill_time(self.hw, self.mc, inject, ctx)
                if self.sys.offload:
                    save_bytes = inject * self.mc.kv_bytes_per_token
                    t_save = cm.fused_transfer_time(self.hw, save_bytes) \
                        if self.sys.fragmentation_aware else \
                        cm.memcpy_transfer_time(
                            self.hw,
                            max(1, inject // self.sim.block_size)
                            * self.geom.num_kv_heads * self.geom.num_layers,
                            self.geom.block_bytes_per_head)
                    t_cmp += max(0.0, t_save - t_cmp)
            t += t_cmp
        return t

    # ------------------------------------------------------------------
    def _apply_progress(self, plan: BatchPlan, now: float) -> None:
        cfg = self.cfg
        for req, inject in plan.prefill_reqs:
            if req.scheduled_time is None:
                req.scheduled_time = now
            if self.sys.layer_segmented:
                req.prefill_layer_tokens_done += inject
                while (req.prefill_layer_tokens_done >= req.prompt_len
                       and req.prefill_layer < cfg.num_layers):
                    req.prefill_layer += 1
                    req.prefill_layer_tokens_done -= req.prompt_len
                done = req.prefill_layer >= cfg.num_layers
            else:
                req.prefill_tokens_done += inject
                done = req.prefill_tokens_done >= req.prompt_len
            if done:
                req.phase = Phase.DECODE
                req.first_token_time = now
                req.token_times.append(now)
                req.generated = 1
                req.prefill_tokens_done = req.prompt_len
        for req in plan.decode_reqs:
            req.generated += 1
            req.token_times.append(now)
            if req.generated >= req.max_new_tokens:
                req.finish_time = now
                self.scheduler.finish_request(req)
                self.states.pop(req.req_id, None)

    # ------------------------------------------------------------------
    def run(self, trace: List[Request]) -> ServingMetrics:
        pending = sorted(trace, key=lambda r: r.arrival_time)
        t = 0.0
        i_arr = 0
        n_total = len(pending)
        finished = 0
        while finished < n_total and t < self.sim.max_sim_time:
            while i_arr < n_total and pending[i_arr].arrival_time <= t:
                req = pending[i_arr]
                self.scheduler.add_request(req)
                st = _ReqSim(req)
                if self.sys.offload:
                    st.cache = HBMCache(
                        KVGeometry(self.geom.num_layers,
                                   self.geom.num_kv_heads,
                                   self.geom.block_size, self.geom.head_dim,
                                   kv_factor=self.geom.kv_factor),
                        self._cache_blocks)
                self.states[req.req_id] = st
                i_arr += 1

            plan = self.scheduler.schedule()
            if not self.sys.offload:
                plan = self._admit_resident(plan)
            if not plan.decode_reqs and not plan.prefill_reqs:
                if i_arr < n_total:
                    t = max(t, pending[i_arr].arrival_time)
                    continue
                break

            t_dec, loads = self._decode_cost(plan.decode_reqs)
            t_iter = t_dec + self._prefill_cost(plan)
            self.loads_per_iter.append(loads)
            t += max(t_iter, 1e-6)
            self.batch_sizes.append(len(plan.decode_reqs)
                                    + len(plan.prefill_reqs))
            self._apply_progress(plan, t)
            finished = sum(1 for r in pending if r.finish_time is not None)

        return compute_metrics(pending, max(t, 1e-9))
