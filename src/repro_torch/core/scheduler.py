"""Request scheduler: FCFS continuous batching + hybrid batches +
working-set-aware batch size control (paper §3.3, Algorithm 1).

The base scheduler builds an initial candidate batch under the classic
constraints R_max (requests/batch) and T_max (tokens/batch).  SparseServe
adds M_avl — the available HBM cache capacity — and admits a request only
while the running sum of estimated working sets fits, rejecting (resetting)
the rest.  This prevents HBM cache thrashing: Fig. 1 shows throughput
COLLAPSING when aggregated working sets exceed HBM (21.36x more block loads
going from batch 6 to 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.kv_cache import KVGeometry
from repro_torch.core.working_set import (DecodeWorkingSet, estimate_decode_ws_bytes,
                                    estimate_prefill_ws_bytes)
from repro_torch.serving.request import Phase, Request


@dataclasses.dataclass
class SchedulerConfig:
    r_max: int = 64                 # max requests per batch
    t_max: int = 4096               # max tokens per batch
    m_avl_bytes: int = 0            # HBM cache capacity for Algorithm 1 (0 = off)
    prefill_mode: str = "layer_segmented"   # "chunked" | "layer_segmented"
    chunk_size: int = 2048          # chunked-prefill token chunk
    max_inject_tokens: int = 0      # layer-segmented: prefill tokens per batch
                                    # (0 -> chunk_size * num_layers, paper §4.2)
    segment_tokens: int = 0         # layer-segmented: intra-layer chunk size
                                    # (PrefillSegment granularity; 0 = whole
                                    # layers).  Injections are rounded to
                                    # whole segments so the scheduler charges
                                    # exactly the token work the batched
                                    # prefill plane will execute.
    ws_control: bool = True         # working-set-aware admission (WC)


@dataclasses.dataclass
class BatchPlan:
    """What to run this iteration."""
    decode_reqs: List[Request]
    prefill_reqs: List[Tuple[Request, int]]   # (request, tokens to inject)
    total_tokens: int = 0
    rejected: int = 0                          # WS-control rejections
    # Algorithm 1's arbitration record for the MIXED iteration: HBM bytes
    # the admitted decode rows' working sets claim vs the admitted prefill
    # rows' watermark claim (both from estimate_*_ws_bytes; 0 with WS
    # control off).  Their sum is what admission held under m_avl_bytes.
    ws_decode_bytes: int = 0
    ws_prefill_bytes: int = 0


class Scheduler:
    """FCFS hybrid-batching scheduler with Algorithm 1 admission."""

    def __init__(self, cfg: SchedulerConfig, geom: KVGeometry,
                 num_layers: int, top_k_blocks: int,
                 num_attn_layers: Optional[int] = None):
        """num_layers: MODEL layers (token-layer prefill budget).
        num_attn_layers: layers that hold paged KV — the multiplier the
        working-set estimators use.  Defaults to ``geom.num_layers`` (the
        geometry is attention-only in the engine and simulator); for hybrid
        models it must NOT be ``num_layers``, or Algorithm 1's cold-start
        worst case counts recurrent layers that cache nothing."""
        self.cfg = cfg
        self.geom = geom
        self.num_layers = num_layers
        self.num_attn_layers = (geom.num_layers if num_attn_layers is None
                                else num_attn_layers)
        self.top_k_blocks = top_k_blocks
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.working_sets: Dict[str, DecodeWorkingSet] = {}

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        self.waiting.append(req)

    def finish_request(self, req: Request) -> None:
        req.phase = Phase.FINISHED
        if req in self.running:
            self.running.remove(req)
        self.working_sets.pop(req.req_id, None)

    def observe_selection(self, req: Request,
                          selected: List[Tuple[int, int]]) -> None:
        ws = self.working_sets.setdefault(
            req.req_id, DecodeWorkingSet(self.geom, window=12))
        ws.observe(selected)

    def queue_depths(self) -> Tuple[int, int]:
        """(waiting, running) — the obs layer's queue-depth gauges."""
        return len(self.waiting), len(self.running)

    # ------------------------------------------------------------------
    def _estimate_ws(self, req: Request) -> int:
        """estimateWS(req) from Algorithm 1, line 9."""
        if req.phase == Phase.DECODE:
            ws = self.working_sets.setdefault(
                req.req_id, DecodeWorkingSet(self.geom, window=12))
            return estimate_decode_ws_bytes(ws, self.geom, self.top_k_blocks,
                                            self.num_attn_layers)
        # prefill (or waiting about to prefill)
        return estimate_prefill_ws_bytes(self.geom, req.prompt_len,
                                         self.cfg.prefill_mode,
                                         self.num_attn_layers)

    def _initial_batch(self) -> Tuple[List[Request], List[Tuple[Request, int]]]:
        """S.getBatch(R_max, T_max): FCFS decode-first hybrid batching."""
        cfg = self.cfg
        decode = [r for r in self.running if r.phase == Phase.DECODE]
        decode = decode[:cfg.r_max]
        tokens = len(decode)                      # 1 token per decode req
        prefills: List[Tuple[Request, int]] = []
        budget = (cfg.max_inject_tokens
                  if cfg.prefill_mode == "layer_segmented"
                  and cfg.max_inject_tokens > 0
                  else cfg.chunk_size)

        # continue in-flight prefills first, then admit waiting requests
        cand = [r for r in self.running if r.phase == Phase.PREFILL]
        cand += [r for r in self.waiting]
        for r in cand:
            if len(decode) + len(prefills) >= cfg.r_max:
                break
            if cfg.prefill_mode == "layer_segmented":
                # `budget` (maxInjectToken) counts TOKEN-LAYERS: one token
                # through ONE layer.  A chunked-prefill token is L
                # token-layers, so budget B*L == chunk size B (paper §4.2).
                # One iteration may process MULTIPLE layer segments until
                # the budget is consumed.
                if budget <= 0:
                    break
                remaining_total = ((self.num_layers - r.prefill_layer)
                                   * r.prompt_len
                                   - r.prefill_layer_tokens_done)
                inject = min(remaining_total, budget)
                if cfg.segment_tokens > 0:
                    # batched-segment charging: the prefill plane executes
                    # whole (layer, chunk) segments, so round the injection
                    # to segment multiples (at least one segment — the
                    # plane's progress guarantee) and charge that
                    seg = cfg.segment_tokens
                    inject = min(remaining_total,
                                 max(seg, (inject // seg) * seg))
                work = max(1, inject // max(1, self.num_layers))
                if tokens + work > cfg.t_max:
                    break
                tokens += work
            else:
                if tokens >= cfg.t_max:
                    break
                remaining = r.prompt_len - r.prefill_tokens_done
                inject = min(remaining, cfg.chunk_size, cfg.t_max - tokens)
                tokens += inject
            if inject <= 0:
                break
            prefills.append((r, inject))
            budget -= inject
        return decode, prefills

    def schedule(self) -> BatchPlan:
        """Algorithm 1: candidate batch -> WS-aware admission."""
        decode, prefills = self._initial_batch()
        if not self.cfg.ws_control or self.cfg.m_avl_bytes <= 0:
            plan = BatchPlan(decode, prefills)
        else:
            m_used = 0
            ws_d = ws_p = 0
            adm_d: List[Request] = []
            adm_p: List[Tuple[Request, int]] = []
            rejected = 0
            for req in decode:
                m_req = self._estimate_ws(req)
                if m_used + m_req <= self.cfg.m_avl_bytes:
                    adm_d.append(req)
                    m_used += m_req
                    ws_d += m_req
                else:
                    rejected += 1          # S.reset(req): stays queued
            for req, inject in prefills:
                m_req = self._estimate_ws(req)
                if m_used + m_req <= self.cfg.m_avl_bytes:
                    adm_p.append((req, inject))
                    m_used += m_req
                    ws_p += m_req
                else:
                    rejected += 1
            plan = BatchPlan(adm_d, adm_p, rejected=rejected,
                             ws_decode_bytes=ws_d, ws_prefill_bytes=ws_p)

        # promote admitted waiting requests to running/prefill
        for req, _ in plan.prefill_reqs:
            if req.phase == Phase.WAITING:
                req.phase = Phase.PREFILL
                self.waiting.remove(req)
                self.running.append(req)
        plan.total_tokens = (len(plan.decode_reqs)
                             + sum(t for _, t in plan.prefill_reqs))
        return plan
