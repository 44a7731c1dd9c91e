"""Batched layer-segmented prefill plane (paper §3.4).

Counterpart of ``repro/core/prefill_plane.py`` for the mixed iteration.  A
request entering prefill is admitted ONCE into a padded row carrying its
residual stream (``hidden`` (B_cap, S_cap, d)); its segment plan
(``layer_prefill.plan_segments``) is the row's cursor.  Each engine
iteration walks the model's layers once (``begin_iteration`` ->
``run_layer`` per layer -> ``finish_iteration``): the rows whose next
segment sits at the layer are grouped by chunk start and each group runs as
ONE batched launch of ``model.prefill_attn_layer_batched`` over the padded
batch (a token mask marks real tokens, a step mask parks unscheduled rows).
The group's KV lands in the plane's one-layer context buffer
(``ctx_k``/``ctx_v``), from which the engine reads the fused FlashD2H save
(``read_group_kv(_async)``) and the end-of-layer pool build
(``layer_ctx``) — the prefill HBM footprint stays one layer of KV for the
whole batch.  Rows whose last segment ran share one logits launch.
Buffers are updated IN PLACE.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_pool import BucketingPolicy
from repro_torch.core.layer_prefill import PrefillSegment
from repro_torch.device import HostCopy, host_to_device
from repro_torch.models import model as M


def admit_embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """ONE embedding launch for a whole admission batch: tokens
    (n_cap, s_cap) padded ids -> (n_cap, s_cap, d)."""
    return params["embed"][tokens.long()]


@dataclasses.dataclass
class PrefillGroupRun:
    """One executed batched launch: every scheduled row whose next segment
    was (layer, chunk_start), padded to ``chunk_cap`` tokens."""
    layer: int
    chunk_start: int
    chunk_cap: int
    req_ids: List[str]
    segs: Dict[str, PrefillSegment]


@dataclasses.dataclass
class PrefillIterationResult:
    groups: List[PrefillGroupRun]
    finished: List[str]                     # rows whose LAST segment ran
    logits: Optional[torch.Tensor]          # (B_cap, V) when any finished
    peaks: Dict[str, int]                   # per-row peak resident KV tokens


@dataclasses.dataclass
class PrefillWalk:
    """Budget/progress state of ONE mixed-iteration walk over a plane."""
    allow: Dict[str, int]
    ran: set = dataclasses.field(default_factory=set)
    finished: List[str] = dataclasses.field(default_factory=list)
    peaks: Dict[str, int] = dataclasses.field(default_factory=dict)
    groups: List[PrefillGroupRun] = dataclasses.field(default_factory=list)


class PrefillPlane:
    """Persistent padded prefill state for a batch of requests."""

    def __init__(self, cfg, policy: Optional[BucketingPolicy] = None):
        self.cfg = cfg
        self.policy = policy or BucketingPolicy()
        self.b_cap = 0
        self.s_cap = 0
        self.hidden: Optional[torch.Tensor] = None    # (B_cap, S_cap, d)
        self.ctx_k: Optional[torch.Tensor] = None     # (B_cap, S_cap, Hkv, hd)
        self.ctx_v: Optional[torch.Tensor] = None
        self._tok_len: Optional[torch.Tensor] = None  # (B_cap,) int32
        self.rows: Dict[str, int] = {}
        self.tok_len: Dict[str, int] = {}             # host mirror
        self.segments: Dict[str, List[PrefillSegment]] = {}
        self.next_idx: Dict[str, int] = {}
        self._free: List[int] = []

    # -- capacity ----------------------------------------------------------

    @staticmethod
    def _padded(v: torch.Tensor, b_cap: int, s_cap: Optional[int] = None
                ) -> torch.Tensor:
        shape = list(v.shape)
        shape[0] = b_cap
        if s_cap is not None:
            shape[1] = s_cap
        out = v.new_zeros(shape)
        if s_cap is None:
            out[:v.shape[0]] = v
        else:
            out[:v.shape[0], :v.shape[1]] = v
        return out

    def _ensure_capacity(self, need_rows: int, need_tokens: int,
                         template_h: torch.Tensor) -> None:
        b_cap = max(self.b_cap, self.policy.bucket_batch(need_rows))
        s_cap = max(self.s_cap, self.policy.bucket_tokens(need_tokens))
        if self.hidden is None:
            self.hidden = template_h.new_zeros(
                (b_cap, s_cap, template_h.shape[-1]))
            self._tok_len = torch.zeros((b_cap,), dtype=torch.int32,
                                        device=template_h.device)
            self._free = list(range(b_cap))
        elif b_cap != self.b_cap or s_cap != self.s_cap:
            self.hidden = self._padded(self.hidden, b_cap, s_cap)
            self._tok_len = self._padded(self._tok_len, b_cap)
            if self.ctx_k is not None:
                self.ctx_k = self._padded(self.ctx_k, b_cap, s_cap)
                self.ctx_v = self._padded(self.ctx_v, b_cap, s_cap)
            for r in range(self.b_cap, b_cap):
                bisect.insort(self._free, r)
        self.b_cap, self.s_cap = b_cap, s_cap

    def _ensure_ctx(self) -> None:
        """Allocate the one-layer float32 KV context buffer."""
        if self.ctx_k is not None:
            return
        cfg = self.cfg
        shape = (self.b_cap, self.s_cap, cfg.num_kv_heads, cfg.head_dim)
        self.ctx_k = torch.zeros(shape, dtype=torch.float32,
                                 device=self.hidden.device)
        self.ctx_v = torch.zeros_like(self.ctx_k)

    # -- slot lifecycle ----------------------------------------------------

    def admit(self, req_id: str, h: torch.Tensor,
              segments: List[PrefillSegment]) -> int:
        """Copy one request's embedded residual stream (1, S, d) into a free
        row and install its segment plan."""
        if req_id in self.rows:
            raise ValueError(f"{req_id} already admitted")
        S = int(h.shape[1])
        self._ensure_capacity(len(self.rows) + 1, S, h)
        row = self._free.pop(0)
        self.hidden[row] = 0
        self.hidden[row, :S] = h[0]
        self._tok_len[row] = S
        self.rows[req_id] = row
        self.tok_len[req_id] = S
        self.segments[req_id] = list(segments)
        self.next_idx[req_id] = 0
        return row

    def release(self, req_id: str) -> int:
        row = self.rows.pop(req_id)
        self.tok_len.pop(req_id)
        self.segments.pop(req_id)
        self.next_idx.pop(req_id)
        bisect.insort(self._free, row)
        return row

    def done(self, req_id: str) -> bool:
        return self.next_idx[req_id] >= len(self.segments[req_id])

    # -- mixed-iteration walk (core.hybrid_plane) --------------------------

    def begin_iteration(self, allowance: Dict[str, int]) -> PrefillWalk:
        return PrefillWalk(allow={rid: int(a) for rid, a in allowance.items()
                                  if rid in self.rows})

    def run_layer(self, params: Dict, layer: int,
                  walk: PrefillWalk) -> List[PrefillGroupRun]:
        """Run every segment the walk owes at ``layer``: rows whose NEXT
        segment sits here, grouped by chunk start, one batched launch per
        group, chunks in plan order, until no scheduled row is pending
        here.  Every scheduled row runs at least one segment; beyond that,
        segments run while its token budget lasts."""
        out: List[PrefillGroupRun] = []
        while True:
            pending: Dict[int, List[str]] = {}
            for rid in sorted(walk.allow, key=lambda r: self.rows[r]):
                idx = self.next_idx[rid]
                segs = self.segments[rid]
                if idx >= len(segs):
                    continue
                if walk.allow[rid] <= 0 and rid in walk.ran:
                    continue
                seg = segs[idx]
                if seg.layer != layer:
                    continue
                pending.setdefault(seg.chunk_start, []).append(rid)
            if not pending:
                break
            for start in sorted(pending):
                rids = pending[start]
                g = self._run_group(params, layer, start, rids)
                out.append(g)
                walk.groups.append(g)
                for rid in rids:
                    seg = g.segs[rid]
                    walk.allow[rid] -= seg.chunk_len
                    walk.ran.add(rid)
                    self.next_idx[rid] += 1
                    walk.peaks[rid] = max(walk.peaks.get(rid, 0),
                                          seg.chunk_start + seg.chunk_len)
                    if seg.is_last:
                        walk.finished.append(rid)
        return out

    def finish_iteration(self, params: Dict,
                         walk: PrefillWalk) -> PrefillIterationResult:
        """Book idle residency into the peaks and run the shared logits
        launch for rows whose last segment ran."""
        for rid, resident in self.resident_tokens().items():
            walk.peaks[rid] = max(walk.peaks.get(rid, 0), resident)
        logits = None
        if walk.finished:
            logits = M.prefill_logits_batched(params, self.cfg, self.hidden,
                                              self._tok_len)
        return PrefillIterationResult(groups=walk.groups,
                                      finished=walk.finished,
                                      logits=logits, peaks=walk.peaks)

    def _run_group(self, params: Dict, layer: int, start: int,
                   rids: List[str]) -> PrefillGroupRun:
        cfg = self.cfg
        dev = self.hidden.device
        segs = {rid: self.segments[rid][self.next_idx[rid]] for rid in rids}
        t_cap = min(self.policy.bucket_tokens(
            max(s.chunk_len for s in segs.values())), self.s_cap - start)
        smask = np.zeros((self.b_cap,), bool)
        tmask = np.zeros((self.b_cap, t_cap), bool)
        for rid in rids:
            row = self.rows[rid]
            smask[row] = True
            tmask[row, :segs[rid].chunk_len] = True
        h_win = self.hidden[:, start:start + t_cap]
        pos_win = torch.arange(start, start + t_cap, dtype=torch.int32,
                               device=dev).expand(self.b_cap, t_cap)
        self._ensure_ctx()
        ctx_k = ctx_v = None
        if start > 0:
            ctx_k, ctx_v = self.ctx_k[:, :start], self.ctx_v[:, :start]
        h_out, (k, v) = M.prefill_attn_layer_batched(
            M.get_layer(params, layer), cfg, h_win, pos_win,
            host_to_device(tmask, dev, torch.bool),
            host_to_device(smask, dev, torch.bool),
            k_ctx=ctx_k, v_ctx=ctx_v, q_offset=start)
        rows = host_to_device([self.rows[r] for r in rids], dev, torch.int64)
        self.ctx_k[rows, start:start + t_cap] = k[rows].float()
        self.ctx_v[rows, start:start + t_cap] = v[rows].float()
        self.hidden[:, start:start + t_cap] = h_out
        return PrefillGroupRun(layer=layer, chunk_start=start,
                               chunk_cap=t_cap, req_ids=list(rids),
                               segs=segs)

    def resident_tokens(self) -> Dict[str, int]:
        """Per-row tokens of current-layer KV held between iterations
        (mid-layer chunk progress)."""
        out: Dict[str, int] = {}
        for rid in self.rows:
            idx = self.next_idx[rid]
            segs = self.segments[rid]
            out[rid] = segs[idx].chunk_start if idx < len(segs) else 0
        return out

    # -- data plane readbacks ---------------------------------------------

    def read_group_kv(self, g: PrefillGroupRun
                      ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """The KV stripes a group launch just produced, as host float32:
        {req_id: (k (Hkv, T, D), v)} trimmed to each row's chunk length."""
        return self.read_group_kv_async(g)()

    def read_group_kv_async(self, g: PrefillGroupRun):
        """Launch the group's stripe gather and its copy to pinned host
        memory without a host sync; returns a zero-arg finisher (run on
        the host stage worker) that waits for the copy and returns what
        ``read_group_kv`` would."""
        dev = self.hidden.device
        rows = host_to_device([self.rows[r] for r in g.req_ids], dev,
                              torch.int64)
        sl = slice(g.chunk_start, g.chunk_start + g.chunk_cap)
        pending = HostCopy(self.ctx_k[rows, sl], self.ctx_v[rows, sl])
        req_ids = list(g.req_ids)
        chunk_lens = {rid: g.segs[rid].chunk_len for rid in req_ids}

        def finish() -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
            k_all, v_all = pending.wait()              # (R, T, Hkv, hd)
            return {rid: (np.transpose(k_all[i, :chunk_lens[rid]], (1, 0, 2)),
                          np.transpose(v_all[i, :chunk_lens[rid]], (1, 0, 2)))
                    for i, rid in enumerate(req_ids)}
        return finish

    def layer_ctx(self, req_id: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The request's completed current-layer KV: (k, v) each
        (1, S, Hkv, hd) views of the context buffer."""
        row = self.rows[req_id]
        S = self.tok_len[req_id]
        return (self.ctx_k[row:row + 1, :S], self.ctx_v[row:row + 1, :S])
