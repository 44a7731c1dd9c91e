"""Batched layer-segmented prefill plane (paper §3.4).

Counterpart of ``repro/core/prefill_plane.py``.  A
request entering prefill is admitted ONCE into a padded row carrying its
residual stream (``hidden`` (B_cap, S_cap, d)); its segment plan
(``layer_prefill.plan_segments``) is the row's cursor.  In the mixed
iteration the engine walks the model's layers once (``begin_iteration``
-> ``run_layer`` per layer -> ``finish_iteration``): the rows whose next
segment sits at the layer are grouped by chunk start.  On the split path
``run_iteration`` runs the plane alone, in passes that group the rows'
next segments by (layer, chunk start).  Each group runs as
ONE batched launch of ``model.prefill_attn_layer_batched`` over the padded
batch (a token mask marks real tokens, a step mask parks unscheduled rows).
The group's KV lands in the plane's one-layer context buffer
(``ctx_k``/``ctx_v``; an MLA plane holds its latent as one head in
``ctx_k`` and has no ``ctx_v``, and runs whole-layer segments only, as
the reference's does), from which the engine reads the fused FlashD2H save
(``read_group_kv_async``, ``read_group_kv``) and the end-of-layer pool build
(``layer_ctx``) — the prefill HBM footprint stays one layer of KV for the
whole batch.  Rows whose last segment ran share one logits launch.
For Whisper each row also carries its per-layer cross keys and values
(``enc``), which every launch of the layer passes on; requests share a
plane only where those shapes agree (the engine keys its planes so).
For a hybrid (or RWKV6) each row carries every recurrent layer's state
(``rec``, zeroed at admission): a Mamba or RWKV layer's group runs
``model.prefill_recurrent_layer_batched`` over the bucketed window and
carries the states (parked rows unchanged), writes no KV, and
``rec_state`` reads a row's states back at finalize.
Buffers are updated IN PLACE.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_pool import BucketingPolicy
from repro_torch.core.layer_prefill import PrefillSegment
from repro_torch.device import host_to_device
from repro_torch.models import model as M
from repro_torch.obs.tracing import NULL_TRACER


def admit_embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """ONE embedding launch for a whole admission batch: tokens
    (n_cap, s_cap) padded ids -> (n_cap, s_cap, d)."""
    return params["embed"][tokens.long()]


@dataclasses.dataclass
class PrefillGroupRun:
    """One executed batched launch: every scheduled row whose next segment
    was (layer, chunk_start), padded to ``chunk_cap`` tokens."""
    layer: int
    kind: str                               # "attn" | "mamba"
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
    """Budget/progress state of ONE iteration over a plane."""
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
        self.ctx_v: Optional[torch.Tensor] = None     # None for MLA
        # Whisper: per layer (k, v) each (B_cap, S_enc, Hkv, hd)
        self.enc: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        # per layer: a recurrent layer's rows' states ({"conv", "ssm"} or
        # {"shift_t", "shift_c", "S"}), or None
        self.rec: Optional[List[Optional[Dict[str, torch.Tensor]]]] = None
        self._tok_len: Optional[torch.Tensor] = None  # (B_cap,) int32
        self.rows: Dict[str, int] = {}
        self.tok_len: Dict[str, int] = {}             # host mirror
        self.segments: Dict[str, List[PrefillSegment]] = {}
        self.next_idx: Dict[str, int] = {}
        self._free: List[int] = []
        self.stage_launches = 0       # group launches and finalizes, total
        self.tracer = NULL_TRACER     # the engine installs a live Tracer
                                      # when obs is on

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
            self.rec = M._init_rec_states(self.cfg, b_cap, template_h.dtype,
                                          template_h.device)
            self._free = list(range(b_cap))
        elif b_cap != self.b_cap or s_cap != self.s_cap:
            self.hidden = self._padded(self.hidden, b_cap, s_cap)
            self._tok_len = self._padded(self._tok_len, b_cap)
            if self.ctx_k is not None:
                self.ctx_k = self._padded(self.ctx_k, b_cap, s_cap)
            if self.ctx_v is not None:
                self.ctx_v = self._padded(self.ctx_v, b_cap, s_cap)
            if self.enc is not None:
                self.enc = [tuple(self._padded(a, b_cap) for a in kv)
                            for kv in self.enc]
            self.rec = [None if st is None else
                        {key: self._padded(v, b_cap) for key, v in st.items()}
                        for st in self.rec]
            for r in range(self.b_cap, b_cap):
                bisect.insort(self._free, r)
        self.b_cap, self.s_cap = b_cap, s_cap

    def _ensure_ctx(self) -> None:
        """Allocate the one-layer float32 KV context buffer: K and V of
        (Hkv, hd) per token, or MLA's latent as one head of
        ``kv_cache_dim``."""
        if self.ctx_k is not None:
            return
        cfg = self.cfg
        mla = cfg.attention_type == "mla"
        shape = (self.b_cap, self.s_cap, 1 if mla else cfg.num_kv_heads,
                 cfg.kv_cache_dim)
        self.ctx_k = torch.zeros(shape, dtype=torch.float32,
                                 device=self.hidden.device)
        if not mla:
            self.ctx_v = torch.zeros_like(self.ctx_k)

    # -- slot lifecycle ----------------------------------------------------

    def admit(self, req_id: str, h: torch.Tensor,
              segments: List[PrefillSegment],
              enc_kvs: Optional[List[Tuple[torch.Tensor,
                                           torch.Tensor]]] = None) -> int:
        """Copy one request's embedded residual stream (1, S, d), and its
        per-layer cross keys and values (Whisper, each (1, S_enc, Hkv,
        hd)), into a free row, zero the row's recurrent states and install
        its segment plan."""
        if req_id in self.rows:
            raise ValueError(f"{req_id} already admitted")
        S = int(h.shape[1])
        self._ensure_capacity(len(self.rows) + 1, S, h)
        row = self._free.pop(0)
        self.hidden[row] = 0
        self.hidden[row, :S] = h[0]
        for st in self.rec:
            if st is not None:
                for v in st.values():
                    v[row] = 0
        if enc_kvs is not None:
            if self.enc is None:
                self.enc = [tuple(a.new_zeros((self.b_cap,) + a.shape[1:])
                                  for a in kv) for kv in enc_kvs]
            for dst, src in zip(self.enc, enc_kvs):
                for d, s_ in zip(dst, src):
                    d[row] = s_[0]
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

    # -- iteration: run_iteration alone, or the mixed walk's run_layer ----

    def begin_iteration(self, allowance: Dict[str, int]) -> PrefillWalk:
        return PrefillWalk(allow={rid: int(a) for rid, a in allowance.items()
                                  if rid in self.rows})

    def run_iteration(self, params: Dict, allowance: Dict[str, int],
                      group_cb=None) -> PrefillIterationResult:
        """One engine iteration of prefill on its own (the split path).
        Every scheduled row runs at least one segment; beyond that,
        segments run while its token budget lasts.  Each pass groups the
        rows' next segments by (layer, chunk_start), one batched launch per
        group in that order, so a row's segments run in plan order.
        ``group_cb(group)`` runs right after each launch: the window in
        which the group's KV is read out of the one-layer context buffer,
        before a later layer's launch overwrites it."""
        walk = self.begin_iteration(allowance)
        while True:
            pending = self._pending(walk)
            if not pending:
                break
            for layer, start in sorted(pending):
                g = self._launch(params, layer, start,
                                 pending[(layer, start)], walk)
                if group_cb is not None:
                    group_cb(g)
        return self.finish_iteration(params, walk)

    def _pending(self, walk: PrefillWalk) -> Dict[Tuple[int, int],
                                                  List[str]]:
        """{(layer, chunk_start): rows} of the next segment each scheduled
        row still owes this iteration, rows in row order."""
        pending: Dict[Tuple[int, int], List[str]] = {}
        for rid in sorted(walk.allow, key=lambda r: self.rows[r]):
            idx = self.next_idx[rid]
            segs = self.segments[rid]
            if idx >= len(segs):
                continue
            if walk.allow[rid] <= 0 and rid in walk.ran:
                continue
            seg = segs[idx]
            pending.setdefault((seg.layer, seg.chunk_start), []).append(rid)
        return pending

    def _launch(self, params: Dict, layer: int, start: int,
                rids: List[str], walk: PrefillWalk) -> PrefillGroupRun:
        """Run one group and advance its rows' cursors and budgets."""
        g = self._run_group(params, layer, start, rids)
        walk.groups.append(g)
        for rid in rids:
            seg = g.segs[rid]
            walk.allow[rid] -= seg.chunk_len
            walk.ran.add(rid)
            self.next_idx[rid] += 1
            if g.kind == "attn":
                # only attention layers hold paged KV
                walk.peaks[rid] = max(walk.peaks.get(rid, 0),
                                      seg.chunk_start + seg.chunk_len)
            if seg.is_last:
                walk.finished.append(rid)
        return g

    def run_layer(self, params: Dict, layer: int,
                  walk: PrefillWalk) -> List[PrefillGroupRun]:
        """Run every segment the walk owes at ``layer``: rows whose NEXT
        segment sits here, grouped by chunk start, one batched launch per
        group, chunks in plan order, until no scheduled row is pending
        here.  Every scheduled row runs at least one segment; beyond that,
        segments run while its token budget lasts."""
        out: List[PrefillGroupRun] = []
        while True:
            pending = {start: rids for (l, start), rids
                       in self._pending(walk).items() if l == layer}
            if not pending:
                break
            for start in sorted(pending):
                out.append(self._launch(params, layer, start,
                                        pending[start], walk))
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
            self.stage_launches += 1
        return PrefillIterationResult(groups=walk.groups,
                                      finished=walk.finished,
                                      logits=logits, peaks=walk.peaks)

    def _run_group(self, params: Dict, layer: int, start: int,
                   rids: List[str]) -> PrefillGroupRun:
        cfg = self.cfg
        kind = M.layer_kind(cfg, layer)
        self.stage_launches += 1
        t_start = time.perf_counter() if self.tracer.enabled else None
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
        if kind != "attn":
            self.hidden[:, start:start + t_cap], self.rec[layer] = \
                M.prefill_recurrent_layer_batched(
                    M.get_layer(params, layer), cfg, kind, h_win,
                    host_to_device(tmask, dev, torch.bool),
                    host_to_device(smask, dev, torch.bool), self.rec[layer])
            return self._group_run(layer, kind, start, t_cap, rids, segs,
                                   t_start)
        pos_win = torch.arange(start, start + t_cap, dtype=torch.int32,
                               device=dev).expand(self.b_cap, t_cap)
        self._ensure_ctx()
        ctx_k = ctx_v = None
        if start > 0:
            if cfg.attention_type == "mla":
                raise NotImplementedError(
                    "chunked layer segments are not supported for MLA "
                    "models (no latent-context attention path); plan "
                    "whole-layer segments")
            ctx_k, ctx_v = self.ctx_k[:, :start], self.ctx_v[:, :start]
        h_out, (k, v) = M.prefill_attn_layer_batched(
            M.get_layer(params, layer), cfg, h_win, pos_win,
            host_to_device(tmask, dev, torch.bool),
            host_to_device(smask, dev, torch.bool),
            k_ctx=ctx_k, v_ctx=ctx_v, q_offset=start,
            enc_kv=None if self.enc is None else self.enc[layer])
        rows = host_to_device([self.rows[r] for r in rids], dev, torch.int64)
        self.ctx_k[rows, start:start + t_cap] = k[rows].float()
        if v is not None:
            self.ctx_v[rows, start:start + t_cap] = v[rows].float()
        self.hidden[:, start:start + t_cap] = h_out
        return self._group_run(layer, kind, start, t_cap, rids, segs,
                               t_start)

    def _group_run(self, layer: int, kind: str, start: int, t_cap: int,
                   rids: List[str], segs: Dict[str, PrefillSegment],
                   t_start: Optional[float]) -> PrefillGroupRun:
        """The launched group's record, and its span when ``t_start``
        (the tracer is on)."""
        if t_start is not None:
            self.tracer.end("prefill-group", "prefill", t_start,
                            layer=layer, chunk_start=start, chunk_cap=t_cap,
                            rows=len(rids), kind=kind)
        return PrefillGroupRun(layer=layer, kind=kind, chunk_start=start,
                               chunk_cap=t_cap, req_ids=list(rids),
                               segs=segs)

    def resident_tokens(self) -> Dict[str, int]:
        """Per-row tokens of current-layer attention KV held between
        iterations (mid-layer chunk progress): a row whose next segment is
        a chunk of an attention layer holds the chunks before it; one
        parked before a recurrent layer holds none."""
        out: Dict[str, int] = {}
        for rid in self.rows:
            idx = self.next_idx[rid]
            segs = self.segments[rid]
            out[rid] = (segs[idx].chunk_start if idx < len(segs)
                        and M.layer_kind(self.cfg, segs[idx].layer) == "attn"
                        else 0)
        return out

    def rec_state(self, req_id: str, layer: int) -> Dict[str, torch.Tensor]:
        """One row's recurrent state of ``layer`` (B = 1 copies), for the
        decode state built at finalize."""
        row = self.rows[req_id]
        return {key: v[row:row + 1].clone()
                for key, v in self.rec[layer].items()}

    def device_bytes(self) -> int:
        """Bytes of the plane's device buffers: the residual stream, the
        one-layer context, the recurrent states and the encoder KV."""
        leaves = [self.hidden, self.ctx_k, self.ctx_v, self._tok_len]
        leaves += [v for st in self.rec or () if st is not None
                   for v in st.values()]
        leaves += [a for kv in self.enc or () for a in kv]
        return sum(t.numel() * t.element_size()
                   for t in leaves if t is not None)

    # -- data plane readbacks ---------------------------------------------

    def read_group_kv_async(self, g: PrefillGroupRun, ship):
        """Launch the gather of the KV stripes a group launch just produced
        and hand it to ``ship`` (``KVCacheManager.ship``) without a host
        sync; returns a zero-arg finisher (run on the host stage worker)
        that waits for it and returns {req_id: (k (Hkv, T, D), v or None)}
        float32, trimmed to each row's chunk length."""
        dev = self.hidden.device
        rows = host_to_device([self.rows[r] for r in g.req_ids], dev,
                              torch.int64)
        sl = slice(g.chunk_start, g.chunk_start + g.chunk_cap)
        pending = ship(self.ctx_k[rows, sl], None if self.ctx_v is None
                       else self.ctx_v[rows, sl])
        req_ids = list(g.req_ids)
        chunk_lens = {rid: g.segs[rid].chunk_len for rid in req_ids}

        def stripe(x, i, rid):                         # (R, T, Hkv, hd)
            return (None if x is None
                    else x[i, :chunk_lens[rid]].permute(1, 0, 2))

        def finish() -> Dict[str, Tuple[torch.Tensor, Any]]:
            k_all, v_all = pending.wait()
            return {rid: (stripe(k_all, i, rid), stripe(v_all, i, rid))
                    for i, rid in enumerate(req_ids)}
        return finish

    def read_group_kv(self, g: PrefillGroupRun, ship
                      ) -> Dict[str, Tuple[torch.Tensor, Any]]:
        """``read_group_kv_async`` waited for: {req_id: (k (Hkv, T, D),
        v or None)} float32 where ``ship`` put them."""
        return self.read_group_kv_async(g, ship)()

    def layer_ctx(self, req_id: str) -> Tuple[torch.Tensor, Any]:
        """The request's completed current-layer KV, as ``layer_forward``
        gives it: (k, v) each (1, S, Hkv, hd) views of the context buffer,
        or MLA's (latent (1, S, 1, lat + rope), None)."""
        row = self.rows[req_id]
        S = self.tok_len[req_id]
        return (self.ctx_k[row:row + 1, :S], None if self.ctx_v is None
                else self.ctx_v[row:row + 1, :S])
