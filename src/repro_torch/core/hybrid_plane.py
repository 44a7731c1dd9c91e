"""Unified hybrid-batching plane — prefill + decode in ONE mixed iteration.

Counterpart of ``repro/core/hybrid_plane.py``.  ``HybridPlane.run_iteration``
walks the model's layers ONCE per engine iteration, carrying every decode
plane's staged pipeline AND every prefill plane's same-(layer, chunk)
segment groups together.  Per attention layer *i*:

1. decode ``select`` runs for every decode plane (append + metadata update
   in place, ``block_score`` + top-k), and the selected ids are copied to
   the host: ``idx.cpu()``, the ONE device sync of the layer;
2. the layer's prefill groups run (``PrefillPlane.run_layer``);
3. ONE ``layer_cb(win)`` fires — the single per-layer host stage, where
   the engine merges decode write-back and fresh prefill KV into one fused
   FlashD2H, runs the LRU round, and restores misses into the decode
   pools BEFORE the attention that selected them;
4. decode ``attend`` runs for every decode plane over the restored pools
   (the ``sparse_decode_attention`` kernel on the GPU), each with its own
   plane's cross keys and values (Whisper's ``enc_kvs``: planes of
   different encoder lengths ride one walk).

A hybrid's Mamba layer, and each of RWKV6's layers, is one stage: every
decode plane runs it over its rows' recurrent states (no select, no
``idx`` copy), the layer's prefill groups run beside it, and ``layer_cb``
fires for those groups only (with ``kind`` "mamba" or "rwkv": no KV to
save), so an RWKV6 decode step runs no host stage.

After the walk each decode plane takes its logits stage and each prefill
plane its shared finalize.  With a live tracer the walk emits the
reference's spans per layer: ``select`` (the selects and their ``idx``
copies, whose time also goes to ``dispatch_sync_s``), ``host-stage``
around ``layer_cb`` (its time also goes to ``host_stage_s``) and
``attend``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_pool import DevicePoolPlane
from repro_torch.core.prefill_plane import (PrefillGroupRun,
                                            PrefillIterationResult,
                                            PrefillPlane, PrefillWalk)
from repro_torch.models import model as M
from repro_torch.obs.tracing import NULL_TRACER


@dataclasses.dataclass
class DecodeJob:
    """One decode group's work for the mixed iteration."""
    plane: DevicePoolPlane
    token_by_req: Dict[str, int]


@dataclasses.dataclass
class PrefillJob:
    """One prefill plane's scheduled allowance for the mixed iteration."""
    plane: PrefillPlane
    allowance: Dict[str, int]


@dataclasses.dataclass
class DecodeRun:
    """In-flight staged state of one decode plane during the layer walk."""
    plane: DevicePoolPlane
    req_ids: List[str]
    mask: torch.Tensor
    x: torch.Tensor
    prev: Dict[str, int]
    info: Dict[str, Any]
    q: Any = None
    idx: Any = None
    valid: Any = None


@dataclasses.dataclass
class LayerWindow:
    """What ONE per-layer host stage sees: the layer's kind ("attn",
    "mamba" or "rwkv"), every decode plane's selection for this layer
    (host int32 arrays (B_cap, Hkv, K); none at a recurrent layer) plus
    every prefill group that just ran here."""
    layer: int
    kind: str
    selections: List[Tuple[DecodeRun, Optional[np.ndarray]]]
    groups: List[Tuple[PrefillPlane, PrefillGroupRun]]


@dataclasses.dataclass
class MixedIterationResult:
    decode: List[Tuple[DevicePoolPlane, torch.Tensor, Dict, Dict[str, int]]]
    prefill: List[Tuple[PrefillPlane, PrefillIterationResult]]


class HybridPlane:
    """Mixed-iteration driver over the decode and prefill planes; it owns
    only the per-iteration layer walk."""

    def __init__(self, cfg):
        self.cfg = cfg
        # last iteration's (layer, idx_sync_s, host_stage_s) per layer_cb,
        # and their sums over every iteration: the counter half of the
        # overlap cross-check (the spans reuse the same reads)
        self.stage_timeline: List[Tuple[int, float, float]] = []
        self.dispatch_sync_s = 0.0
        self.host_stage_s = 0.0
        self.tracer = NULL_TRACER     # the engine installs a live Tracer
                                      # when obs is on

    def run_iteration(self, params: Dict, decode_jobs: List[DecodeJob],
                      prefill_jobs: List[PrefillJob],
                      layer_cb=None) -> MixedIterationResult:
        """Walk layers 0..L-1 once; ``layer_cb(win)`` fires exactly once
        per layer that has a selection or a prefill group, between the
        layer's selects/prefill launches and its decode attends."""
        cfg = self.cfg
        dec: List[DecodeRun] = []
        for job in decode_jobs:
            plane = job.plane
            tokens, mask = plane.batch_inputs(job.token_by_req)
            dec.append(DecodeRun(
                plane=plane, req_ids=list(job.token_by_req), mask=mask,
                x=M.decode_embed(params, cfg, tokens),
                prev={rid: plane.cur_host[rid] for rid in job.token_by_req},
                info={"selected": {}}))
            plane.stage_launches += 1
        pre: List[Tuple[PrefillPlane, PrefillWalk]] = [
            (pj.plane, pj.plane.begin_iteration(pj.allowance))
            for pj in prefill_jobs]
        timeline: List[Tuple[int, float, float]] = []
        tr = self.tracer
        for i in range(cfg.num_layers):
            p = M.get_layer(params, i)
            kind = M.layer_kind(cfg, i)
            selections: List[Tuple[DecodeRun, Optional[np.ndarray]]] = []
            t_sync = 0.0
            for d in dec:
                # the layer's recurrent stage, or its select and attend
                d.plane.stage_launches += 1 if kind != "attn" else 2
            if kind != "attn":
                for d in dec:
                    st = d.plane.state
                    d.x, st["caches"][i] = M.decode_recurrent_layer(
                        p, cfg, kind, d.x, st["caches"][i], d.mask)
            elif dec:
                if tr.enabled:
                    _ts = time.perf_counter()
                for d in dec:
                    st = d.plane.state
                    d.q, _, d.idx, d.valid = M.decode_select_layer(
                        p, cfg, d.x, st["caches"][i], st["cur_len"],
                        step_mask=d.mask)
                    if d.idx is not None:
                        d.info["selected"][i] = d.idx
                        d.plane.host_syncs += 1
                    # the ONE host sync of the layer: it waits for select_i
                    # (and the still-queued attend_{i-1}) before the host
                    # stage runs
                    t0 = time.perf_counter()
                    selections.append(
                        (d, None if d.idx is None else d.idx.cpu().numpy()))
                    t_sync += time.perf_counter() - t0
                if tr.enabled:
                    tr.end("select", "stage", _ts, layer=i, planes=len(dec))
            layer_groups: List[Tuple[PrefillPlane, PrefillGroupRun]] = []
            for plane, walk in pre:
                for g in plane.run_layer(params, i, walk):
                    layer_groups.append((plane, g))
            if layer_cb is not None and (selections or layer_groups):
                t1 = time.perf_counter()
                layer_cb(LayerWindow(layer=i, kind=kind,
                                     selections=selections,
                                     groups=layer_groups))
                t2 = time.perf_counter()
                timeline.append((i, t_sync, t2 - t1))
                if tr.enabled:
                    # the same t1/t2 as the timeline entry: the trace and
                    # the counter instruments share the measurement
                    tr.complete_at("host-stage", "host-stage", t1,
                                   t2 - t1, layer=i,
                                   groups=len(layer_groups))
            if kind != "attn":
                continue
            if tr.enabled and dec:
                _ts = time.perf_counter()
            for d in dec:
                st = d.plane.state
                d.x = M.decode_attend_layer(
                    p, cfg, d.x, d.q, st["caches"][i], st["cur_len"],
                    d.idx, d.valid,
                    M.index_enc_kvs(st["extra"].get("enc_kvs"), i))
            if tr.enabled and dec:
                tr.end("attend", "stage", _ts, layer=i, planes=len(dec))
        self.stage_timeline = timeline
        for _, sync_s, stage_s in timeline:
            self.dispatch_sync_s += sync_s
            self.host_stage_s += stage_s
        out_dec = []
        for d in dec:
            st = d.plane.state
            logits, st["cur_len"] = M.decode_logits(params, cfg, d.x,
                                                    st["cur_len"], d.mask)
            d.plane.stage_launches += 1
            d.plane.finish_step(d.req_ids)
            out_dec.append((d.plane, logits, d.info, d.prev))
        out_pre = [(plane, plane.finish_iteration(params, walk))
                   for plane, walk in pre]
        return MixedIterationResult(decode=out_dec, prefill=out_pre)
