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
   (the ``sparse_decode_attention`` kernel on the GPU).

After the walk each decode plane takes its logits stage and each prefill
plane its shared finalize.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_pool import DevicePoolPlane
from repro_torch.core.prefill_plane import (PrefillGroupRun,
                                            PrefillIterationResult,
                                            PrefillPlane, PrefillWalk)
from repro_torch.models import model as M


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
    """What ONE per-layer host stage sees: every decode plane's selection
    for this layer (host int32 arrays (B_cap, Hkv, K)) plus every prefill
    group that just ran here."""
    layer: int
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
        pre: List[Tuple[PrefillPlane, PrefillWalk]] = [
            (pj.plane, pj.plane.begin_iteration(pj.allowance))
            for pj in prefill_jobs]
        for i in range(cfg.num_layers):
            p = M.get_layer(params, i)
            selections: List[Tuple[DecodeRun, Optional[np.ndarray]]] = []
            for d in dec:
                st = d.plane.state
                d.q, _, d.idx, d.valid = M.decode_select_layer(
                    p, cfg, d.x, st["caches"][i], st["cur_len"],
                    step_mask=d.mask)
                if d.idx is not None:
                    d.info["selected"][i] = d.idx
                    d.plane.host_syncs += 1
                # the ONE host sync of the layer: it waits for select_i (and
                # the still-queued attend_{i-1}) before the host stage runs
                selections.append(
                    (d, None if d.idx is None else d.idx.cpu().numpy()))
            layer_groups: List[Tuple[PrefillPlane, PrefillGroupRun]] = []
            for plane, walk in pre:
                for g in plane.run_layer(params, i, walk):
                    layer_groups.append((plane, g))
            if layer_cb is not None and (selections or layer_groups):
                layer_cb(LayerWindow(layer=i, selections=selections,
                                     groups=layer_groups))
            for d in dec:
                st = d.plane.state
                d.x = M.decode_attend_layer(p, cfg, d.x, d.q,
                                            st["caches"][i], st["cur_len"],
                                            d.idx, d.valid)
        out_dec = []
        for d in dec:
            st = d.plane.state
            logits, st["cur_len"] = M.decode_logits(params, cfg, d.x,
                                                    st["cur_len"], d.mask)
            d.plane.finish_step(d.req_ids)
            out_dec.append((d.plane, logits, d.info, d.prev))
        out_pre = [(plane, plane.finish_iteration(params, walk))
                   for plane, walk in pre]
        return MixedIterationResult(decode=out_dec, prefill=out_pre)
