"""Layer-segmented prefill planner (paper §3.4).

Prefill is divided into LAYER segments processed in separate hybrid batches.
After layer *l* runs over the whole prompt, its KV blocks are saved to DRAM
(FlashD2H) and immediately evicted from HBM — the prefill HBM footprint is
bounded by ONE layer of KV at all times.  The residual-stream activations
(B, S, d) are carried between iterations to resume at layer l+1.

If one layer over the whole prompt would exceed the TBT SLO, the layer is
further split into token chunks ("combination with chunked prefill") —
``plan_segments`` emits (layer, chunk) steps; chunk c of layer l attends to
chunks 0..c of the SAME layer, so the per-layer KV context is still bounded
to one layer.  The batched prefill plane (``repro.core.prefill_plane``)
executes these chunked segments (``EngineConfig.prefill_max_tokens_per_step``
sets the granularity); the legacy per-request executor runs whole layers
only, which is why the engine plans whole-layer segments for it.

``max_inject_tokens`` follows the paper's fairness convention (§4.2): to
inject the same total token work per iteration as chunked prefill with
chunk size B, set max_inject_tokens = B * L.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class PrefillSegment:
    layer: int
    chunk_start: int      # token offset within the prompt
    chunk_len: int
    is_last_chunk_of_layer: bool
    is_last: bool         # final segment of the whole prefill


def plan_segments(prompt_len: int, num_layers: int,
                  max_tokens_per_step: int) -> List[PrefillSegment]:
    """Static plan of all (layer, chunk) prefill steps for one request.

    max_tokens_per_step bounds the tokens processed in a single batch
    (derived from maxInjectToken / TBT SLO).  If >= prompt_len, each layer
    is one segment (pure layer-segmented prefill)."""
    chunk = min(max(1, max_tokens_per_step), prompt_len)
    n_chunks = math.ceil(prompt_len / chunk)
    segs: List[PrefillSegment] = []
    for l in range(num_layers):
        for c in range(n_chunks):
            start = c * chunk
            clen = min(chunk, prompt_len - start)
            segs.append(PrefillSegment(
                layer=l, chunk_start=start, chunk_len=clen,
                is_last_chunk_of_layer=(c == n_chunks - 1),
                is_last=(l == num_layers - 1 and c == n_chunks - 1)))
    return segs


@dataclasses.dataclass
class LayerPrefillState:
    """Mutable per-request execution cursor + carried activations.

    hidden: residual stream after the last completed layer (host-side
    between iterations; the paper saves activation states the same way)."""
    segments: List[PrefillSegment]
    next_idx: int = 0
    hidden: Optional[object] = None          # (B, S, d) array
    positions: Optional[object] = None
    enc_kvs: Optional[object] = None         # whisper cross-attn KV
    rec_states: Optional[list] = None        # mamba/rwkv per-layer states

    @property
    def done(self) -> bool:
        return self.next_idx >= len(self.segments)

    def peek(self) -> PrefillSegment:
        return self.segments[self.next_idx]

    def advance(self) -> PrefillSegment:
        seg = self.segments[self.next_idx]
        self.next_idx += 1
        return seg


def segment_tokens_for_iteration(prompt_len: int, num_layers: int,
                                 max_inject_tokens: int) -> int:
    """How many prompt tokens one iteration may process.

    Layer-segmented prefill touches `prompt_len` tokens per layer step but
    only ONE layer — its per-iteration compute equals prompt_len tokens of
    one layer.  Normalised to whole-model token work it is
    prompt_len / num_layers; the paper's maxInjectToken bounds exactly this
    so that layer-segmented and chunked prefill inject equal work."""
    whole_model_tokens = max(1, max_inject_tokens)
    per_layer_tokens = whole_model_tokens * num_layers
    return min(prompt_len, per_layer_tokens)


def hbm_footprint_tokens(prompt_len: int, mode: str, num_layers: int,
                         tokens_done: int = 0,
                         layer_tokens_resident: Optional[int] = None) -> int:
    """Token-layer units of KV ONE request holds in HBM during prefill
    (Fig. 16a rationale).

    chunked: every processed token's KV of ALL layers stays resident —
    ``tokens_done * num_layers``, growing with progress.

    layer_segmented: only the CURRENT layer's KV is resident — at most
    ``prompt_len`` token-layers (the one-layer bound).
    ``layer_tokens_resident`` is the measured number of prompt tokens whose
    KV of the current layer is live (the prefill plane reports its per-row
    within-iteration peak); omitted, the bound itself is returned (the
    legacy whole-layer executor holds exactly the full layer while a
    segment runs).

    The serving engine SUMS this over every request with live prefill state
    each iteration and maxes the sums into
    ``ServingEngine.prefill_hbm_peak_tokens`` — a real batched per-iteration
    watermark for both modes, not a per-request recording."""
    if mode == "chunked":
        return tokens_done * num_layers
    if layer_tokens_resident is None:
        return prompt_len
    return min(layer_tokens_resident, prompt_len)
