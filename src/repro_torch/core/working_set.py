"""Working-set estimation (paper §3.3).

Decode: the working set of a request is the union of KV blocks it selected
over the last ``w`` decode steps (w=12 by default — Fig. 8 shows the overlap
ratio plateaus there).  Prefill: computed exactly — full-prompt KV for
chunked prefill, ONE layer of KV for layer-segmented prefill.
"""
from __future__ import annotations

import collections
from typing import Deque, FrozenSet, Iterable, Optional, Set, Tuple

from repro_torch.core.kv_cache import KVGeometry


class DecodeWorkingSet:
    """Sliding-window union of selected (layer, block) ids for one request."""

    def __init__(self, geom: KVGeometry, window: int = 12):
        self.geom = geom
        self.window = window
        self._hist: Deque[FrozenSet[Tuple[int, int]]] = collections.deque(
            maxlen=window)

    def observe(self, selected: Iterable[Tuple[int, int]]) -> None:
        """Record the (layer, block) selection of one decode step."""
        self._hist.append(frozenset(selected))

    def union(self) -> Set[Tuple[int, int]]:
        out: Set[Tuple[int, int]] = set()
        for s in self._hist:
            out |= s
        return out

    def size_blocks(self) -> int:
        return len(self.union())

    def size_bytes(self) -> int:
        per_lb = self.geom.block_bytes_per_head * self.geom.num_kv_heads
        return self.size_blocks() * per_lb

    def overlap_with_last(self, selected: Iterable[Tuple[int, int]]) -> float:
        """Fraction of `selected` already in the window union (Fig. 8)."""
        sel = set(selected)
        if not sel:
            return 1.0
        return len(sel & self.union()) / len(sel)


def estimate_decode_ws_bytes(ws: DecodeWorkingSet, geom: KVGeometry,
                             top_k_blocks: int, num_layers: int) -> int:
    """Working set estimate for the NEXT step: history union if available,
    else the worst case (top-k fresh blocks for every layer).

    ``num_layers`` must be the ATTENTION-layer count: recurrent (mamba/rwkv)
    layers hold no paged KV, so counting them would make Algorithm 1
    over-throttle hybrid (jamba-style) batches in the cold-start worst case.
    """
    per_lb = geom.block_bytes_per_head * geom.num_kv_heads
    if ws.size_blocks() == 0:
        return top_k_blocks * num_layers * per_lb
    return ws.size_bytes()


def estimate_prefill_ws_bytes(geom: KVGeometry, prompt_tokens: int,
                              mode: str,
                              num_attn_layers: Optional[int] = None) -> int:
    """Exact prefill working set (§3.3 "Prefill working set").

    chunked: KV of ALL attention layers of the whole prompt must stay in
    HBM.  layer_segmented: bounded to ONE layer (previous layers evicted to
    DRAM).

    The layer multiplier is the ATTENTION-layer count — recurrent layers
    produce no paged KV.  ``geom.num_layers`` already carries that count
    when the geometry was built from ``cfg.num_attention_layers()`` (the
    engine and simulator both do); ``num_attn_layers`` overrides it for
    callers whose geometry tracks all model layers.
    """
    per_token_layer = (geom.head_dim * geom.dtype_bytes * geom.kv_factor
                       * geom.num_kv_heads)
    L = geom.num_layers if num_attn_layers is None else num_attn_layers
    if mode == "chunked":
        return prompt_tokens * per_token_layer * L
    elif mode == "layer_segmented":
        return prompt_tokens * per_token_layer
    raise ValueError(f"unknown prefill mode {mode!r}")
