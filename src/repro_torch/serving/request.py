"""Request lifecycle (vLLM-style) with SparseServe prefill progress state."""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional

_id_counter = itertools.count()


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    prompt_len: int
    max_new_tokens: int
    arrival_time: float = 0.0
    req_id: str = dataclasses.field(
        default_factory=lambda: f"req{next(_id_counter)}")
    phase: Phase = Phase.WAITING

    # --- prefill progress ---------------------------------------------------
    # chunked prefill: tokens processed so far
    prefill_tokens_done: int = 0
    # layer-segmented prefill: (layer, token-chunk-within-layer) cursor
    prefill_layer: int = 0
    prefill_layer_tokens_done: int = 0

    # --- decode progress ------------------------------------------------
    generated: int = 0

    # --- metrics ---------------------------------------------------------
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    scheduled_time: Optional[float] = None

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.generated

    def prefill_done(self, num_layers: int, mode: str) -> bool:
        if mode == "layer_segmented":
            return self.prefill_layer >= num_layers
        return self.prefill_tokens_done >= self.prompt_len

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tbts(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]
