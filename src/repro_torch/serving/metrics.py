"""Serving metrics: TTFT / TBT / token throughput / goodput (paper §4)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request

# A tail percentile needs a tail: np.percentile([x], 99) happily reports
# a one-sample "p99" (it is just x), which is noise presented as a tail
# bound.  Below this many samples the p99 fields are None — explicitly
# unmeasured, so callers must decide a policy (see ``meets_slo``) instead
# of silently consuming a fabricated number.
P99_MIN_SAMPLES = 10


def _p99(xs: List[float]) -> Optional[float]:
    if len(xs) < P99_MIN_SAMPLES:
        return None
    return float(np.percentile(xs, 99))


@dataclasses.dataclass
class ServingMetrics:
    mean_ttft: float
    p99_ttft: Optional[float]      # None below P99_MIN_SAMPLES samples
    mean_tbt: float
    p99_tbt: Optional[float]       # None below P99_MIN_SAMPLES samples
    token_throughput: float        # generated tokens / sec
    request_throughput: float
    mean_queue_delay: float
    total_time: float
    num_finished: int

    def row(self) -> str:
        return (f"ttft={self.mean_ttft:.3f}s tbt={self.mean_tbt*1e3:.1f}ms "
                f"tok/s={self.token_throughput:.1f} "
                f"req/s={self.request_throughput:.3f} "
                f"queue={self.mean_queue_delay:.3f}s")


def compute_metrics(reqs: List[Request], total_time: float) -> ServingMetrics:
    fin = [r for r in reqs if r.finish_time is not None]
    ttfts = [r.ttft() for r in fin if r.ttft() is not None]
    tbts = [t for r in fin for t in r.tbts()]
    qd = [r.scheduled_time - r.arrival_time for r in fin
          if r.scheduled_time is not None]
    tokens = sum(r.generated for r in fin)
    return ServingMetrics(
        mean_ttft=float(np.mean(ttfts)) if ttfts else float("nan"),
        p99_ttft=_p99(ttfts),
        mean_tbt=float(np.mean(tbts)) if tbts else float("nan"),
        p99_tbt=_p99(tbts),
        token_throughput=tokens / total_time if total_time > 0 else 0.0,
        request_throughput=len(fin) / total_time if total_time > 0 else 0.0,
        mean_queue_delay=float(np.mean(qd)) if qd else float("nan"),
        total_time=total_time,
        num_finished=len(fin),
    )


def meets_slo(reqs: List[Request], total_time: float, *,
              p99_tbt_limit: float, mean_queue_limit: float = 2.0,
              strict_p99: bool = False) -> bool:
    """Goodput SLO gate (paper Fig. 13): P99 TBT <= 25x a decode iteration
    and mean scheduling delay <= 2 s.

    Unmeasurable-tail policy, explicitly: when p99_tbt is None (fewer
    than ``P99_MIN_SAMPLES`` TBT samples — see ``compute_metrics``) or
    NaN, the default is to PASS the p99 gate — the gate fails only on
    *measured* violations, matching the old NaN behavior but now by
    stated choice rather than by ``not np.isnan(...)`` accident.  Pass
    ``strict_p99=True`` to invert that: a batch too small to measure its
    tail fails the gate.  ``mean_queue_delay`` keeps the same
    measured-violations-only treatment (NaN passes).
    """
    m = compute_metrics(reqs, total_time)
    if m.num_finished == 0:
        return False
    p99 = m.p99_tbt
    if p99 is None or np.isnan(p99):
        if strict_p99:
            return False
    elif p99 > p99_tbt_limit:
        return False
    if not np.isnan(m.mean_queue_delay) \
            and m.mean_queue_delay > mean_queue_limit:
        return False
    return True
