"""Span-interval analysis over a Chrome trace: achieved overlap (a copy
of the reference package's ``obs/trace_analysis.py``).

The quantity both instruments measure is *the fraction of host-stage
work that ran off the dispatch thread*:

    overlap = W / (W + D)

where ``W`` is host-stage time spent on the ``HostStageWorker`` thread
(cat ``host-stage-worker``) while the dispatch thread was inside an
engine iteration, and ``D`` is host-stage time the dispatch thread
spent itself (cat ``host-stage`` — the per-layer stage-callback
windows).  Sync mode has no worker spans, so the function returns
``None`` there; a fully-async run where every write-back moved to the
worker approaches 1 as the dispatch-side residue shrinks.

This is the *trace* instrument.  The independent counter instrument is
``ServingEngine.stage_overlap_measured()`` (HostStageWorker.busy_s vs
the planes' accumulated ``host_stage_s``); ``chip_smoke.py``'s obs
phase and the port's obs tests assert that the two agree within 10% on
the same run.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def _union(intervals: List[Interval]) -> List[Interval]:
    """Merge into disjoint sorted intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _total(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def _intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Intersection of two disjoint sorted interval lists."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _spans(events: Sequence[Dict[str, Any]], *, cat: Optional[str] = None,
           name: Optional[str] = None) -> List[Interval]:
    out = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if cat is not None and ev.get("cat") != cat:
            continue
        if name is not None and ev.get("name") != name:
            continue
        ts = ev["ts"]
        out.append((ts, ts + ev.get("dur", 0.0)))
    return out


def achieved_overlap_fraction(trace) -> Optional[float]:
    """Overlap fraction from span intervals; ``None`` if unmeasurable.

    ``trace`` is either the ``{"traceEvents": [...]}`` dict or the bare
    event list.  Numerator: worker-thread host-stage spans intersected
    with the dispatch thread's ``iteration`` spans (worker work done
    outside any iteration overlapped nothing).  Denominator adds the
    dispatch thread's own ``host-stage`` callback spans.
    """
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    worker = _union(_spans(events, cat="host-stage-worker"))
    if not worker:
        return None
    iters = _union(_spans(events, name="iteration"))
    dispatch_stage = _union(_spans(events, cat="host-stage"))
    overlapped = _total(_intersect(worker, iters))
    denom = overlapped + _total(dispatch_stage)
    if denom <= 0.0:
        return None
    return overlapped / denom
