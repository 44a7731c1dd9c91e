"""Chrome trace-event tracer for the serving pipeline.

Emits the JSON Object Format of the Chrome trace-event spec — a
``{"traceEvents": [...]}`` dict of complete ("X") events with
microsecond ``ts``/``dur`` and one ``tid`` lane per OS thread — which
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` both load
directly.  The async host-stage overlap shows up as the worker thread's
lane running concurrently with the dispatch thread's iteration spans.

Design constraints, in order:

1. **Disabled mode is free.**  The default tracer is the shared
   ``NULL_TRACER`` (``enabled=False``).  Hot per-layer code guards every
   emission with ``if tracer.enabled:`` so the off path is one attribute
   read — no span objects, no perf_counter calls, no allocation.
2. **Span times are the measurement, not a copy of it.**  The planes
   already time their dispatch windows with ``time.perf_counter()`` for
   ``stage_timeline``; :meth:`Tracer.complete_at` takes those exact
   ``t0``/``dur`` values, so the trace and the counter instruments can
   never drift apart on the same run.
3. **Thread-safe.**  ``HostStageWorker`` emits from its own thread while
   the dispatch thread emits per-layer spans; a single lock guards the
   event list and the tid table.

Instrumentation must stay *outside* jitted stage bodies (a tracer call
inside one would fire once at trace time and never again) — the
``no-obs-in-jit`` analyzer rule enforces this statically.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List


class _NullSpan:
    """Reusable no-op context manager (one shared instance, no allocs)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context-manager handle from :meth:`Tracer.span`."""
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._tracer.complete_at(self._name, self._cat, t0,
                                 time.perf_counter() - t0, **self._args)
        return False


class Tracer:
    """Thread-safe Chrome trace-event collector.

    ``ts``/``dur`` are microseconds relative to tracer construction so
    traces start near t=0 regardless of perf_counter's epoch.  Each OS
    thread gets a small stable ``tid`` plus an "M" ``thread_name``
    metadata event the first time it emits, so Perfetto labels the
    lanes ("MainThread", "host-stage-…").
    """

    enabled = True

    def __init__(self, process_name: str = "repro-engine"):
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self._tids: Dict[int, int] = {}
        self._events.append({
            "ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
            "args": {"name": process_name},
        })

    # -- emission ---------------------------------------------------------

    def begin(self) -> float:
        """Start a span by hand; pass the return value to :meth:`end`."""
        return time.perf_counter()

    def end(self, name: str, cat: str, t0: float, **args: Any) -> None:
        """Close a span opened with :meth:`begin` (dur = now - t0)."""
        self.complete_at(name, cat, t0, time.perf_counter() - t0, **args)

    def complete_at(self, name: str, cat: str, t0: float, dur_s: float,
                    **args: Any) -> None:
        """Record a complete ("X") event from perf_counter ``t0`` lasting
        ``dur_s`` seconds — the caller's own timing values, verbatim."""
        ev = {
            "ph": "X", "name": name, "cat": cat,
            "ts": (t0 - self._epoch) * 1e6, "dur": dur_s * 1e6,
            "pid": self._pid, "tid": 0,
        }
        if args:
            ev["args"] = args
        tident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(tident)
            if tid is None:
                tid = self._tids[tident] = len(self._tids) + 1
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            ev["tid"] = tid
            self._events.append(ev)

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        """Record an instant ("i") event at now."""
        ev = {
            "ph": "i", "name": name, "cat": cat,
            "ts": (time.perf_counter() - self._epoch) * 1e6,
            "pid": self._pid, "tid": 0, "s": "t",
        }
        if args:
            ev["args"] = args
        tident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(tident)
            if tid is None:
                tid = self._tids[tident] = len(self._tids) + 1
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            ev["tid"] = tid
            self._events.append(ev)

    def span(self, name: str, cat: str = "", **args: Any) -> _Span:
        """``with tracer.span("name"):`` — for cool paths; hot paths use
        the guarded begin/end pattern instead."""
        return _Span(self, name, cat, args)

    # -- export -----------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """The full Chrome trace-event JSON object."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def dump_trace(self, path: str) -> int:
        """Write the trace JSON to ``path``; returns the event count.
        Blocking file I/O — never call inside a dispatch window."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


class NullTracer:
    """No-op stand-in with the full :class:`Tracer` surface.

    ``enabled`` is False so guarded hot paths skip emission entirely;
    the un-guarded methods are safe no-ops for cool paths.
    """

    enabled = False
    __slots__ = ()

    def begin(self) -> float:
        return 0.0

    def end(self, name: str, cat: str, t0: float, **args: Any) -> None:
        pass

    def complete_at(self, name: str, cat: str, t0: float, dur_s: float,
                    **args: Any) -> None:
        pass

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        pass

    def span(self, name: str, cat: str = "", **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def events(self) -> List[Dict[str, Any]]:
        return []

    def chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def dump_trace(self, path: str) -> int:
        return 0


NULL_TRACER = NullTracer()
