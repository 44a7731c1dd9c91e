"""MetricsRegistry: counters / gauges / histograms, one flat snapshot.

The single home for the engine's previously-scattered telemetry.
Naming scheme (dotted, lowercase): ``engine.*`` iteration-level facts,
``sched.*`` scheduler decisions (queue depth, batch sizes, working-set
estimates), ``kv.*`` FlashH2D/FlashD2H transfer totals and HBM
residency, ``plane.*`` per-plane staged-decode counters aggregated,
``worker.*`` the HostStageWorker, ``obs.*`` the obs layer itself.

Instruments are memoized by name — ``registry.gauge("x")`` always
returns the same object, so hot paths resolve instruments once in
``__init__`` and call ``.set()``/``.inc()`` per iteration.  The whole
registry flattens to one ``{name: float}`` dict via :meth:`snapshot`
(histograms expand to ``_count/_sum/_min/_max/_mean``) and exports
Prometheus text exposition via :meth:`prometheus_text`.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Optional

_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


class Counter:
    """Monotonically increasing value."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Point-in-time value (set, not accumulated)."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Streaming count/sum/min/max (no buckets — snapshot-oriented)."""
    __slots__ = ("name", "help", "count", "sum", "min", "max")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value


class MetricsRegistry:
    """Memoizing registry; thread-safe instrument creation.

    Individual ``inc``/``set``/``observe`` calls are plain float ops —
    atomic enough under the GIL for the counters here; the lock only
    guards the name table.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help)
            return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, help)
            return g

    def histogram(self, name: str, help: str = "") -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, help)
            return h

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name: value}``; histograms expand to five keys."""
        out: Dict[str, float] = {}
        with self._lock:
            for c in self._counters.values():
                out[c.name] = c.value
            for g in self._gauges.values():
                out[g.name] = g.value
            for h in self._histograms.values():
                out[h.name + "_count"] = float(h.count)
                out[h.name + "_sum"] = h.sum
                if h.count:
                    out[h.name + "_min"] = h.min
                    out[h.name + "_max"] = h.max
                    out[h.name + "_mean"] = h.sum / h.count
        return out

    def prometheus_text(self,
                        extra: Optional[Dict[str, float]] = None) -> str:
        """Prometheus text exposition format (dots become underscores).

        ``extra`` merges additional flat values (e.g. the engine's
        derived counters) as untyped samples.
        """
        lines = []
        with self._lock:
            items = (
                [(c, "counter") for c in self._counters.values()]
                + [(g, "gauge") for g in self._gauges.values()]
            )
            hists = list(self._histograms.values())
        for inst, kind in items:
            pname = _prom_name(inst.name)
            if inst.help:
                lines.append(f"# HELP {pname} {inst.help}")
            lines.append(f"# TYPE {pname} {kind}")
            lines.append(f"{pname} {_prom_value(inst.value)}")
        for h in hists:
            pname = _prom_name(h.name)
            if h.help:
                lines.append(f"# HELP {pname} {h.help}")
            lines.append(f"# TYPE {pname} summary")
            lines.append(f"{pname}_count {h.count}")
            lines.append(f"{pname}_sum {_prom_value(h.sum)}")
        if extra:
            for name in sorted(extra):
                lines.append(f"{_prom_name(name)} "
                             f"{_prom_value(extra[name])}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    name = _PROM_SANITIZE.sub("_", name.replace(".", "_"))
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)
