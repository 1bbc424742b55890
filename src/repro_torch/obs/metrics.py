"""Counters / gauges / histograms / keyed series for the serving stack.

``MetricsRegistry`` replaces the ad-hoc dicts the engines used to grow
(``token_walltimes``, ``occupancy_log``) with named metrics every
benchmark reads the same way, serializable to JSON (the format
``scripts/check_bench_regression.py`` ingests) and to Prometheus text
exposition format. Like ``Tracer``, a registry is an explicit object —
no process-global state — and recording is a plain append/add, cheap
enough to stay on in the serving hot path.

Metric types:

* ``Counter`` — monotonically increasing count (preemptions, NaN trips).
* ``Gauge`` — last-value-wins sample; ``record()`` also appends to a
  ``series`` list so per-step gauges (pool occupancy) stay auditable
  over time, which is what the old ``occupancy_log`` was.
* ``Histogram`` — raw-sample distribution with exact percentiles
  (p50/p95 via nearest-rank); serving-scale sample counts make exact
  storage cheaper than bucketing games.
* ``Series`` — per-key append-only float lists (token wall-clock
  timestamps per request id); JSON-only, skipped by the Prometheus
  export which has no such shape.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Series"]


@dataclasses.dataclass
class Counter:
    name: str
    help: str = ""
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def to_json(self):
        return self.value


@dataclasses.dataclass
class Gauge:
    name: str
    help: str = ""
    value: float = 0.0
    series: list = dataclasses.field(default_factory=list)

    def set(self, v: float) -> None:
        self.value = v

    def record(self, v: float) -> None:
        """Set the gauge AND append to the time series."""
        self.value = v
        self.series.append(v)

    def to_json(self):
        return {"value": self.value, "series": list(self.series)}


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on pre-sorted samples."""
    if not sorted_vals:
        return 0.0
    rank = max(0, math.ceil(q / 100.0 * len(sorted_vals)) - 1)
    return sorted_vals[min(rank, len(sorted_vals) - 1)]


@dataclasses.dataclass
class Histogram:
    name: str
    help: str = ""
    values: list = dataclasses.field(default_factory=list)

    def observe(self, v: float) -> None:
        self.values.append(v)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def percentile(self, q: float) -> float:
        return _percentile(sorted(self.values), q)

    def summary(self) -> dict:
        if not self.values:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0}
        s = sorted(self.values)
        return {
            "count": len(s),
            "sum": float(sum(s)),
            "mean": float(sum(s) / len(s)),
            "min": s[0],
            "max": s[-1],
            "p50": _percentile(s, 50),
            "p95": _percentile(s, 95),
        }

    def to_json(self):
        return self.summary()


@dataclasses.dataclass
class Series:
    name: str
    help: str = ""
    by_key: dict = dataclasses.field(default_factory=dict)

    def observe(self, key, v: float) -> None:
        self.by_key.setdefault(key, []).append(v)

    def to_json(self):
        return {str(k): list(v) for k, v in self.by_key.items()}


_PROM_SAFE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_SAFE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


class MetricsRegistry:
    """Get-or-create metric store; one per engine ``serve()`` epoch."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._series: dict[str, Series] = {}

    def _get(self, store: dict, cls, name: str, help: str):
        m = store.get(name)
        if m is None:
            m = store[name] = cls(name, help)
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(self._counters, Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(self._gauges, Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(self._histograms, Histogram, name, help)

    def series(self, name: str, help: str = "") -> Series:
        return self._get(self._series, Series, name, help)

    # -- serialization ----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "counters": {n: c.to_json() for n, c in self._counters.items()},
            "gauges": {n: g.to_json() for n, g in self._gauges.items()},
            "histograms": {n: h.to_json()
                           for n, h in self._histograms.items()},
            "series": {n: s.to_json() for n, s in self._series.items()},
        }

    def write_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4). Histograms render
        as summaries (quantile labels); keyed series are JSON-only."""
        lines: list[str] = []
        for c in self._counters.values():
            n = _prom_name(c.name)
            if c.help:
                lines.append(f"# HELP {n} {c.help}")
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value}")
        for g in self._gauges.values():
            n = _prom_name(g.name)
            if g.help:
                lines.append(f"# HELP {n} {g.help}")
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {g.value}")
        for h in self._histograms.values():
            n = _prom_name(h.name)
            s = h.summary()
            if h.help:
                lines.append(f"# HELP {n} {h.help}")
            lines.append(f"# TYPE {n} summary")
            lines.append(f'{n}{{quantile="0.5"}} {s["p50"]}')
            lines.append(f'{n}{{quantile="0.95"}} {s["p95"]}')
            lines.append(f"{n}_sum {s['sum']}")
            lines.append(f"{n}_count {s['count']}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())
