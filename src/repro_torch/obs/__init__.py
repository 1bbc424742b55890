"""Telemetry for the serving engine: span tracing and a metrics registry
(copies of ``repro/obs/trace.py`` and ``repro/obs/metrics.py``)."""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
)
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["NULL_TRACER", "Tracer", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "Series"]
