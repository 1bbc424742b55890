"""Telemetry for the serving engines and the edge simulator: span tracing
with Chrome/Perfetto export and the sim-timeline renderer, a metrics
registry, and the sim-vs-measured per-phase calibration report (copies
of ``repro/obs/trace.py``, ``metrics.py`` and ``compare.py``).
``python -m repro_torch.obs.validate TRACE.json ...`` checks exported
traces."""

from repro_torch.obs.compare import (
    DEFAULT_KIND_TO_PHASE,
    compare_report,
    measured_phase_stats,
    write_report,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    Tracer,
    tag_key,
    tasks_to_chrome,
    validate_chrome_trace,
)

__all__ = [
    "NULL_TRACER",
    "Tracer",
    "tag_key",
    "tasks_to_chrome",
    "validate_chrome_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Series",
    "DEFAULT_KIND_TO_PHASE",
    "compare_report",
    "measured_phase_stats",
    "write_report",
]
