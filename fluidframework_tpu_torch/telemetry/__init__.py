"""Telemetry of the serving stage: op tracing, the metrics registry, the
flight-recorder journal and the timeline profiler.

Counterpart of ``fluidframework_tpu/telemetry/__init__.py``, re-exporting
only what the device-apply stage uses (the config gates, the client logger
and Lumberjack are not ported).
"""

from fluidframework_tpu_torch.telemetry import (
    journal,
    metrics,
    profiler,
    tracing,
)
from fluidframework_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "journal",
    "metrics",
    "profiler",
    "tracing",
]
