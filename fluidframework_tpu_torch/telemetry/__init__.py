"""Telemetry, config/feature gates, and op tracing.

Counterpart of ``fluidframework_tpu/telemetry/__init__.py``, re-exporting
the same names: the Fluid Framework's two telemetry stacks,
``packages/utils/telemetry-utils`` (client: ChildLogger, PerformanceEvent,
MonitoringContext + feature gates) and
``server/routerlicious/packages/services-telemetry`` (server: Lumberjack
structured metrics), plus the wire-level ``ITrace`` op stamps of
``protocol-definitions/src/protocol.ts:173``.
"""

from fluidframework_tpu_torch.telemetry.config import (
    ConfigProvider,
    LayeredConfig,
    MonitoringContext,
)
from fluidframework_tpu_torch.telemetry.logger import (
    ChildLogger,
    CollectingLogger,
    PerformanceEvent,
    TelemetryLogger,
)
from fluidframework_tpu_torch.telemetry.lumberjack import (
    CollectingEngine,
    Lumber,
    LumberEventName,
    Lumberjack,
)
from fluidframework_tpu_torch.telemetry import journal, metrics, profiler, tracing
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
    "metrics",
    "ChildLogger",
    "CollectingEngine",
    "CollectingLogger",
    "ConfigProvider",
    "LayeredConfig",
    "Lumber",
    "LumberEventName",
    "Lumberjack",
    "MonitoringContext",
    "PerformanceEvent",
    "TelemetryLogger",
    "journal",
    "profiler",
    "tracing",
]
