"""Server-side structured metrics: Lumber / Lumberjack.

Reference: ``server/routerlicious/packages/services-telemetry`` —
``Lumberjack`` (``lumberjack.ts:21``) is the process-global factory,
``Lumber`` (``lumber.ts:23``) is one metric/event with typed properties,
duration, success/failure state, and schema validation of required
properties per event name; ``LumberEventName`` is the catalog every lambda
wraps its work in.

Here engines are plain callables so tests can collect, and schema
validation is a dict of event name -> required property names.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

# LumberEventName catalog (subset used by the service layer; the reference
# catalog lives in services-telemetry/src/lumberEventNames.ts).
class LumberEventName:
    DeliHandler = "DeliHandler"
    ScribeHandler = "ScribeHandler"
    ScriptoriumHandler = "ScriptoriumHandler"
    BroadcasterHandler = "BroadcasterHandler"
    ConnectDocument = "ConnectDocument"
    SubmitOp = "SubmitOp"
    SummaryWrite = "SummaryWrite"
    CheckpointWrite = "CheckpointWrite"
    SessionResult = "SessionResult"
    TotalConnectionCount = "TotalConnectionCount"
    DeviceCapacity = "DeviceCapacity"
    DeviceApply = "DeviceApply"


class LumberType:
    METRIC = "metric"
    LOG = "log"


class Lumber:
    """One structured metric: properties + duration + outcome
    (reference ``lumber.ts:23``)."""

    def __init__(
        self,
        event_name: str,
        lumber_type: str,
        engines: List[Callable[[Dict[str, Any]], None]],
        schema: Optional[List[str]] = None,
        properties: Optional[Dict[str, Any]] = None,
    ):
        self.event_name = event_name
        self.type = lumber_type
        self.properties: Dict[str, Any] = dict(properties or {})
        self._engines = engines
        self._schema = schema or []
        self._t0 = time.perf_counter()
        self._completed = False

    def set_property(self, key: str, value: Any) -> "Lumber":
        self.properties[key] = value
        return self

    def set_properties(self, props: Dict[str, Any]) -> "Lumber":
        self.properties.update(props)
        return self

    def _emit(self, success: bool, message: str) -> None:
        if self._completed:
            raise RuntimeError(
                f"Lumber {self.event_name} already completed"
            )  # reference throws on double-completion too
        self._completed = True
        missing = [k for k in self._schema if k not in self.properties]
        record = {
            "eventName": self.event_name,
            "type": self.type,
            "successful": success,
            "message": message,
            "durationInMs": (time.perf_counter() - self._t0) * 1e3,
            "properties": dict(self.properties),
            "timestamp": time.time(),
        }
        if missing:
            # Schema violations are themselves telemetry, never exceptions
            # (reference logs LumberjackSchemaValidationFailure).
            record["schemaValidationFailed"] = missing
        for engine in self._engines:
            engine(record)
        # Every completion also feeds the unified registry (one counter by
        # outcome + one duration histogram per event) so /metrics carries
        # the control-plane aggregate without a collecting engine.
        from fluidframework_tpu_torch.telemetry import metrics

        reg = metrics.REGISTRY
        reg.counter(
            "lumber_events_total",
            "completed Lumber metrics by event and outcome",
            labelnames=("event", "outcome"),
        ).inc(event=self.event_name, outcome="ok" if success else "error")
        reg.histogram(
            "lumber_duration_ms",
            "Lumber metric durations (ms)",
            labelnames=("event",),
        ).observe(record["durationInMs"], event=self.event_name)

    def success(self, message: str = "") -> None:
        self._emit(True, message)

    def error(self, message: str = "", exception: Optional[BaseException] = None) -> None:
        if exception is not None:
            self.properties.setdefault("exception", repr(exception))
        self._emit(False, message)


# Required properties per event (reference BaseTelemetryProperties schema).
_BASE_SCHEMA = ["tenantId", "documentId"]
_SCHEMAS: Dict[str, List[str]] = {
    LumberEventName.DeliHandler: _BASE_SCHEMA,
    LumberEventName.ScribeHandler: _BASE_SCHEMA,
    LumberEventName.SummaryWrite: _BASE_SCHEMA,
    LumberEventName.ConnectDocument: _BASE_SCHEMA,
}


class Lumberjack:
    """Process-global metric factory (reference ``lumberjack.ts:21``).

    ``setup(engines)`` installs output engines once; ``new_metric`` /
    ``log`` create Lumbers. Tests use ``CollectingEngine``.
    """

    _engines: List[Callable[[Dict[str, Any]], None]] = []

    @classmethod
    def setup(cls, engines: List[Callable[[Dict[str, Any]], None]]) -> None:
        cls._engines = list(engines)

    @classmethod
    def reset(cls) -> None:
        cls._engines = []

    @classmethod
    def new_metric(
        cls, event_name: str, properties: Optional[Dict[str, Any]] = None
    ) -> Lumber:
        return Lumber(
            event_name,
            LumberType.METRIC,
            cls._engines,
            schema=_SCHEMAS.get(event_name),
            properties=properties,
        )

    @classmethod
    def log(
        cls, message: str, level: str = "info", properties: Optional[Dict[str, Any]] = None
    ) -> None:
        record = {
            "eventName": "log",
            "type": LumberType.LOG,
            "level": level,
            "message": message,
            "properties": dict(properties or {}),
            "timestamp": time.time(),
        }
        for engine in cls._engines:
            engine(record)


class CollectingEngine:
    """Test engine capturing every record (reference TestEngine1)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def __call__(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def matches(self, event_name: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("eventName") == event_name]
