"""Client-side telemetry: namespaced loggers and performance events.

Reference: ``packages/utils/telemetry-utils`` — ``ITelemetryLogger`` threaded
through every constructor, ``ChildLogger`` namespacing, ``PerformanceEvent``
start/end/cancel envelopes, ``MonitoringContext`` = logger + config provider
(the feature-gate surface used e.g. at ``containerRuntime.ts:1846-1849``).

TPU-native stance: events are plain dicts appended to a host-side sink (the
device path never logs — kernels return error codes in the state arrays and
the host layer raises them into telemetry), so logging cost stays off the
hot path entirely.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

# Event categories (reference TelemetryEventCategory).
GENERIC = "generic"
ERROR = "error"
PERFORMANCE = "performance"


class TelemetryLogger:
    """Base logger: sends enriched events to a host-supplied sink.

    The reference's hosts supply an ``ITelemetryBaseLogger`` with a single
    ``send(event)``; everything else (namespacing, common properties, perf
    envelopes) is client-side sugar. Same here: ``sink`` is any callable
    taking the event dict.
    """

    def __init__(
        self,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        namespace: str = "",
        properties: Optional[Dict[str, Any]] = None,
    ):
        self._sink = sink
        self.namespace = namespace
        self.properties = dict(properties or {})

    def send(self, event: Dict[str, Any]) -> None:
        evt = dict(self.properties)
        evt.update(event)
        if self.namespace and "eventName" in evt:
            evt["eventName"] = f"{self.namespace}:{evt['eventName']}"
        evt.setdefault("category", GENERIC)
        evt.setdefault("timestamp", time.time())
        if self._sink is not None:
            self._sink(evt)

    def send_error(self, event_name: str, error: Optional[BaseException] = None, **props) -> None:
        evt = {"eventName": event_name, "category": ERROR, **props}
        if error is not None:
            evt["error"] = str(error)
            evt["errorType"] = type(error).__name__
        self.send(evt)

    def send_performance(self, event_name: str, duration_ms: float, **props) -> None:
        self.send(
            {
                "eventName": event_name,
                "category": PERFORMANCE,
                "duration": duration_ms,
                **props,
            }
        )


class ChildLogger(TelemetryLogger):
    """Namespaced child that forwards to its parent (``ChildLogger.create``).

    Namespaces compose with ``:`` exactly as the reference does, so an event
    sent from ``fluid:telemetry:DeltaManager`` reads the same way.
    """

    def __init__(
        self,
        parent: TelemetryLogger,
        namespace: str,
        properties: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(sink=parent.send, namespace=namespace, properties=properties)

    @staticmethod
    def create(
        parent: Optional[TelemetryLogger],
        namespace: str,
        properties: Optional[Dict[str, Any]] = None,
    ) -> "ChildLogger":
        return ChildLogger(parent or TelemetryLogger(), namespace, properties)


class CollectingLogger(TelemetryLogger):
    """Test sink that records every event (reference ``MockLogger``)."""

    def __init__(self, properties: Optional[Dict[str, Any]] = None):
        self.events: List[Dict[str, Any]] = []
        super().__init__(sink=self.events.append, properties=properties)

    def matches(self, event_name: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("eventName", "").endswith(event_name)]


class PerformanceEvent:
    """Start/end/cancel envelope around a timed operation
    (reference ``PerformanceEvent.timedExec``).

    ``start`` emits ``<name>_start`` (optional), ``end`` emits ``<name>_end``
    with ``duration`` in ms, ``cancel`` emits ``<name>_cancel`` with the
    error. Use as a context manager: exceptions cancel, clean exit ends.
    """

    def __init__(
        self,
        logger: TelemetryLogger,
        event_name: str,
        emit_start: bool = False,
        **props,
    ):
        self.logger = logger
        self.event_name = event_name
        self.props = props
        self._t0 = time.perf_counter()
        self._done = False
        if emit_start:
            logger.send({"eventName": f"{event_name}_start", **props})

    @property
    def duration_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def end(self, **extra) -> None:
        if self._done:
            return
        self._done = True
        self.logger.send_performance(
            f"{self.event_name}_end", self.duration_ms, **{**self.props, **extra}
        )

    def cancel(self, error: Optional[BaseException] = None) -> None:
        if self._done:
            return
        self._done = True
        evt = {
            "eventName": f"{self.event_name}_cancel",
            "category": PERFORMANCE,
            "duration": self.duration_ms,
            **self.props,
        }
        if error is not None:
            evt["error"] = str(error)
        self.logger.send(evt)

    def __enter__(self) -> "PerformanceEvent":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.cancel(exc)
        else:
            self.end()
        return False
