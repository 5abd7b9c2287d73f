"""Wire-level op traces: per-op end-to-end latency decomposition.

Reference: ``ITrace[]`` rides on every message
(``protocol-definitions/src/protocol.ts:173,279``); alfred stamps 1-in-N
messages on receipt (``config.json:58`` ``numberOfMessagesPerTrace``), deli
appends ``{service:"deli", action:"start|end", timestamp}``
(``deli/lambda.ts:1451``), and clients can echo the trace back, giving a
per-op pipeline latency breakdown with zero steady-state cost (untraced
messages carry an empty list).

Traces are plain ``(service, action, timestamp)`` tuples kept as dicts for
wire fidelity.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

# Frame-spine stage vocabulary (telemetry/README.md): each stage stamps
# start/end around its own work, so ``spans()`` yields ``{stage}_ms``:
#   alfred        front-door receipt -> pump dequeue (raw-log queue wait)
#   deli          the vectorized ticket_frame call
#   scriptorium   the durable DocOpLog append
#   device        device-stage enqueue -> boxcar dispatch issued
#   device_commit dispatch issued -> health-scan readback consumed
#   broadcast     room fan-out to connected sessions
# The continuous device pump decomposes the device residency
# further — its three sub-stages nest inside device/device_commit:
#   ring_stage    host boxcar assembly -> async upload into a ring slot
#   device_step   the AOT donated dispatch call (enqueue cost, not
#                 device compute — the number the pump drives to ~0)
#   scan_consume  the one-boxcar-stale health-scan readback wait
# The continuous front door adds one more nested stage:
#   feed_wait     device-stage enqueue -> the feed trigger (boxcar full
#                 or feed_deadline_ms expired) stages the row's boxcar —
#                 the time a row sat buffered waiting for its boxcar to
#                 form; bounded by the deadline under continuous feeding
STAGE_ALFRED = "alfred"
STAGE_DELI = "deli"
STAGE_SCRIPTORIUM = "scriptorium"
STAGE_DEVICE = "device"
STAGE_DEVICE_COMMIT = "device_commit"
STAGE_BROADCAST = "broadcast"
STAGE_RING_STAGE = "ring_stage"
STAGE_DEVICE_STEP = "device_step"
STAGE_SCAN_CONSUME = "scan_consume"
STAGE_FEED_WAIT = "feed_wait"
FRAME_STAGES = (
    STAGE_ALFRED,
    STAGE_DELI,
    STAGE_SCRIPTORIUM,
    STAGE_DEVICE,
    STAGE_DEVICE_COMMIT,
    STAGE_BROADCAST,
    STAGE_RING_STAGE,
    STAGE_DEVICE_STEP,
    STAGE_SCAN_CONSUME,
    STAGE_FEED_WAIT,
)


def stamp(traces: List[dict], service: str, action: str, timestamp: Optional[float] = None) -> None:
    """Append one trace entry in place (reference ``ITrace``)."""
    traces.append(
        {
            "service": service,
            "action": action,
            "timestamp": time.time() if timestamp is None else timestamp,
        }
    )


class TraceSampler:
    """1-in-N sampling gate (alfred's ``numberOfMessagesPerTrace``).

    ``should_trace()`` is called per inbound message; when it fires, the
    ingress stamps ``start`` and every later stage appends its own stamps
    only if the message already carries a non-empty trace list — so the
    sampling decision is made exactly once at the front door.
    """

    def __init__(self, messages_per_trace: int = 100):
        self.messages_per_trace = max(1, int(messages_per_trace))
        self._count = 0

    def should_trace(self) -> bool:
        self._count += 1
        return self._count % self.messages_per_trace == 0


def spans(traces: List[dict]) -> Dict[str, float]:
    """Reduce a trace list to per-service durations in ms: for each service
    with both ``start`` and ``end`` stamps, ``<service>_ms``; plus
    ``total_ms`` from the first to the last stamp."""
    if not traces:
        return {}
    by_service: Dict[str, Dict[str, float]] = {}
    for t in traces:
        by_service.setdefault(t["service"], {})[t["action"]] = t["timestamp"]
    out: Dict[str, float] = {}
    for svc, acts in by_service.items():
        if "start" in acts and "end" in acts:
            out[f"{svc}_ms"] = (acts["end"] - acts["start"]) * 1e3
    ts = [t["timestamp"] for t in traces]
    out["total_ms"] = (max(ts) - min(ts)) * 1e3
    return out


def has_stamp(traces: List[dict], service: str, action: str) -> bool:
    return any(
        t["service"] == service and t["action"] == action for t in traces
    )


class TraceBook:
    """Ledger of live sampled-frame traces for one serving pipeline.

    The front door ``open()``s a trace list per sampled frame; every
    stage stamps the SAME list object (the in-proc log shares record
    values across consumer groups, so one mutation is visible to all —
    stages on a remote log see a decoded copy and simply stop stamping,
    which degrades to a partial trace, never a wrong one). ``reap()``
    reduces each COMPLETE trace — broadcast stamped, and when a device
    stage exists its commit stamped too (the device boxcar flushes at
    pump quiescence, temporally AFTER broadcast) — into per-stage span
    observations on the metrics registry, keeping a bounded tail of
    span dicts for benches/tests. Untraced frames never touch this
    class: steady-state cost stays zero.
    """

    def __init__(
        self,
        expect_device: bool = False,
        max_live: int = 256,
        keep_completed: int = 64,
        registry=None,
    ):
        self.expect_device = expect_device
        self.max_live = max_live
        self.keep_completed = keep_completed
        self._registry = registry
        self._live: List[List[dict]] = []
        self.completed: List[Dict[str, float]] = []
        self.dropped = 0  # traces evicted incomplete (nacked/dup frames)

    def open(self) -> List[dict]:
        traces: List[dict] = []
        self._live.append(traces)
        if len(self._live) > self.max_live:
            # Incomplete stragglers (nacked frames, replay-duplicate
            # drops) must not pin memory forever: evict oldest-first —
            # and COUNT the loss on the registry: a
            # trace aging out of the ledger is sampled observability
            # silently discarded, which the scrape must be able to see.
            n = len(self._live) - self.max_live
            self.dropped += n
            del self._live[:n]
            from fluidframework_tpu_torch.telemetry import metrics

            metrics.trace_dropped_counter(self._registry).inc(
                n, reason="max_live"
            )
        return traces

    def _complete(self, traces: List[dict]) -> bool:
        if not has_stamp(traces, STAGE_BROADCAST, "end"):
            return False
        if self.expect_device and has_stamp(traces, STAGE_DEVICE, "start"):
            # The frame reached the device stage: its decomposition is
            # complete only once the commit readback landed.
            return has_stamp(traces, STAGE_DEVICE_COMMIT, "end")
        return True

    def reap(self) -> int:
        """Reduce every complete live trace into the registry; returns
        how many completed this call."""
        if not self._live:
            return 0
        from fluidframework_tpu_torch.telemetry import metrics

        done: List[List[dict]] = []
        kept: List[List[dict]] = []
        for t in self._live:
            (done if self._complete(t) else kept).append(t)
        if not done:
            return 0
        self._live = kept
        for traces in done:
            sp = spans(traces)
            metrics.observe_stage_spans(sp, self._registry)
            self.completed.append(sp)
        if len(self.completed) > self.keep_completed:
            del self.completed[: len(self.completed) - self.keep_completed]
        return len(done)

    @property
    def live(self) -> int:
        return len(self._live)
