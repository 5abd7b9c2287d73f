"""TpuDeliLambda — the device-apply stage of the service pipeline.

Counterpart of ``fluidframework_tpu/service/device_lambda.py``, the same
code on the port's backend. Reference: deli's per-document lambda owns the
authoritative op path (``server/routerlicious/packages/lambdas/src/deli/
lambda.ts:379,742``), plugged into the partition framework by the document
router (``lambdas-driver/src/document-router/documentLambda.ts:20``).
Ticketing stays in the sequencer; THIS stage — a consumer of the
``deltas`` topic, demuxed per document — applies every sequenced
string-channel op to the service's device-resident replica
(:class:`~fluidframework_tpu_torch.service.device_backend.DeviceFleetBackend`),
so reads, device summaries and capacity errors come from the GPU, not a
host mirror.

Wire decoding mirrors the client exactly: the same
``RemoteMessageProcessor`` undoes compression/chunking and the same
``row_from_wire`` lowering produces byte-identical kernel rows.

Crash recovery: this stage checkpoints no state — its durable form IS the
deltas log. A restarted consumer replays from offset zero and the
backend's applied-seq watermarks make replay a no-op for anything already
applied.

Feeding cadence: rows this stage enqueues do not wait for pipeline
quiescence — the caller fires the backend's continuous-feed trigger
(``DeviceFleetBackend.pump_feed``) after each ingest chunk, so a boxcar
dispatches as soon as it fills or its feed deadline expires.
"""

from __future__ import annotations

from typing import Any, List, Tuple

from fluidframework_tpu_torch.models.shared_string import row_from_wire
from fluidframework_tpu_torch.protocol.types import MessageType
from fluidframework_tpu_torch.runtime.op_lifecycle import (
    RemoteMessageProcessor,
)
from fluidframework_tpu_torch.service.device_backend import DeviceFleetBackend
from fluidframework_tpu_torch.service.lambdas import PartitionLambda
from fluidframework_tpu_torch.telemetry import tracing


class TpuDeliLambda(PartitionLambda):
    """Per-document device-apply consumer (demuxed by DocumentLambda)."""

    def __init__(self, doc_id: str, backend: DeviceFleetBackend):
        self.doc_id = doc_id
        self.backend = backend
        self._rmp = RemoteMessageProcessor()

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        if value["t"] == "seqframe":
            # Batched binary wire (protocol/opframe.py): the rows ARE
            # kernel rows, already stamped — no per-op decode at all.
            frame = value["frame"]
            traces = value.get("traces")
            if traces is not None:
                # Sampled frame: the device span opens at enqueue (and
                # track_trace opens the nested feed_wait span); the
                # backend closes them as the continuous feed stages the
                # boxcar (size/deadline trigger) and the scan consume
                # lands — not at some later quiescence flush.
                tracing.stamp(traces, tracing.STAGE_DEVICE, "start")
                self.backend.track_trace(traces)
            self.backend.enqueue_frame(self.doc_id, frame)
            return []
        if value["t"] != "seq":
            return []
        msg = self._rmp.process(value["msg"])
        if msg is None:
            return []  # swallowed wire message (non-final chunk)
        if msg.type == MessageType.CLIENT_LEAVE:
            self._rmp.forget_client(msg.contents)
            return []
        if msg.type != MessageType.OPERATION:
            return []
        envelope = msg.contents
        if not isinstance(envelope, dict) or "address" not in envelope:
            return []
        address = envelope["address"]
        inner = envelope.get("contents")
        if not isinstance(inner, dict):
            return []
        if inner.get("k") not in ("ins", "rem", "ann"):
            return []  # not a string-kernel op (other DDS types, intervals)
        idx_key = (self.doc_id, address)
        # ensure() before lowering: row_from_wire records insert payloads
        # into the channel's payload dict.
        self.backend.ensure(self.doc_id, address)
        row = row_from_wire(
            inner,
            seq=msg.sequence_number,
            ref=msg.reference_sequence_number,
            client=msg.client_id,
            msn=msg.minimum_sequence_number,
            payloads=self.backend.payloads[idx_key],
        )
        if row is not None:
            self.backend.enqueue(self.doc_id, address, row)
        return []

    def state(self) -> Any:
        return None  # rebuilt by log replay, not checkpointed
