"""In-process ordering service — the LocalDeltaConnectionServer equivalent.

Reference: ``server/routerlicious/packages/local-server`` +
``memory-orderer/src/localOrderer.ts``: the full order-and-broadcast pipeline
(alfred ingest → deli sequencing → scriptorium op log → broadcaster fan-out)
wired in-process so clients and tests run without any cluster. Connections
get per-client inboxes (the DeltaQueue analog) so tests can interleave
delivery arbitrarily.

Counterpart of ``fluidframework_tpu/service/local_server.py``: the default
service of :class:`~fluidframework_tpu_torch.service.network_server.
FluidNetworkServer`. It is host-only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    NackMessage,
    SequencedDocumentMessage,
    SignalMessage,
)
from fluidframework_tpu_torch.service.sequencer import DocumentSequencer
from fluidframework_tpu_torch.service.summary_store import SummaryStore
from fluidframework_tpu_torch.telemetry import metrics, tracing


@dataclass
class LocalConnection:
    """One client's live connection to a document (delta stream)."""

    doc_id: str
    client_id: int
    service: "LocalFluidService"
    # Sequence number of this connection's own ClientJoin: client slots
    # recycle, so "is this message my echo" is (client_id matches AND
    # seq > join_seq) — a previous holder's traffic is always ≤ its leave,
    # which precedes this join.
    join_seq: int = 0
    # Never-recycled per-document connection ordinal (content-id scoping).
    conn_no: int = 0
    evicted: bool = False  # severed by idle expiry; submits are rejected
    inbox: List[SequencedDocumentMessage] = field(default_factory=list)
    signals: List[SignalMessage] = field(default_factory=list)
    nacks: List[NackMessage] = field(default_factory=list)
    on_nack: Optional[Callable[[NackMessage], None]] = None
    # Latest acked summary at connect time: (handle, seq) or None — the
    # client loads it, then catches up from seq (reference storage.getVersions).
    initial_summary: Optional[tuple] = None

    def submit(self, msg: DocumentMessage) -> None:
        self.service.submit(self.doc_id, self.client_id, msg)

    def submit_signal(self, content) -> None:
        self.service.submit_signal(self.doc_id, self.client_id, content)

    def take_inbox(self, n: Optional[int] = None) -> List[SequencedDocumentMessage]:
        """Pop up to n messages from the inbound queue, in order."""
        n = len(self.inbox) if n is None else min(n, len(self.inbox))
        out, self.inbox[:] = self.inbox[:n], self.inbox[n:]
        return out

    def disconnect(self) -> None:
        self.service.disconnect(self.doc_id, self.client_id)


class _DocState:
    def __init__(self, doc_id: str):
        self.sequencer = DocumentSequencer(doc_id)
        self.op_log: List[SequencedDocumentMessage] = []  # scriptorium
        self.connections: Dict[int, LocalConnection] = {}
        self.signal_counter = 0
        # Scribe state (reference scribe/lambda.ts): the latest acked
        # client summary and the protocol head it advanced to.
        self.latest_summary: Optional[tuple] = None  # (handle, seq)
        self.protocol_head = 0
        # Service summaries (scribe/lambda.ts:304): periodic logTail blobs
        # written by the SERVICE so storage alone can reconstruct the
        # stream even when no client ever summarizes.
        self.service_summaries: List[tuple] = []  # (handle, from_seq, to_seq)
        self.service_summary_head = 0


class LocalFluidService:
    """In-proc service endpoint: connect/submit/broadcast + durable op log
    + summary storage (ordering, scriptorium, broadcaster, and scribe roles
    of the reference pipeline, in one process)."""

    def __init__(
        self,
        store: Optional[SummaryStore] = None,
        messages_per_trace: int = 0,
        service_summary_every: int = 0,  # ops per service summary; 0 = off
    ) -> None:
        self.docs: Dict[str, _DocState] = {}
        self.store = store or SummaryStore()
        self.service_summary_every = service_summary_every
        # Sampled op tracing at the front door (alfred stamps 1-in-N,
        # reference config.json:58 numberOfMessagesPerTrace; 0 = off).
        self.trace_sampler = (
            tracing.TraceSampler(messages_per_trace) if messages_per_trace else None
        )

    def _doc(self, doc_id: str) -> _DocState:
        if doc_id not in self.docs:
            self.docs[doc_id] = _DocState(doc_id)
        return self.docs[doc_id]

    # -- connection lifecycle (alfred connect_document, C.1) -----------------

    def connect(
        self, doc_id: str, mode: str = "write", from_seq: int = 0,
        scopes=None,
    ) -> LocalConnection:
        from fluidframework_tpu_torch.service.sequencer import FULL_SCOPES

        doc = self._doc(doc_id)
        res = doc.sequencer.join(
            mode, scopes=FULL_SCOPES if scopes is None else scopes
        )
        if isinstance(res, NackMessage):
            raise ConnectionError(res.message)
        client_id = res.contents["clientId"]
        conn = LocalConnection(
            doc_id=doc_id, client_id=client_id, service=self,
            join_seq=res.sequence_number,
            conn_no=res.contents.get("connNo", 0),
        )
        # Catch-up: a fresh client gets the latest acked summary plus the op
        # tail after it; a reconnecting client resumes from where it left
        # off (reference storage.getVersions + delta fetch).
        if from_seq == 0 and doc.latest_summary is not None:
            conn.initial_summary = doc.latest_summary
            from_seq = doc.latest_summary[1]
        conn.inbox.extend(
            m for m in doc.op_log if m.sequence_number > from_seq
        )
        doc.connections[client_id] = conn
        self._broadcast(doc, res)
        return conn

    def disconnect(self, doc_id: str, client_id: int) -> None:
        doc = self._doc(doc_id)
        doc.connections.pop(client_id, None)
        leave = doc.sequencer.leave(client_id)
        if leave is not None:
            self._broadcast(doc, leave)
        self._after_departure(doc)

    def _after_departure(self, doc: _DocState) -> None:
        """Deli op-event (lambda.ts:136-150): the last client leaving emits
        NoClient and triggers an end-of-session service summary, so storage
        alone reconstructs the stream even when no client ever summarized."""
        nc = doc.sequencer.maybe_no_client()
        if nc is not None:
            self._broadcast(doc, nc)
            self._write_service_summary(doc)

    def control(self, doc_id: str, contents: dict):
        """Sequence a service control message (UpdateDSN / NackMessages —
        the deli control plane) and broadcast it to connected clients."""
        doc = self._doc(doc_id)
        msg = doc.sequencer.control(contents)
        self._broadcast(doc, msg)
        return msg

    # -- op path (alfred submitOp -> deli -> broadcaster, §3.3) --------------

    def expire_idle(self, timeout_s: float, now=None) -> int:
        """Evict clients idle past the timeout (deli ClientSequenceTimeout):
        sequences their leaves, broadcasts them, and SEVERS the zombie
        connections — an evicted client's slot may recycle, so it must stop
        receiving traffic (its next holder's ops would look like echoes) and
        must reconnect to keep editing. Returns clients evicted."""
        n = 0
        for doc in self.docs.values():
            evicted_here = 0
            for leave in doc.sequencer.expire_idle(timeout_s, now):
                evicted = leave.contents
                conn = doc.connections.pop(evicted, None)
                if conn is not None:
                    conn.evicted = True
                self._broadcast(doc, leave)
                evicted_here += 1
            if evicted_here:
                self._after_departure(doc)
            n += evicted_here
        return n

    def submit(self, doc_id: str, client_id: int, msg: DocumentMessage) -> None:
        doc = self._doc(doc_id)
        if client_id not in doc.connections:
            # Evicted/disconnected clients are dead to the service: the op is
            # rejected and the client must reconnect (the reference closes
            # the socket; this is the in-proc analog).
            raise ConnectionError(
                f"client {client_id} is not connected to {doc_id!r}"
            )
        if self.trace_sampler is not None and self.trace_sampler.should_trace():
            tracing.stamp(msg.traces, "alfred", "start")
        res = doc.sequencer.ticket(client_id, msg)
        if res is None:
            return  # duplicate, dropped
        if isinstance(res, NackMessage):
            conn = doc.connections.get(client_id)
            if conn is not None:
                conn.nacks.append(res)
                if conn.on_nack:
                    conn.on_nack(res)
            return
        self._broadcast(doc, res)
        if res.type == MessageType.SUMMARIZE:
            self._scribe(doc, res)

    def _scribe(self, doc: _DocState, msg: SequencedDocumentMessage) -> None:
        """Validate a sequenced Summarize op and ack/nack it (the shared
        scribe rule, summary_store.scribe_decide)."""
        from fluidframework_tpu_torch.service.summary_store import scribe_decide

        ok, contents = scribe_decide(msg, doc.protocol_head, self.store)
        if ok:
            doc.latest_summary = (contents["handle"], contents["head"])
            doc.protocol_head = msg.sequence_number
        ack = doc.sequencer._sequence_system(
            MessageType.SUMMARY_ACK if ok else MessageType.SUMMARY_NACK,
            contents=contents,
        )
        self._broadcast(doc, ack)

    def submit_signal(self, doc_id: str, client_id: int, content) -> None:
        doc = self._doc(doc_id)
        doc.signal_counter += 1
        sig = SignalMessage(
            client_id=client_id,
            client_connection_number=doc.signal_counter,
            content=content,
        )
        for conn in doc.connections.values():
            conn.signals.append(sig)

    def _broadcast(self, doc: _DocState, msg: SequencedDocumentMessage) -> None:
        if (
            self.trace_sampler is not None
            and msg.traces
            and tracing.has_stamp(msg.traces, tracing.STAGE_ALFRED, "start")
            and not tracing.has_stamp(msg.traces, tracing.STAGE_ALFRED, "end")
        ):
            # Close the front door's span where the op leaves the service
            # (the reference's alfred end stamp): without this, spans()
            # could never produce ``alfred_ms`` on the per-op path. The
            # sampler gate keeps client-supplied wire traces out of the
            # registry when the service isn't sampling; the already-ended
            # guard keeps replays from double-observing.
            tracing.stamp(msg.traces, tracing.STAGE_ALFRED, "end")
            metrics.observe_stage_spans(tracing.spans(msg.traces))
        doc.op_log.append(msg)
        for conn in doc.connections.values():
            conn.inbox.append(msg)
        if (
            self.service_summary_every
            and msg.sequence_number - doc.service_summary_head
            >= self.service_summary_every
        ):
            self._write_service_summary(doc)

    def _write_service_summary(self, doc: _DocState) -> None:
        """Write the op tail since the last service summary as a durable
        blob (the scribe's periodic service summary — storage alone can
        then reconstruct the stream without any client summarizer)."""
        from fluidframework_tpu_torch.service.codec import encode_value

        tail = [
            m
            for m in doc.op_log
            if m.sequence_number > doc.service_summary_head
        ]
        if not tail:
            return
        handle = self.store.put_blob(encode_value(tail))
        doc.service_summaries.append(
            (handle, doc.service_summary_head, tail[-1].sequence_number)
        )
        doc.service_summary_head = tail[-1].sequence_number

    def read_service_summaries(self, doc_id: str) -> List[SequencedDocumentMessage]:
        """Reconstruct the sequenced stream purely from service-summary
        blobs (the storage-only recovery path)."""
        from fluidframework_tpu_torch.service.codec import decode_value

        out: List[SequencedDocumentMessage] = []
        for handle, _from, _to in self._doc(doc_id).service_summaries:
            out.extend(decode_value(self.store.get_blob(handle)))
        return out

    # -- delta storage (historical op fetch, driver storage.ts:81) -----------

    def doc_head(self, doc_id: str) -> int:
        """Latest durable sequence number (cheap push-delivery probe)."""
        log = self._doc(doc_id).op_log
        return log[-1].sequence_number if log else 0

    def ops_range(
        self, doc_id: str, from_seq: int, to_seq: int
    ) -> List[SequencedDocumentMessage]:
        """Ops in [from_seq, to_seq] by index offset — O(k) push delivery
        (the log is seq-ordered and contiguous from its first entry)."""
        log = self._doc(doc_id).op_log
        if not log:
            return []
        first = log[0].sequence_number
        lo = max(0, from_seq - first)
        hi = max(0, to_seq - first + 1)
        return list(log[lo:hi])

    def get_deltas(
        self, doc_id: str, from_seq: int = 0, to_seq: Optional[int] = None
    ) -> List[SequencedDocumentMessage]:
        log = self._doc(doc_id).op_log
        return [
            m
            for m in log
            if m.sequence_number > from_seq
            and (to_seq is None or m.sequence_number <= to_seq)
        ]
