"""The full ordering pipeline assembled from partitioned lambdas.

Reference: the routerlicious op path (SURVEY.md §3.3) —
``alfred -> Kafka(rawdeltas) -> deli -> Kafka(deltas) -> {scriptorium,
scribe, broadcaster} -> client sockets`` — wired over the in-proc
:class:`~fluidframework_tpu_torch.service.queue.PartitionedLog` exactly as
``memory-orderer/src/localOrderer.ts`` wires the production lambdas over
``LocalKafka``. The front door (``PipelineFluidService``) exposes the same
surface as ``LocalFluidService`` so any ContainerRuntime runs unchanged on
the full pipeline; crash recovery = restart a runner from its checkpoint
and replay (deterministic re-production, idempotent consumers).

Counterpart of ``fluidframework_tpu/service/pipeline.py``, the same code
on the port's host tier and device stage. The service takes one argument
the reference lacks, ``device_torch``: the torch device of its
``DeviceFleetBackend``, ``"cuda"`` by default (it raises without a card;
``"cpu"`` runs the plain PyTorch versions, for the tests). ``device_kernel``
is ``"auto"``, ``"cuda"`` or ``"plain"``. ``device_mesh=`` is a
:class:`~fluidframework_tpu_torch.parallel.mesh.Mesh` (an ordered device
list) whose first device is ``device_torch``; with
``device_sharded_overflow=True`` a channel that outgrows the top tier
re-homes into a ``ShardedDoc`` over :func:`parallel.mesh.devices`.
"""

from __future__ import annotations

import itertools
import uuid
from typing import Any, Callable, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    NackErrorType,
    NackMessage,
    SequencedDocumentMessage,
    SignalMessage,
)
from fluidframework_tpu_torch.telemetry import LumberEventName, Lumberjack
from fluidframework_tpu_torch.service.lambdas import (
    DELTAS_TOPIC,
    RAW_TOPIC,
    SIGNALS_TOPIC,
    BroadcasterLambda,
    CheckpointStore,
    DeliDocLambda,
    DocOpLog,
    DocumentLambda,
    PartitionRunner,
    ScribeDocLambda,
    ScriptoriumLambda,
    SignalBroadcasterLambda,
    stored_message,
)
from fluidframework_tpu_torch.service import retry
from fluidframework_tpu_torch.service.admission import (
    AdmissionController,
    OverloadController,
)
from fluidframework_tpu_torch.service.queue import PartitionedLog
from fluidframework_tpu_torch.service.summary_store import SummaryStore
from fluidframework_tpu_torch.telemetry import journal, tracing
from fluidframework_tpu_torch.testing.faults import inject_fault
from fluidframework_tpu_torch.utils import resolve_device


class PipelineConnection:
    """Client connection surface (same as LocalConnection) fed by the
    broadcaster lambda instead of directly by the sequencer."""

    def __init__(
        self,
        service: "PipelineFluidService",
        doc_id: str,
        token: str,
        tenant: str = "local",
    ):
        self.doc_id = doc_id
        self.token = token
        self.tenant = tenant  # admission-budget scope (riddler tenant)
        self.client_id: int = -1  # set once the sequenced join arrives
        self.join_seq: int = 0  # its sequence number (slot-recycling echo guard)
        self.conn_no: int = 0  # never-recycled ordinal (content-id scoping)
        self.service = service
        self.inbox: List[SequencedDocumentMessage] = []
        self.signals: List[SignalMessage] = []
        self.nacks: List[NackMessage] = []
        self.on_nack: Optional[Callable[[NackMessage], None]] = None
        self.initial_summary: Optional[tuple] = None
        self.delivered_seq = 0  # replay-idempotence watermark
        self.delivered_signal = 0

    def submit(self, msg: DocumentMessage) -> None:
        self.service.submit(self.doc_id, self.client_id, msg)

    def submit_frame(self, frame) -> None:
        """Submit a batched binary op frame (protocol/opframe.py) — the
        high-throughput wire; per-op ``submit`` remains the compat path."""
        self.service.submit_frame(self.doc_id, self.client_id, frame)

    def submit_signal(self, content) -> None:
        self.service.submit_signal(self.doc_id, self.client_id, content)

    # The socket server pumps the service ONCE per drain tick and then
    # drains every session without re-pumping (a per-session pump made
    # the drain O(sessions^2) in pipeline sweeps).
    supports_nopump = True

    def take_inbox(
        self, n: Optional[int] = None, *, pump: bool = True
    ) -> List[SequencedDocumentMessage]:
        if pump:
            self.service.pump()
        if any(not hasattr(m, "sequence_number") for m in self.inbox):
            # Frames ride the inbox whole (one broadcaster append per
            # frame); expand to per-op messages at the consumption edge.
            flat: List[SequencedDocumentMessage] = []
            for m in self.inbox:
                if hasattr(m, "sequence_number"):
                    flat.append(m)
                else:
                    flat.extend(m.messages())
            self.inbox[:] = flat
        n = len(self.inbox) if n is None else min(n, len(self.inbox))
        out, self.inbox[:] = self.inbox[:n], self.inbox[n:]
        return out

    def take_inbox_raw(self, *, pump: bool = True) -> list:
        """Drain the inbox WITHOUT expanding frames — for frame-capable
        transports (the network server ships SeqFrames as one binary
        websocket frame instead of n JSON ops)."""
        if pump:
            self.service.pump()
        out, self.inbox[:] = list(self.inbox), []
        return out

    def disconnect(self) -> None:
        self.service.disconnect(self.doc_id, self.client_id)


class PipelineFluidService:
    """Front door + lambda pipeline (alfred + localOrderer equivalent)."""

    def __init__(
        self,
        n_partitions: int = 4,
        checkpoint_every: int = 10,
        messages_per_trace: int = 0,
        device_backend: bool = True,
        device_capacity: int = 128,
        device_max_capacity: int = 1 << 16,
        device_sharded_overflow: bool = False,
        device_max_batch: int = 512,
        device_flush_min_rows: int = 1,
        device_mesh=None,
        device_kernel: str = "auto",
        device_pump: bool = True,
        device_ring_depth: int = 2,
        device_feed_deadline_ms: float = 3.0,
        device_max_resident: int = 0,
        foreman_tasks: tuple = ("summarizer",),
        index_sink: Optional[Any] = None,
        log: Optional[Any] = None,
        store: Optional[Any] = None,
        admission: Optional[AdmissionController] = None,
        overload: Optional[OverloadController] = None,
        device_torch="cuda",
    ):
        # The overload envelope: admission buckets checked ahead of
        # sequencing on every write submit (the alfred/deli admission
        # seam — an over-budget write is nacked with ThrottlingError +
        # retry_after, NEVER dropped), and tiered load-shedding driven by
        # the device backend's pressure signal. The defaults are
        # permissive (inf budgets, NORMAL tier) — the envelope engages
        # through configuration or the registry-fed autotune.
        self.admission = admission if admission is not None else (
            AdmissionController()
        )
        self.overload = overload if overload is not None else (
            OverloadController()
        )
        # Pluggable durability seam: any object
        # with the PartitionedLog / SummaryStore duck interfaces — in
        # particular the out-of-proc adapters in service/store_server.py,
        # which make THIS process disposable.
        self.log = log if log is not None else PartitionedLog(n_partitions)
        self.store = store if store is not None else SummaryStore()
        self.checkpoints = CheckpointStore()
        # The historian-backed read tier: REST catch-up and
        # snapshot reads route through this caching façade — immutable
        # delta chunks, the LatestSummaryCache'd summary pointer, and
        # blob reads through a CachingBlobBackend over the store — so
        # cold catch-up never pumps the sequencing loop.
        from fluidframework_tpu_torch.service.historian import HistorianReadTier

        self.read_tier = HistorianReadTier(self)
        # Sampled op tracing at the front door (alfred stamps 1-in-N,
        # reference config.json:58 numberOfMessagesPerTrace; 0 = off).
        self.trace_sampler = (
            tracing.TraceSampler(messages_per_trace) if messages_per_trace else None
        )
        # Frame-spine ledger: sampled frames' trace lists live here until
        # every stage (broadcast + device commit when a device stage runs)
        # has stamped; pump() reaps complete ones into the metrics
        # registry. Untraced frames never touch it (zero steady-state
        # cost — the sampler gate is the only per-frame branch).
        self.trace_book = tracing.TraceBook(expect_device=device_backend)
        self.ops_store: Dict[str, DocOpLog] = {}
        self.rooms: Dict[str, list] = {}
        self._token_counter = itertools.count(1)
        self._deli = self._make_deli(checkpoint_every)
        self._scribe = self._make_scribe(checkpoint_every)
        self._scriptorium = PartitionRunner(
            self.log, DELTAS_TOPIC, "scriptorium",
            lambda p, s: ScriptoriumLambda(self.ops_store),
            self.checkpoints, checkpoint_every,
        )
        self._broadcaster = PartitionRunner(
            self.log, DELTAS_TOPIC, "broadcaster",
            lambda p, s: BroadcasterLambda(
                self.rooms, observe_traces=self.trace_sampler is not None
            ),
            self.checkpoints, checkpoint_every,
        )
        self._signals = PartitionRunner(
            self.log, SIGNALS_TOPIC, "signal-broadcaster",
            lambda p, s: SignalBroadcasterLambda(self.rooms),
            self.checkpoints, checkpoint_every,
        )
        # Foreman: service-side task assignment on the sequenced stream
        # (reference lambdas/src/foreman/lambda.ts:20); assignments ride
        # back through deli as service-originated signals.
        self._foreman: Optional[PartitionRunner] = None
        if foreman_tasks:
            from fluidframework_tpu_torch.service.foreman import ForemanDocLambda

            def foreman_factory(p: int, state):
                # Foreman only reads sequenced join/leave records: the
                # wants filter keeps the frame stream (and its per-record
                # dirty-marking/checkpoint cost) out of this stage.
                lam = DocumentLambda(
                    lambda doc_id, s: ForemanDocLambda(
                        doc_id, s, tasks=tuple(foreman_tasks)
                    ),
                    wants=frozenset({"seq"}),
                )
                lam.restore_docs(state)
                return lam

            self._foreman = PartitionRunner(
                self.log, DELTAS_TOPIC, "foreman", foreman_factory,
                self.checkpoints, checkpoint_every,
            )
        # Moira: changeset streaming to an external (non-Fluid) index
        # sink with at-least-once delivery + checkpointed resume
        # (lambdas/src/moira/lambda.ts:19). Opt-in via ``index_sink``.
        self.index_sink = index_sink
        self._moira: Optional[PartitionRunner] = None
        if index_sink is not None:
            from fluidframework_tpu_torch.service.moira import MoiraLambda

            self._moira = PartitionRunner(
                self.log, DELTAS_TOPIC, "moira",
                lambda p, s: MoiraLambda(index_sink, s),
                self.checkpoints, checkpoint_every,
            )
        # The device-apply stage (TpuDeliLambda): the service's replica of
        # every string channel lives in a DocFleet on the accelerator.
        # Deliberately NOT in self.checkpoints — its durable form is the
        # deltas log itself; crash recovery replays from offset 0 (see
        # service/device_lambda.py).
        self.device: Optional[Any] = None
        self._device_runner: Optional[PartitionRunner] = None
        # Pump-quiescence auto-flush threshold: 1 = flush every pump (the
        # in-proc test semantics); a serving front door raises it so each
        # client submit doesn't pay a device boxcar — sub-threshold rows
        # ride the next read/explicit flush or the network server's
        # time-based idle flush (network_server._drain_all).
        self.device_flush_min_rows = device_flush_min_rows
        if device_backend:
            self._make_device(
                device_capacity, device_max_capacity,
                device_sharded_overflow, device_max_batch, device_mesh,
                device_kernel, device_pump, device_ring_depth,
                device_feed_deadline_ms, device_max_resident,
                resolve_device(device_torch),
            )

    def _make_device(
        self, capacity: int, max_capacity: int, sharded_overflow: bool,
        max_batch: int = 512, mesh=None, kernel: str = "auto",
        pump: bool = True, ring_depth: int = 2,
        feed_deadline_ms: float = 3.0, max_resident: int = 0,
        torch_device="cuda",
    ) -> None:
        from fluidframework_tpu_torch.service.device_backend import (
            DeviceFleetBackend,
        )
        from fluidframework_tpu_torch.service.device_lambda import TpuDeliLambda

        # pump/ring_depth: the continuous device pump — flushes
        # ride the double-buffered ingest ring + AOT donated entries;
        # pump=False keeps the one-shot path (the parity reference).
        # feed_deadline_ms: the continuous front door — the hybrid
        # size/time boxcar trigger the pump sweep and the network
        # server's deadline ticker fire (DeviceFleetBackend.pump_feed).
        self.device = DeviceFleetBackend(
            capacity=capacity, max_capacity=max_capacity,
            sharded_overflow=sharded_overflow, max_batch=max_batch,
            mesh=mesh, kernel=kernel, pump_mode=pump,
            ring_depth=ring_depth, feed_deadline_ms=feed_deadline_ms,
            max_resident=max_resident, device=torch_device,
        )
        self._device_capacity = (
            capacity, max_capacity, sharded_overflow, max_batch, mesh,
            kernel, pump, ring_depth, feed_deadline_ms, max_resident,
            torch_device,
        )

        def factory(p: int, state):
            return DocumentLambda(
                lambda doc_id, s: TpuDeliLambda(doc_id, self.device),
                wants=frozenset({"seq", "seqframe"}),
            )

        self._device_runner = PartitionRunner(
            self.log, DELTAS_TOPIC, "tpu-deli", factory,
            CheckpointStore(),  # throwaway: never restored across crashes
            checkpoint_every=1 << 30,
        )

    # -- lambda (re)construction: also the crash-recovery entry points --------

    def _make_deli(self, checkpoint_every: int) -> PartitionRunner:
        def factory(p: int, state):
            lam = DocumentLambda(lambda doc_id, s: DeliDocLambda(doc_id, s))
            lam.restore_docs(state)
            return lam

        return PartitionRunner(
            self.log, RAW_TOPIC, "deli", factory, self.checkpoints,
            checkpoint_every,
        )

    def _make_scribe(self, checkpoint_every: int) -> PartitionRunner:
        def factory(p: int, state):
            # Scribe acts only on sequenced Summarize records; frames are
            # pure data plane and skip the stage wholesale.
            lam = DocumentLambda(
                lambda doc_id, s: ScribeDocLambda(doc_id, s, self.store),
                wants=frozenset({"seq"}),
            )
            lam.restore_docs(state)
            return lam

        return PartitionRunner(
            self.log, DELTAS_TOPIC, "scribe", factory, self.checkpoints,
            checkpoint_every,
        )

    def crash_deli(self, checkpoint_every: int = 10) -> None:
        """Kill the deli runner and restart it from its last checkpoint —
        uncheckpointed input replays; output dedup is downstream."""
        self._deli = self._make_deli(checkpoint_every)

    def crash_scribe(self, checkpoint_every: int = 10) -> None:
        self._scribe = self._make_scribe(checkpoint_every)

    def crash_moira(self, checkpoint_every: int = 10) -> None:
        """Kill and restart the changeset streamer from its checkpoint —
        uncheckpointed deltas replay; the sink's guid upsert absorbs them
        (at-least-once, moira/lambda.ts's crash model)."""
        from fluidframework_tpu_torch.service.moira import MoiraLambda

        self._moira = PartitionRunner(
            self.log, DELTAS_TOPIC, "moira",
            lambda p, s: MoiraLambda(self.index_sink, s),
            self.checkpoints, checkpoint_every,
        )

    def checkpoint_all(self) -> None:
        runners = [self._deli, self._scribe, self._scriptorium,
                   self._broadcaster, self._signals]
        if self._foreman is not None:
            runners.append(self._foreman)
        if self._moira is not None:
            runners.append(self._moira)
        for r in runners:
            r.checkpoint()

    # -- the pipeline pump -----------------------------------------------------

    def pump(self) -> int:
        """Run every stage until the whole pipeline is quiescent (the
        in-proc analog of the async Kafka stages all catching up).

        The device stage is fed CONTINUOUSLY inside the sweep:
        after each tpu-deli ingest chunk, ``pump_feed`` stages any
        boxcar that hit ``max_batch`` or outlived the feed deadline and
        dispatches it while deli/scribe/scriptorium keep pumping — the
        quiescence-time flush below survives only as the final drain +
        err-surface barrier, and the one-shot path stays bit-exact
        (feeds ride the same stage/dispatch machinery as flush)."""
        total = 0
        while True:
            n = (
                self._deli.pump()
                + self._scribe.pump()
                + self._scriptorium.pump()
                + self._broadcaster.pump()
                + self._signals.pump()
            )
            if self._device_runner is not None:
                nd = self._device_runner.pump()
                n += nd
                if nd and self.device is not None and self.device.pump_mode:
                    # One continuous-feed tick WHILE the other stages
                    # are still busy — the front-door streaming.
                    # Opportunistic: an injected tick fault is counted
                    # and absorbed (pump_feed_absorbed); the quiescence
                    # flush below is the correctness backstop.
                    self.device.pump_feed_absorbed()
            if self._foreman is not None:
                n += self._foreman.pump()
            if self._moira is not None:
                from fluidframework_tpu_torch.service.moira import SinkUnavailable

                try:
                    n += self._moira.pump()
                except SinkUnavailable:
                    # External index outage: the offset did not advance;
                    # the next pump retries (at-least-once). The rest of
                    # the pipeline keeps serving.
                    pass
            total += n
            if n == 0:
                # One overload-tier evaluation per pump (the sweep half
                # of the backpressure propagation; the network server's
                # deadline ticker is the other): ring/queue/feed-lag
                # pressure from the device backend drives the shed tier
                # BEFORE the quiescence flush below relieves it, so a
                # sustained overload raises the tier instead of growing
                # the in-process queues. Cheap: pure host state, and the
                # gauge only writes on a transition.
                if self.device is not None:
                    self.overload.observe(self.device.pressure())
                # Quiescent: boxcar any freshly buffered device rows and
                # surface err-lane feedback — nacks reach clients on the
                # ingestion path. The auto-flush here skips the health-
                # scan barrier (collect_now): the scan streams back
                # asynchronously and its errors surface within one more
                # pump — a per-pump synchronous readback would put the
                # device round-trip latency on EVERY front-door submit.
                if self.device is not None and self.device.needs_flush(
                    self.device_flush_min_rows
                ):
                    # needs_flush covers buffered rows at/above the
                    # threshold, unreported err channels, AND ring slots
                    # requeued by a dispatch crash — the drain contract
                    # must not depend on future traffic.
                    self.device.flush()
                    self._nack_device_errors()
                elif (
                    self.device is not None
                    and self.device.needs_scan_drain()
                ):
                    # No new rows, but the LAST boxcar's health scan is
                    # still streaming: drain it so its capacity errors
                    # surface on the ingestion path even if the stream
                    # then goes idle (a direct embedder may never pump
                    # again; the nack must not depend on future traffic).
                    self.device.collect_now()
                    self._nack_device_errors()
                if self.trace_sampler is not None:
                    # Sampled frames whose last stage stamped this sweep
                    # reduce into the registry now (tracing.spans).
                    self.trace_book.reap()
                return total

    # -- the device serving surface -------------------------------------------

    def flush_device(self) -> None:
        """Boxcar every buffered device row into batched kernel dispatches
        and turn any newly tripped err lanes into nacks + telemetry (the
        deli control-plane feedback: reference deli/lambda.ts nack
        branches)."""
        if self.device is None:
            return
        self.device.flush()
        # Barrier the async health scan: nacks must reflect THIS flush,
        # not the previous boxcar's (the serving loop's intra-flush scans
        # are deliberately one boxcar stale).
        self.device.collect_now()
        self._nack_device_errors()
        if self.trace_sampler is not None:
            self.trace_book.reap()

    def _nack_device_errors(self) -> None:
        for doc_id, address in self.device.take_errors():
            Lumberjack.new_metric(
                LumberEventName.DeviceCapacity,
                {"tenantId": "local", "documentId": doc_id,
                 "address": address},
            ).error("device channel capacity exceeded")
            nack = NackMessage(
                sequence_number=0,
                content_code=429,
                error_type=NackErrorType.LIMIT_EXCEEDED,
                message=f"channel {address} exceeded device capacity",
            )
            for conn in self.rooms.get(doc_id, []):
                conn.nacks.append(nack)
                if conn.on_nack:
                    conn.on_nack(nack)

    def device_text(self, doc_id: str, channel_id: str) -> str:
        """Read a string channel's current text straight from the device
        replica — the serving path that never touches a client."""
        assert self.device is not None, "device backend disabled"
        self.pump()
        self.flush_device()
        return self.device.text(doc_id, channel_id)

    def device_summary(self, doc_id: str, channel_id: str):
        """Channel summary produced from device state (the device-scribe
        producer; see service/device_scribe.py for the service stage)."""
        assert self.device is not None, "device backend disabled"
        self.pump()
        self.flush_device()
        return self.device.channel_summary(doc_id, channel_id)

    def crash_device(self) -> None:
        """Kill the device stage (fleet state and consumer offsets gone)
        and restart it cold: the new consumer replays the deltas log from
        offset zero and deterministically rebuilds every channel replica.

        Residency note: the crash also loses the in-RAM cold-tier
        records and the residency state machine — every replayed doc
        re-admits RESIDENT. That is the documented recovery: cold records
        are a cache of the durable tier (LatestSummaryCache pointer +
        DocOpLog delta tail), and the replay rebuilds the same state the
        wake path would have restored."""
        assert self.device is not None, "device backend disabled"
        self._make_device(*self._device_capacity)

    # -- residency: the hibernation sweep -------------------------------------

    def _deli_doc(self, doc_id: str):
        from fluidframework_tpu_torch.service.queue import partition_of

        p = partition_of(doc_id, self.log.n_partitions)
        lam = self._deli._lambdas.get(p)
        return None if lam is None else lam._docs.get(doc_id)  # type: ignore[attr-defined]

    def doc_is_idle(self, doc_id: str) -> bool:
        """The deli sequencer's client-lifecycle idleness signal: no live
        clients (every client expired or departed — the state in which
        the sequencer emits its NoClient system op). A doc the deli has
        never sequenced has no clients either."""
        dd = self._deli_doc(doc_id)
        return dd is None or not dd.sequencer.clients

    def hibernate_sweep(self, max_docs: int = 8) -> List[str]:
        """One residency sweep: close a heat decay window, step clientless
        RESIDENT docs to IDLE (the sequencer lifecycle signal), then for
        each cold-enough candidate run the hibernate walk — summarize the
        doc's channels from device state (the device-scribe producer),
        land the durable pointer in the historian's LatestSummaryCache,
        and evict the fleet slots. Bounded by ``max_docs`` per call so a
        ticker can run it without an unbounded stall; returns the doc ids
        hibernated. The serving loop never calls this inline — the
        network server's deadline ticker and tests/benches do."""
        if self.device is None:
            return []
        rm = self.device.residency
        rm.heat.observe_window()
        for doc_id in rm.resident_docs():
            if self.doc_is_idle(doc_id):
                rm.mark_idle(doc_id)
        done: List[str] = []
        for doc_id in rm.hibernation_candidates(want=max_docs):
            if not self.device.hibernate_eligible(doc_id):
                continue
            if self._hibernate_one(doc_id):
                done.append(doc_id)
        return done

    def _hibernate_one(self, doc_id: str) -> bool:
        """The summarize→durable-pointer→evict walk for one document.
        The batched channel gather doubles as the evict states (the
        commit re-uses it — one readback for the whole walk)."""
        device = self.device
        keys = [k for k in device.channels() if k[0] == doc_id]
        if not keys:
            return False
        states = device.doc_states(keys)
        summary = {
            "channels": {
                addr: device.summary_from_state((d, addr), st)
                for (d, addr), st in states.items()
            },
            "doc_id": doc_id,
            "head": max(
                device.applied_seq[k] for k in keys
            ),
        }
        handle = self.store.put_summary(summary)
        self.read_tier.latest.update(doc_id, handle)
        return device.hibernate_doc(doc_id, states)

    # -- the LocalFluidService-compatible surface ------------------------------

    def connect(
        self,
        doc_id: str,
        mode: str = "write",
        from_seq: int = 0,
        tenant: str = "local",
    ) -> PipelineConnection:
        self.pump()  # settle before computing the catch-up point
        # Token must be unique ACROSS service generations: a replacement
        # process replays the durable log, and a recycled token would
        # match an old generation's JOIN and steal its identity (the
        # reference's client ids are GUIDs for the same reason).
        token = f"c{next(self._token_counter)}-{uuid.uuid4().hex[:10]}"
        conn = PipelineConnection(self, doc_id, token, tenant=tenant)
        scribe_doc = self._scribe_doc(doc_id)
        if from_seq == 0 and scribe_doc and scribe_doc.latest_summary:
            conn.initial_summary = scribe_doc.latest_summary
            from_seq = scribe_doc.latest_summary[1]
        # Backfill from the durable op log, then join the live room.
        for seq in sorted(self.ops_store.get(doc_id, {})):
            if seq > from_seq:
                conn.inbox.append(stored_message(self.ops_store[doc_id][seq]))
                conn.delivered_seq = seq
        conn.delivered_seq = max(conn.delivered_seq, from_seq)
        self.rooms.setdefault(doc_id, []).append(conn)
        self._send_raw(doc_id, {"t": "join", "mode": mode, "token": token})
        self.pump()
        for msg in conn.inbox:
            # Live frame traffic from other writers may land raw
            # SeqFrames here; they are never joins — skip, don't expand.
            if (
                getattr(msg, "type", None) == MessageType.CLIENT_JOIN
                and msg.contents.get("token") == token
            ):
                conn.client_id = msg.contents["clientId"]
                conn.join_seq = msg.sequence_number
                conn.conn_no = msg.contents.get("connNo", 0)
                break
        if conn.client_id < 0:
            self.rooms[doc_id].remove(conn)
            nack = conn.nacks[0] if conn.nacks else None
            raise ConnectionError(nack.message if nack else "join failed")
        return conn

    def _send_raw(self, doc_id: str, rec: dict) -> None:
        """Front-door produce onto rawdeltas through the unified retry
        policy: a transient ``queue.send`` failure is retried with
        backoff; exhaustion raises to the caller — the nack analog for
        the ingest path (the client resubmits; csn dedup at deli absorbs
        anything that half-landed)."""
        retry.call_with_retry("queue.send", self.log.send, RAW_TOPIC, doc_id, rec)

    def disconnect(self, doc_id: str, client_id: int) -> None:
        self.rooms[doc_id] = [
            c for c in self.rooms.get(doc_id, []) if c.client_id != client_id
        ]
        self._send_raw(doc_id, {"t": "leave", "client": client_id})
        self.pump()

    def _admit_write(
        self, doc_id: str, client_id: int, n_ops: int, csn: int = -1
    ) -> bool:
        """The front-door admission check (the alfred/deli seam):
        over-budget writes are NACKED with ``ThrottlingError`` + a
        computed ``retry_after`` — never dropped, never sequenced — so
        the client's existing nack-resubmit loop carries the recovery
        (it paces on the retry-after and re-offers the op; csn dedup
        absorbs nothing because nothing landed). Admission runs BEFORE
        anything reaches the partition queue: client merge is
        deterministic only if the server never silently drops a
        SEQUENCED op, so overload handling must live ahead of
        sequencing. A crashed check fails closed inside
        ``AdmissionController.decide``."""
        adm = self.admission
        conn = None
        scanned = False
        tenant = "local"
        if journal._ON:
            # The submit event anchors the op's PRE-sequencing identity
            # (doc, client, csn) in the flight recorder — the half of
            # the lineage that exists before a sequence number does.
            journal.record(
                "frame.submit", doc=doc_id, client=client_id, csn=csn,
                csn_hi=(csn + n_ops - 1) if csn >= 0 else None,
                n=n_ops,
            )
        if not adm.permissive():
            # Tenant resolution (a bounded room scan — MAX_WRITERS
            # entries) only once the envelope is engaged; the
            # permissive default rides decide()'s allocation-free fast
            # path with no per-frame scan.
            conn = self._room_conn(doc_id, client_id)
            scanned = True
            if conn is not None:
                tenant = conn.tenant
        d = adm.decide(tenant, doc_id, n_ops, tier=self.overload.tier)
        if journal._ON:
            journal.record(
                "admission.admit" if d.admitted else "admission.deny",
                doc=doc_id, client=client_id, csn=csn,
                csn_hi=(csn + n_ops - 1) if csn >= 0 else None,
                **(
                    {}
                    if d.admitted
                    else {
                        "reason": d.reason,
                        "retry_after_ms": round(d.retry_after_ms, 3),
                    }
                ),
            )
        if d.admitted:
            return True
        if not scanned:
            conn = self._room_conn(doc_id, client_id)
        if conn is None:
            # Denial for a connection no longer in the room (raced
            # disconnect): there is nowhere to deliver the nack —
            # harmless (the client's reconnect path resubmits its
            # pending ops), but counted, never silent.
            from fluidframework_tpu_torch.service.admission import (
                admission_denied_counter,
            )

            admission_denied_counter().inc(reason="nack_undeliverable")
            return False
        self._deliver_throttle_nack(
            conn, csn, d.retry_after_ms, d.reason
        )
        return False

    @staticmethod
    def _deliver_throttle_nack(
        conn: PipelineConnection, csn: int, retry_after_ms: float,
        reason: str,
    ) -> None:
        nack = NackMessage(
            sequence_number=0,
            content_code=429,
            error_type=NackErrorType.THROTTLING,
            message=f"admission throttled ({reason})",
            retry_after_s=retry_after_ms / 1e3,
            client_sequence_number=csn,
        )
        conn.nacks.append(nack)
        if conn.on_nack:
            conn.on_nack(nack)

    def _room_conn(
        self, doc_id: str, client_id: int
    ) -> Optional[PipelineConnection]:
        """The live room connection for ``client_id``, or None."""
        return next(
            (
                c for c in self.rooms.get(doc_id, [])
                if c.client_id == client_id
            ),
            None,
        )

    def submit(self, doc_id: str, client_id: int, msg: DocumentMessage) -> None:
        if msg.type == MessageType.OPERATION and not self._admit_write(
            doc_id, client_id, 1, csn=msg.client_sequence_number
        ):
            return
        if self.trace_sampler is not None and self.trace_sampler.should_trace():
            tracing.stamp(msg.traces, "alfred", "start")
        self._send_raw(doc_id, {"t": "op", "client": client_id, "msg": msg})
        self.pump()

    def submit_frame(self, doc_id: str, client_id: int, frame) -> None:
        """Front-door ingest for the batched binary wire: one raw record
        per frame; deli tickets it vectorized (sequencer.ticket_frame).
        Sampled frames (alfred's 1-in-N gate, same knob as the per-op
        wire) carry a trace list on the RECORD envelope — the binary
        frame wire itself never changes — stamped at every stage
        boundary downstream."""
        if not self._admit_write(
            doc_id, client_id, frame.n, csn=frame.csn0
        ):
            return
        rec = {"t": "opframe", "client": client_id, "frame": frame}
        if self.trace_sampler is not None and self.trace_sampler.should_trace():
            traces = self.trace_book.open()
            tracing.stamp(traces, tracing.STAGE_ALFRED, "start")
            rec["traces"] = traces
        self._send_raw(doc_id, rec)
        self.pump()

    def submit_frames_bulk(self, items, pump: bool = True) -> None:
        """Batched front-door ingest: ``items`` is an iterable of
        ``(doc_id, client_id, OpFrame)``. All frames land on rawdeltas in
        one boxcar append and the pipeline pumps ONCE — the per-submit
        pump is O(stages) even when quiescent, which at 10k frames/round
        was a measurable share of the serving path (the reference batches
        the same way: socket submits boxcar into one Kafka produce,
        ``pendingBoxcar.ts``)."""
        sampler = self.trace_sampler
        # Admission gates the BULK front door too: frames admit
        # or nack per-doc-budget — an admitted NEIGHBOR (different
        # client) is unaffected by a throttled one — but a denial is
        # STICKY per (doc, client) for the rest of the batch: admitting
        # a later frame from the same client after denying an earlier
        # one would hand the sequencer a csn gap (a 400 nack the client
        # cannot pace on). The caller can't react mid-batch, so the
        # server enforces the ordering the client contract (resubmit
        # from the denied csn) otherwise provides across calls.
        entries = []
        denied: Dict[tuple, float] = {}
        for doc_id, client_id, frame in items:
            key = (doc_id, client_id)
            if key in denied:
                conn = self._room_conn(doc_id, client_id)
                if conn is not None:
                    self._deliver_throttle_nack(
                        conn, frame.csn0, denied[key], "csn_order"
                    )
                continue
            if not self._admit_write(
                doc_id, client_id, frame.n, csn=frame.csn0
            ):
                conn = self._room_conn(doc_id, client_id)
                denied[key] = (
                    conn.nacks[-1].retry_after_s * 1e3
                    if conn is not None and conn.nacks else 25.0
                )
                continue
            rec = {"t": "opframe", "client": client_id, "frame": frame}
            if sampler is not None and sampler.should_trace():
                traces = self.trace_book.open()
                tracing.stamp(traces, tracing.STAGE_ALFRED, "start")
                rec["traces"] = traces
            entries.append((doc_id, rec))
        if entries:  # a fully-throttled round produces nothing: the
            # queue.send boundary (and any chaos policy armed on it)
            # must not fire for an empty batch.
            send_batch = getattr(self.log, "send_batch", None)
            if send_batch is not None:
                retry.call_with_retry(
                    "queue.send", send_batch, RAW_TOPIC, entries
                )
            else:  # minimal log impls only expose send
                for key, value in entries:
                    retry.call_with_retry(
                        "queue.send", self.log.send, RAW_TOPIC, key, value
                    )
        if pump:
            self.pump()

    def submit_signal(self, doc_id: str, client_id: int, content) -> None:
        self._send_raw(
            doc_id, {"t": "signal", "client": client_id, "content": content}
        )
        self.pump()

    def doc_head(self, doc_id: str) -> int:
        """Latest durable sequence number — a cheap probe (no pump) for
        push-delivery idle ticks (O(1): DocOpLog tracks its head)."""
        ops = self.ops_store.get(doc_id)
        return ops.head if ops is not None else 0

    def ops_range(
        self, doc_id: str, from_seq: int, to_seq: int,
        pump: bool = True,
    ) -> List[SequencedDocumentMessage]:
        """Ops in [from_seq, to_seq] by direct seq lookup — O(k) for push
        delivery, vs get_deltas's full-log sort. ``pump=False`` is the
        read tier's no-pump form: catch-up reads served from the
        durable log must never drive the sequencing loop."""
        if pump:
            self.pump()
        ops = self.ops_store.get(doc_id, {})
        return [
            stored_message(ops[s])
            for s in range(from_seq, to_seq + 1)
            if s in ops
        ]

    def log_entries(
        self, doc_id: str, from_seq: int, to_seq: int
    ) -> List[tuple]:
        """Durable-log entries overlapping [from_seq, to_seq] in seq
        order, WITHOUT expanding frames: each entry is ``(lo, hi, obj)``
        where ``obj`` is a whole :class:`SeqFrame` (hi = its last seq) or
        a single :class:`SequencedDocumentMessage` (lo == hi). The
        encode-once push fan-out consumes this — one read per (doc,
        sweep) from the group's minimum watermark, frames delivered as
        ONE binary wire frame to every subscriber that negotiated them.
        No pump: push delivery streams what is already durable."""
        log = self.ops_store.get(doc_id)
        if log is None:
            return []
        # Point ops: probe the requested window, not the whole dict —
        # the steady-state window is O(new ops) and a full-dict scan
        # per push sweep would be quadratic over the doc's lifetime.
        # A window far wider than the stored point ops (cold catch-up
        # over a frame-dominated log) flips to the dict scan instead.
        if to_seq - from_seq + 1 <= 4 * len(log.ops):
            entries: List[tuple] = [
                (s, s, log.ops[s])
                for s in range(from_seq, to_seq + 1)
                if s in log.ops
            ]
        else:
            entries = [
                (s, s, m)
                for s, m in log.ops.items()
                if from_seq <= s <= to_seq
            ]
        import bisect

        i = max(0, bisect.bisect_right(log._starts, from_seq) - 1)
        for f in log.frames[i:]:
            if f.first_seq > to_seq:
                break
            if f.last_seq >= from_seq:
                entries.append((f.first_seq, f.last_seq, f))
        entries.sort(key=lambda e: e[0])
        return entries

    def latest_summary_pointer(self, doc_id: str) -> Optional[tuple]:
        """(handle, head) of the doc's latest scribe-acked summary, or
        None — the read tier's no-pump pointer probe (cheap host state;
        the historian façade invalidates its inflated copy on change)."""
        sd = self._scribe_doc(doc_id)
        return sd.latest_summary if sd is not None else None

    def get_deltas(
        self, doc_id: str, from_seq: int = 0, to_seq: Optional[int] = None
    ) -> List[SequencedDocumentMessage]:
        self.pump()
        return [
            stored_message(m)
            for seq, m in sorted(self.ops_store.get(doc_id, {}).items())
            if seq > from_seq and (to_seq is None or seq <= to_seq)
        ]

    def _scribe_doc(self, doc_id: str) -> Optional[ScribeDocLambda]:
        from fluidframework_tpu_torch.service.queue import partition_of

        p = partition_of(doc_id, self.log.n_partitions)
        lam = self._scribe._lambdas[p]
        return lam._docs.get(doc_id)  # type: ignore[attr-defined]


class ReservationManager:
    """Document-placement leases for multi-node ordering.

    Reference: ``memory-orderer/src/reservationManager.ts`` (+ the
    ZooKeeper-style coordination of §2.9): a node must hold the document's
    lease to run its sequencer; leases expire and transfer with a fenced
    epoch so a stale owner can never write after takeover.
    """

    def __init__(self, clock: Callable[[], float]):
        self._clock = clock
        self._leases: Dict[str, dict] = {}

    @inject_fault("lease.acquire")
    def acquire(self, node: str, doc_id: str, ttl_s: float) -> Optional[int]:
        """Returns the fencing epoch if granted, None if another node holds
        an unexpired lease."""
        now = self._clock()
        lease = self._leases.get(doc_id)
        if lease is None or lease["node"] == node or lease["expires"] <= now:
            epoch = (lease["epoch"] + 1) if lease and lease["node"] != node else (
                lease["epoch"] if lease else 1
            )
            self._leases[doc_id] = {
                "node": node, "expires": now + ttl_s, "epoch": epoch,
            }
            return epoch
        return None

    @inject_fault("lease.renew")
    def renew(self, node: str, doc_id: str, ttl_s: float) -> bool:
        lease = self._leases.get(doc_id)
        if lease and lease["node"] == node and lease["expires"] > self._clock():
            lease["expires"] = self._clock() + ttl_s
            return True
        return False

    def release(self, node: str, doc_id: str) -> bool:
        """Voluntary lease surrender (load-driven migration): the holder
        expires its own lease so another node can acquire immediately —
        the acquire still bumps the fencing epoch, so any straggling write
        from the old owner is rejected exactly as after a TTL lapse."""
        lease = self._leases.get(doc_id)
        if lease and lease["node"] == node:
            lease["expires"] = self._clock()
            return True
        return False

    def holder(self, doc_id: str) -> Optional[str]:
        lease = self._leases.get(doc_id)
        if lease and lease["expires"] > self._clock():
            return lease["node"]
        return None
