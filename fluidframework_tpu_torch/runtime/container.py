"""Container runtime — op routing, outbox batching, pending (unacked) state.

Reference: ``packages/runtime/container-runtime`` (``process``
containerRuntime.ts:1843, ``submit`` :2817 → ``Outbox``
opLifecycle/outbox.ts:34, ``PendingStateManager`` pendingStateManager.ts:81)
collapsed with the datastore layer (``packages/runtime/datastore``) into one
host-side runtime: channels (DDS instances) register by id, local ops batch
per explicit ``flush()`` (the JS-turn boundary analog), inbound sequenced
ops route to channels, and the local client's own ops are matched FIFO
against pending state to drive the ack path.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    NackErrorType,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.runtime.gc import GarbageCollector, GCOptions, GCResult
from fluidframework_tpu_torch.runtime.handles import collect_handle_routes, encode_handle
from fluidframework_tpu_torch.runtime.op_lifecycle import (
    DEFAULT_CHUNK_SIZE,
    DEFAULT_COMPRESSION_THRESHOLD,
    RemoteMessageProcessor,
    pack_batch,
)
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.service.local_server import LocalFluidService


class TombstoneError(Exception):
    """Access to a tombstoned (GC'd) object (garbageCollection.ts:415)."""


class ContainerRuntime:
    """One client's runtime for one document."""

    def __init__(
        self,
        service: LocalFluidService,
        doc_id: str,
        channels: tuple = (),
        mode: str = "write",
        compression_threshold: Optional[int] = DEFAULT_COMPRESSION_THRESHOLD,
        chunk_size: Optional[int] = DEFAULT_CHUNK_SIZE,
        gc_options: Optional[GCOptions] = None,
        channel_types: Optional[Dict[str, Callable[[str], SharedObject]]] = None,
        _stashed: Optional[dict] = None,
    ):
        """Connect and catch up to head before becoming interactive
        (reference Container.load, container.ts:300: snapshot + delta replay
        precede any local edit — editing from behind the MSN gets nacked).

        ``channels`` are the DDS instances this container hosts; they must
        exist before catch-up so historical channel ops have a target.
        """
        self.doc_id = doc_id
        self._service = service
        self._mode = mode
        self.connected = True
        stashed = _stashed  # passed by rehydrate()
        self.connection = service.connect(
            doc_id, mode,
            from_seq=stashed["ref_seq"] if stashed is not None else 0,
        )
        self.client_id = self.connection.client_id
        self._join_seq = getattr(self.connection, "join_seq", 0)
        self.conn_no = getattr(self.connection, "conn_no", 0) or (
            self.client_id + 1  # mock services without ordinals don't recycle
        )
        self._offline: list = []  # ops authored while disconnected
        self._offline_folded = 0  # prefix of _offline from resolved drops
        self._offline_proposals: list = []  # proposals made while offline
        # Proposals submitted but not yet seen sequenced: (cseq, key, value).
        # Tracked so a dropped connection can recover them like pending ops.
        self._inflight_proposals: deque = deque()
        self.channels: Dict[str, SharedObject] = {}
        self.ref_seq = 0  # last processed sequence number
        self.min_seq = 0
        self.client_seq = 0  # outbound clientSequenceNumber
        self._last_acked_cseq = 0  # highest own cseq seen sequenced
        # FIFO of (client_seq, channel_id, contents, local_metadata):
        # reference PendingStateManager semantics.
        self.pending: deque = deque()
        # Ungraceful-drop recovery: one entry per dead connection that still
        # has in-flight state of unknown fate — resolved during reconnect
        # catch-up (see drop_connection()). Each generation carries
        # {client_id, join_seq, pending, proposals} (+ resolved flag; the
        # synthetic offline generation uses entries instead of pending).
        # Echo matching needs no upper bound: a client id cannot recycle
        # before its LEAVE, and the LEAVE is what resolves the generation.
        self._prior_gens: list = []
        self._outbox: list = []
        self.compression_threshold = compression_threshold
        self.chunk_size = chunk_size
        self._rmp = RemoteMessageProcessor()
        self._open_batch = False  # inbound batch in flight (ScheduleManager)
        self._open_batch_client: Optional[int] = None  # who opened it
        self.quorum_members: Dict[int, dict] = {}
        # Quorum proposals: pending by seq; approved key -> value.
        self.pending_proposals: Dict[int, tuple] = {}
        self.approved_proposals: Dict[str, Any] = {}
        self.on_op: Optional[Callable[[SequencedDocumentMessage], None]] = None
        self._op_listeners: list = []  # multi-subscriber op tap (helpers)
        # Throttling-nack pacing (the admission-control client half):
        # a 429 ThrottlingError nack carries retry_after_s, and resubmitting
        # before it elapses just earns the same nack again — so the nack
        # loop SLEEPS the retry-after through this cooperative hook before
        # regenerating (tests install a virtual clock; production keeps
        # time.sleep). throttle_waits counts paces for tests/telemetry.
        self.throttle_sleep: Callable[[float], None] = time.sleep
        self.throttle_waits = 0
        # Summary tracking (reference SummaryCollection / RunningSummarizer).
        self.last_summary_seq = 0
        self.summary_interval: Optional[int] = None  # auto-summarize period
        # Incremental summaries (reference ISummaryHandle, summary.ts:10-15):
        # per-channel last-change seq + the last ACKED summary; channels
        # untouched since it upload a handle instead of their full tree.
        self._channel_last_change: Dict[str, int] = {}
        self._acked_summary: Optional[tuple] = None  # (handle, head seq)
        # GC (D.3): root channels are always reachable (aliased datastores);
        # non-root ones live only while a handle somewhere references them.
        self.gc = GarbageCollector(gc_options)
        self._root_ids: set = set()
        # Dynamic-channel machinery (reference datastore attach ops): a type
        # registry lets remote/loading clients reconstruct channels minted at
        # runtime; _channel_types records what to put in summaries.
        self.channel_factories: Dict[str, Callable[[str], SharedObject]] = dict(
            channel_types or {}
        )
        self._channel_types: Dict[str, str] = {}
        # Attaches not yet seen sequenced: resent on reconnect/nack recovery
        # (they live outside the op outbox, so pending-state replay alone
        # would lose them).
        self._pending_attaches: Dict[str, str] = {}
        # Attachment blobs (reference blobManager.ts).
        from fluidframework_tpu_torch.runtime.blob_manager import BlobManager

        self.blobs = BlobManager(self)
        # Channels we couldn't realize (type missing from the registry):
        # ops to them are an error and their summaries carry forward verbatim
        # — silently dropping them would erase data for capable clients.
        self._unrealized: Dict[str, str] = {}
        self._carried_summaries: Dict[str, dict] = {}
        for ch in channels:
            self.create_channel(ch)
        if stashed is not None:
            self._apply_stashed_state(stashed)
        else:
            if self.connection.initial_summary is not None:
                self._load_summary(self.connection.initial_summary)
            self.process_incoming()  # catch up to head

    # -- channels -------------------------------------------------------------

    def create_channel(self, channel: SharedObject, root: bool = True) -> SharedObject:
        """Register a channel (or datastore). ``root=True`` marks it aliased
        (always GC-reachable, reference processAliasMessage semantics);
        ``root=False`` objects survive only while referenced by a handle."""
        assert channel.id not in self.channels, f"duplicate channel {channel.id}"
        channel.attach(self)
        self.channels[channel.id] = channel
        if root:
            self._root_ids.add(channel.id)
        return channel

    def register_channel_type(
        self, type_name: str, ctor: Callable[[str], SharedObject]
    ) -> None:
        """Register a constructible channel type so this client can realize
        channels other clients attach dynamically (and load them from
        summaries)."""
        self.channel_factories[type_name] = ctor

    def attach_channel(
        self, channel: SharedObject, type_name: str, root: bool = False
    ) -> SharedObject:
        """Create a channel at runtime and replicate its existence via an
        ATTACH op (reference datastore attach): remote clients construct it
        from the type registry, so ops on it have a target everywhere. The
        attach stays in pending-attach state until seen sequenced, so
        disconnection or a nack in between resubmits it."""
        assert type_name in self.channel_factories, f"unregistered type {type_name}"
        self.create_channel(channel, root=root)
        self._channel_types[channel.id] = (type_name, root)
        self._pending_attaches[channel.id] = (type_name, root)
        if self.connected:
            self._send_attach(channel.id, type_name, root)
        return channel

    def _submit_system(self, type_: MessageType, contents: Any = None) -> bool:
        """Submit a non-channel message (noop/propose/attach/summarize).
        On a dead connection, mark the runtime disconnected instead of
        crashing the caller — the drop/reconnect recovery path takes over.
        Returns False iff the connection was dead."""
        if not self.connected:
            return False
        self.client_seq += 1
        try:
            self.connection.submit(
                DocumentMessage(
                    client_sequence_number=self.client_seq,
                    reference_sequence_number=self.ref_seq,
                    type=type_,
                    contents=contents,
                )
            )
            return True
        except OSError:  # ConnectionError or a raw socket error (EBADF…)
            self.client_seq -= 1
            self.connected = False
            return False

    def _send_attach(self, cid: str, type_name: str, root: bool) -> None:
        # Stays in _pending_attaches until its echo: a failed send simply
        # re-announces on reconnect.
        self._submit_system(
            MessageType.ATTACH,
            {"id": cid, "type": type_name, "root": root},
        )

    def _resend_pending_attaches(self) -> None:
        """Re-announce unacked attaches before any channel-op resubmission —
        the attach must sequence before the channel's ops on every replica.
        Duplicate announcements are harmless (receivers skip known ids)."""
        for cid, (type_name, root) in self._pending_attaches.items():
            self._send_attach(cid, type_name, root)

    def _realize_channel(self, cid: str, type_name: str, root: bool) -> bool:
        """Construct a dynamically-created channel from the type registry,
        with the creator's rootness (GC reachability must agree on every
        replica). Unknown types are recorded as unrealized: their ops error
        loudly and this client declines to summarize (a summary without them
        would erase the channel for every capable client; the reference
        keeps unrealized subtrees verbatim)."""
        ctor = self.channel_factories.get(type_name)
        if ctor is None:
            self._unrealized[cid] = (type_name, root)
            return False
        self.create_channel(ctor(cid), root=root)
        self._channel_types[cid] = (type_name, root)
        return True

    def get_channel(self, channel_id: str) -> SharedObject:
        if self.gc.is_tombstoned(f"/{channel_id}"):
            raise TombstoneError(f"/{channel_id} is tombstoned")
        return self.channels[channel_id]

    def upload_blob(self, data: bytes) -> dict:
        """Upload an attachment blob; returns its storable handle
        (reference ContainerRuntime.uploadBlob -> BlobManager)."""
        return self.blobs.upload_blob(data)

    def get_blob(self, handle) -> bytes:
        return self.blobs.get_blob(handle)

    def handle_for(self, channel_id: str, sub_id: Optional[str] = None) -> dict:
        """Encoded handle referencing a channel (or a datastore child) —
        storable inside any DDS value; what GC traces."""
        route = f"/{channel_id}" if sub_id is None else f"/{channel_id}/{sub_id}"
        return encode_handle(route)

    # -- outbound (submit -> outbox -> flush, D.1) ----------------------------

    def submit_channel_op(
        self, channel_id: str, contents: Any, local_metadata: Any = None
    ) -> None:
        self._outbox.append((channel_id, contents, local_metadata))

    def flush(self) -> None:
        """Send the accumulated batch (the JS-turn-end flush). While
        disconnected, ops buffer for regeneration at reconnect (the
        reference's stashed/pending-state offline flow)."""
        batch, self._outbox = self._outbox, []
        if not self.connected:
            self._offline.extend(batch)
            return
        self._send_batch(batch)

    def _send_batch(self, batch: list) -> None:
        """Pack a logical batch through the outbox pipeline (compression /
        chunking / batch marks, D.1) and submit the wire messages. Pending
        entries record the wire clientSequenceNumber whose sequencing acks
        each logical op.

        Frame fast path: a run of string-kernel ops on one channel over a
        frame-capable connection ships as ONE binary op frame
        (protocol/opframe.py) — the batched wire the service tickets and
        stages without per-op Python. Acks are unchanged: frames consume
        one clientSequenceNumber per op and come back expanded."""
        if self._try_send_frame(batch):
            return
        envelopes = [
            {"address": channel_id, "contents": contents}
            for channel_id, contents, _meta in batch
        ]
        wire = pack_batch(envelopes, self.compression_threshold, self.chunk_size)
        for wi, w in enumerate(wire):
            self.client_seq += 1
            if w.logical_index is not None:
                channel_id, contents, local_metadata = batch[w.logical_index]
                self.pending.append(
                    (self.client_seq, channel_id, contents, local_metadata)
                )
            try:
                self.connection.submit(
                    DocumentMessage(
                        client_sequence_number=self.client_seq,
                        reference_sequence_number=self.ref_seq,
                        type=MessageType.OPERATION,
                        contents=w.contents,
                        metadata=w.metadata,
                    )
                )
            except OSError:
                # The connection died under us (idle eviction, socket drop —
                # ConnectionError or a raw socket error): this wire message
                # and everything after it never reached the service. Unwind
                # them into the offline buffer and mark the runtime
                # disconnected; anything already on the wire resolves
                # through the drop/reconnect prior-echo path.
                self.client_seq -= 1
                if w.logical_index is not None:
                    self.pending.pop()
                unsent = sorted(
                    x.logical_index
                    for x in wire[wi:]
                    if x.logical_index is not None
                )
                self._offline.extend(batch[i] for i in unsent)
                self.connected = False
                return

    def _try_send_frame(self, batch: list) -> bool:
        """Ship ``batch`` as one binary op frame if every op is a
        string-kernel op on the same channel and the connection speaks
        frames; returns False to fall through to the JSON wire."""
        if len(batch) < 2:
            return False
        submit_frame = getattr(self.connection, "submit_frame", None)
        if submit_frame is None:
            return False
        addr = None
        for channel_id, contents, _meta in batch:
            if (
                not isinstance(contents, dict)
                or contents.get("k") not in ("ins", "rem", "ann")
            ):
                return False
            if addr is None:
                addr = channel_id
            elif channel_id != addr:
                return False
        from fluidframework_tpu_torch.protocol.opframe import OpFrame

        kinds, a, b, tv = [], [], [], []
        for _cid, c, _meta in batch:
            k = c["k"]
            kinds.append(k)
            if k == "ins":
                a.append(c["pos"])
                b.append(c["orig"])
                tv.append(c["text"])
            else:
                a.append(c["start"])
                b.append(c["end"])
                tv.append(c.get("val"))
        frame = OpFrame.build(
            addr, kinds, a, b, tv, self.client_seq + 1, self.ref_seq
        )
        for channel_id, contents, local_metadata in batch:
            self.client_seq += 1
            self.pending.append(
                (self.client_seq, channel_id, contents, local_metadata)
            )
        try:
            submit_frame(frame)
        except OSError:
            # Same unwind contract as the per-op path: nothing from this
            # frame reached the service (one send, all-or-nothing).
            for _ in batch:
                self.pending.pop()
            self.client_seq -= len(batch)
            self._offline.extend(batch)
            self.connected = False
        return True

    # -- inbound (process, §3.2) ----------------------------------------------

    def process_incoming(self, n: Optional[int] = None) -> int:
        """Drain up to n inbound sequenced messages through the runtime.

        Flushes the outbox first: an op's position semantics bind to the
        refSeq it was created at, so no inbound op may interleave between
        creation and submission (the reference guarantees this by flushing
        at JS-turn end before the inbound DeltaQueue resumes).
        """
        self.flush()
        msgs = self.connection.take_inbox(n)
        for msg in msgs:
            self._process_one(msg)
            # A channel may submit DURING processing (e.g. an OT channel
            # releasing its next queued batch on ack). Send it before the
            # NEXT inbound message is processed, or its wire refSeq would
            # claim a context the op was never transformed against.
            if self._outbox and self.connected:
                self.flush()
        # Batch atomicity (reference ScheduleManager/DeltaScheduler): never
        # yield mid-batch — if the limit n landed inside a batch, keep
        # draining until its batchEnd arrives.
        while self._open_batch:
            more = self.connection.take_inbox(1)
            if not more:
                break  # remainder not yet sequenced; nothing interleaves
            msgs.extend(more)
            self._process_one(more[0])
            if self._outbox and self.connected:
                self.flush()  # same creation-context rule as the main loop
        # Nack recovery (reference: nack -> resubmit, §5.3): after a nack,
        # nothing from this connection sequences until we resend, so the
        # entire pending tail regenerates against the caught-up state.
        guard = 0
        throttle_guard = 0
        while self.connection.nacks and self.connected:
            # Admission throttling (429 ThrottlingError + retry_after_s):
            # a PACED resubmission, not a convergence failure — honor the
            # server's retry-after through the cooperative sleep hook so
            # the token bucket refills, and track it on its own (much
            # wider) guard instead of burning the spin guard below. Mixed
            # batches (a throttle nack alongside a real rejection) take
            # the spin guard: the non-throttle nack is the one that must
            # converge.
            throttles = [
                n for n in self.connection.nacks
                if getattr(n, "error_type", None) == NackErrorType.THROTTLING
                and getattr(n, "retry_after_s", 0.0) > 0.0
            ]
            if throttles and len(throttles) == len(self.connection.nacks):
                throttle_guard += 1
                if throttle_guard >= 64:
                    # Sustained server-side throttling (e.g. a long
                    # REFUSE_CONNECTIONS episode): yield back to the
                    # caller with pending INTACT instead of crashing a
                    # correctly-paced client — the next
                    # process_incoming resumes pacing where this one
                    # left off, and the ops resubmit once the envelope
                    # opens.
                    break
                self.throttle_waits += 1
                self.throttle_sleep(max(n.retry_after_s for n in throttles))
            else:
                guard += 1
                assert guard < 8, "nack resubmission did not converge"
            if any(
                getattr(n, "content_code", 0) >= 500
                for n in self.connection.nacks
            ):
                # Service-side pause (NackMessages control, 5xx): immediate
                # resubmission would spin. Drop the connection with pending
                # INTACT — reconnect parks it as a prior generation, whose
                # echoes/LEAVE resolve each op's true fate (some may have
                # sequenced before the pause; offline-parking them here
                # would double-apply those).
                self.connection.nacks.clear()
                self.drop_connection()
                return len(msgs)
            self.connection.nacks.clear()
            for m in self.connection.take_inbox():
                self._process_one(m)
            # Rejected clientSequenceNumbers are reused: the server's per-
            # client counter only advances on sequenced ops.
            self.client_seq = self._last_acked_cseq
            self._resend_pending_attaches()
            tail = list(self.pending)
            self.pending.clear()
            self._regenerate_through_channels(
                (chan, contents, meta) for _cseq, chan, contents, meta in tail
            )
            batch, self._outbox = self._outbox, []
            self._send_batch(batch)
            # Proposals behind the nack were rejected too: re-propose the
            # ones whose echoes didn't arrive during the catch-up above.
            inflight, self._inflight_proposals = (
                self._inflight_proposals,
                deque(),
            )
            for _cseq, key, value in inflight:
                self.propose(key, value)
        return len(msgs)

    def _regenerate_through_channels(self, entries) -> None:
        """Replay (channel_id, contents, local_metadata) entries through the
        per-channel resubmit path (reference reSubmitCore): each channel
        regenerates the op against current state rather than re-sending it
        verbatim. Shared by nack recovery, reconnect, and dropped-connection
        resolution."""
        for ch in self.channels.values():
            ch.begin_resubmit()
        for channel_id, contents, local_metadata in entries:
            self.channels[channel_id].resubmit_core(contents, local_metadata)
        for ch in self.channels.values():
            ch.end_resubmit()

    def _is_own_echo(self, msg: SequencedDocumentMessage) -> bool:
        """True iff this sequenced message is this connection's own op."""
        return (
            msg.client_id == self.client_id
            and msg.sequence_number > self._join_seq
        )

    def _match_prior_gen(self, msg: SequencedDocumentMessage):
        """The dropped-connection generation this message belongs to, if
        any. While a generation is unresolved its LEAVE has not sequenced,
        so the service cannot have recycled its client id — a client-id
        match (above the generation's own JOIN) is unambiguous, even for
        in-flight ops an async server sequences after our successor JOIN.
        (_is_own_echo is checked first; our current id can only equal a
        gen's id after that gen resolved.)"""
        for gen in self._prior_gens:
            if (
                msg.client_id == gen["client_id"]
                and msg.sequence_number > gen["join_seq"]
            ):
                return gen
        return None

    def _process_one(self, msg: SequencedDocumentMessage) -> None:
        assert (
            msg.sequence_number == self.ref_seq + 1
        ), f"sequence gap: {self.ref_seq} -> {msg.sequence_number}"
        self.ref_seq = msg.sequence_number
        self.min_seq = max(self.min_seq, msg.minimum_sequence_number)
        meta = msg.metadata or {}
        if meta.get("batchBegin"):
            self._open_batch = True
            self._open_batch_client = msg.client_id
        if meta.get("batchEnd"):
            self._open_batch = False
            self._open_batch_client = None
        # Every sequenced message from this client consumed a server-side
        # clientSequenceNumber slot — PROPOSE/NOOP/SUMMARIZE included — so
        # nack recovery must never reuse a number at or below it. Identity
        # is (current connection id AND sequenced after our join): client
        # slots recycle, so a historical id may belong to a previous holder
        # whose traffic all precedes our ClientJoin, and everything from our
        # own prior connections fully drained before we disconnected.
        if self._is_own_echo(msg):
            self._last_acked_cseq = max(
                self._last_acked_cseq, msg.client_sequence_number
            )
        unpacked = self._rmp.process(msg)
        if unpacked is None:
            return  # swallowed wire message (non-final chunk)
        msg = unpacked

        if msg.type == MessageType.CLIENT_JOIN:
            detail = msg.contents
            cid = detail["clientId"]
            self.quorum_members[cid] = {
                "client_id": cid,
                "mode": detail.get("mode", "write"),
                # Join order for election: slot numbers recycle, so "oldest
                # client" is smallest join seq, not smallest slot.
                "join_seq": msg.sequence_number,
            }
        elif msg.type == MessageType.CLIENT_LEAVE:
            member = self.quorum_members.pop(msg.contents, None)
            # Drop any partial chunk/batch accumulators the departed client
            # left behind — its slot may recycle to a client whose fresh
            # chunk stream must not collide with the corpse's.
            self._rmp.forget_client(msg.contents)
            if self._open_batch and self._open_batch_client == msg.contents:
                # The batch opener died mid-batch: its batchEnd will never
                # arrive. Un-latch, or every subsequent process_incoming
                # would drain the whole inbox chasing a phantom end.
                self._open_batch = False
                self._open_batch_client = None
            for ch in self.channels.values():
                ch.on_client_leave(msg.contents)
            for gen in self._prior_gens:
                if msg.contents != gen["client_id"]:
                    continue
                # Exact match: the quorum records WHICH holder of the slot
                # left (by its join seq). Quorum-less fallback: the oldest
                # generation for this id — LEAVEs arrive in holder order,
                # and resolving the oldest beats leaking its ops forever
                # (the LEAVE itself may sequence after our reconnect, so no
                # upper-bound window applies to it).
                if (
                    member is None
                    or member.get("join_seq") == gen["join_seq"]
                ):
                    # That connection's LEAVE: nothing more from it can
                    # arrive, so its unresolved remainder resubmits.
                    self._resolve_prior_connection(gen)
                    break
            self._check_proposals()
        elif msg.type == MessageType.ATTACH:
            # Dynamic channel creation: the attaching client already has it;
            # everyone else constructs it from the registry. Sequencing the
            # attach before any op on the channel guarantees a target exists
            # on every replica.
            cid, type_name = msg.contents["id"], msg.contents["type"]
            self._channel_last_change[cid] = msg.sequence_number
            if self._is_own_echo(msg):
                self._pending_attaches.pop(cid, None)
            if cid not in self.channels:
                self._realize_channel(cid, type_name, msg.contents.get("root", False))
        elif msg.type == MessageType.BLOB_ATTACH:
            self.blobs.process_attach(msg.contents)
        elif msg.type == MessageType.PROPOSE:
            # Quorum proposal (reference protocol-base/src/quorum.ts): keyed
            # by its sequence number, approved once MSN reaches it (every
            # connected client has seen it).
            key, value = msg.contents["key"], msg.contents["value"]
            self.pending_proposals[msg.sequence_number] = (key, value)
            # Retire the in-flight record (ours, or a dropped connection's).
            if self._is_own_echo(msg) and self._inflight_proposals:
                if self._inflight_proposals[0][0] == msg.client_sequence_number:
                    self._inflight_proposals.popleft()
            elif (gen := self._match_prior_gen(msg)) is not None:
                if (
                    gen["proposals"]
                    and gen["proposals"][0][0] == msg.client_sequence_number
                ):
                    gen["proposals"].popleft()
            self._check_proposals()
        elif msg.type == MessageType.OPERATION:
            address = msg.contents["address"]
            inner = msg.contents["contents"]
            self._channel_last_change[address] = msg.sequence_number
            assert address not in self._unrealized, (
                f"op for channel {address!r} of unknown type "
                f"{self._unrealized.get(address)!r} — register the type "
                "before loading this document"
            )
            local = self._is_own_echo(msg)
            local_metadata = None
            if local:
                assert self.pending, "ack with no pending op"
                pseq, pchan, pcontents, local_metadata = self.pending.popleft()
                assert pseq == msg.client_sequence_number, (
                    f"pending mismatch: {pseq} != {msg.client_sequence_number}"
                )
                assert pchan == address
            elif (gen := self._match_prior_gen(msg)) is not None:
                # In-flight op from a dropped connection that did get
                # sequenced: ack it against that generation's saved FIFO —
                # applying it as remote would duplicate the already-applied
                # local state.
                assert gen["pending"], "prior echo with no saved pending"
                pseq, pchan, pcontents, local_metadata = (
                    gen["pending"].popleft()
                )
                assert pseq == msg.client_sequence_number, (
                    f"prior pending mismatch: {pseq} != "
                    f"{msg.client_sequence_number}"
                )
                assert pchan == address
                local = True
            channel = self.channels.get(address)
            if channel is not None:
                channel.process_core(
                    msg.__class__(
                        **{**msg.__dict__, "contents": inner}
                    ),
                    local,
                    local_metadata,
                )
        if msg.type == MessageType.SUMMARY_ACK:
            self.last_summary_seq = max(
                self.last_summary_seq, msg.contents["head"]
            )
            if msg.contents["head"] >= (
                self._acked_summary[1] if self._acked_summary else -1
            ):
                self._acked_summary = (
                    msg.contents["handle"],
                    msg.contents["head"],
                )
        self._check_proposals()
        self._maybe_auto_summarize()
        if self.on_op is not None:
            self.on_op(msg)
        for fn in list(self._op_listeners):
            fn(msg)

    def add_op_listener(
        self, fn: Callable[[SequencedDocumentMessage], None]
    ) -> Callable[[], None]:
        """Subscribe to every processed sequenced message; returns the
        unsubscribe handle (view adapters attach/detach through this)."""
        self._op_listeners.append(fn)

        def unsubscribe() -> None:
            if fn in self._op_listeners:
                self._op_listeners.remove(fn)

        return unsubscribe

    # -- connection lifecycle (disconnect / reconnect + resubmit, §5.3) ------

    def disconnect(self) -> None:
        """Drop the connection. In-flight state drains first (the local
        service sequences synchronously, so pending acks are already in the
        inbox); edits made while disconnected buffer for resubmission."""
        self.flush()
        self.process_incoming()
        assert not self.pending, "pending ops must drain before disconnect"
        self.connection.disconnect()
        self.connected = False

    def drop_connection(self) -> None:
        """Ungraceful connection loss (socket drop, idle eviction): unlike
        disconnect(), in-flight ops may be sequenced-but-unseen. Reconnect
        resolves their fate: echoes from the dead connection that did get
        sequenced arrive during catch-up and ack against the saved pending
        FIFO; once the server's LEAVE for the old client sequences, whatever
        remains was never sequenced and regenerates through resubmit."""
        if not self.connected:
            return
        self.connected = False
        try:
            self.connection.disconnect()
        except Exception:
            pass  # the socket is already gone

    def reconnect(self) -> None:
        """Rejoin under a new client id, catch up, then regenerate offline
        edits through each channel's resubmit path (reference
        regeneratePendingOp / reSubmitCore)."""
        assert not self.connected, "already connected"
        # Unflushed outbox entries authored while offline are offline edits:
        # sweep them into the resubmit buffer now, or the catch-up flush
        # below would send them raw (stale client id / local seqs), bypassing
        # the per-channel regenerate path.
        self.flush()
        if self.pending or self._inflight_proposals:
            # Ungraceful drop left in-flight ops of unknown fate: park them
            # as a prior generation; catch-up echoes ack them, the old
            # client's LEAVE resubmits the remainder (_match_prior_gen /
            # _resolve_prior_connection). Repeated drops stack generations.
            self._prior_gens.append(
                {
                    "client_id": self.client_id,
                    "join_seq": self._join_seq,
                    "pending": self.pending,
                    "proposals": self._inflight_proposals,
                }
            )
            self.pending = deque()
            self._inflight_proposals = deque()
        self.connection = self._service.connect(
            self.doc_id, self._mode, from_seq=self.ref_seq
        )
        self.client_id = self.connection.client_id
        self._join_seq = getattr(self.connection, "join_seq", 0)
        self.conn_no = getattr(self.connection, "conn_no", 0) or (
            self.client_id + 1
        )
        self.client_seq = 0  # clientSequenceNumbers are per-connection
        self._last_acked_cseq = 0
        self.connected = True
        for ch in self.channels.values():
            ch.on_reconnect(self.client_id)
        offline, self._offline = self._offline, []
        self._offline_folded = 0
        self._catch_up_and_resubmit(offline)

    def _catch_up_and_resubmit(self, offline: list) -> None:
        """Shared reconnect/rehydrate tail: catch up to head, re-announce
        attach and blob state, then resubmit the offline tail — parked
        behind any unresolved prior generations so authored order holds
        across connections (the reference's single ordered
        PendingStateManager list has this property by construction) —
        and finally replay buffered proposals."""
        self.process_incoming()  # catch up before rebasing
        self._resend_pending_attaches()
        self.blobs.on_reconnect()
        if self._prior_gens and offline:
            self._prior_gens.append(
                {
                    "client_id": None,
                    "join_seq": -1,
                    "pending": deque(),
                    "proposals": deque(),
                    "entries": offline,
                    "resolved": True,
                }
            )
        else:
            self._regenerate_through_channels(offline)
        self.flush()
        proposals, self._offline_proposals = self._offline_proposals, []
        for key, value in proposals:
            self.propose(key, value)

    def _resolve_prior_connection(self, gen: dict) -> None:
        """The server's LEAVE for a dropped connection has sequenced —
        nothing more from it can arrive, so whatever is still in its saved
        pending FIFO was never sequenced. Mark it resolved; resubmission
        happens strictly in generation (authored) order, so a late LEAVE
        for an older generation is never overtaken by a newer one."""
        gen["resolved"] = True
        self._drain_resolved_gens()

    def _drain_resolved_gens(self) -> None:
        """Resubmit prior generations once EVERY one is resolved, in
        authored order under ONE resubmit bracket. One bracket matters:
        each channel snapshots its state once per bracket, so a later op's
        regenerated position still sees earlier ops at their original local
        seqs — replaying generation-by-generation would restamp the earlier
        ops and hide them from the later ones' perspectives. Waiting for
        all LEAVEs delays resubmission a little; it never loses ops."""
        if not self._prior_gens or not all(
            g.get("resolved") for g in self._prior_gens
        ):
            return
        gens, self._prior_gens = self._prior_gens, []
        to_replay: list = []
        for gen in gens:
            # Unsequenced proposals from the dead connection: re-propose (or
            # buffer for reconnect — propose() handles both states).
            for _cseq, key, value in gen["proposals"]:
                self.propose(key, value)
            to_replay.extend(
                gen.get("entries")
                or (
                    (chan, contents, meta)
                    for _cseq, chan, contents, meta in gen["pending"]
                )
            )
        if not to_replay:
            return
        if not self.connected:
            # Resolved before reconnect: fold into the offline buffer ahead
            # of later-authored offline edits but after earlier folds (the
            # cursor keeps authored order across folds).
            self._offline[
                self._offline_folded : self._offline_folded
            ] = to_replay
            self._offline_folded += len(to_replay)
            return
        # Any unacked ATTACH must re-announce before ops on its channel
        # regenerate, or remote replicas drop those ops on the floor.
        self._resend_pending_attaches()
        self._regenerate_through_channels(to_replay)

    def send_noop(self) -> None:
        """Flush our refSeq to the service so the MSN can advance (the
        reference CollabWindowTracker's periodic noop). A noop lost to a
        dead connection needs no recovery — the next connection's join
        refreshes our refSeq server-side."""
        self._submit_system(MessageType.NOOP)

    def propose(self, key: str, value: Any) -> None:
        """Submit a quorum proposal (approved once MSN >= its seq). On a
        dead connection the proposal buffers and re-submits at reconnect."""
        if not self._submit_system(
            MessageType.PROPOSE, {"key": key, "value": value}
        ):
            self._offline_proposals.append((key, value))
        else:
            self._inflight_proposals.append((self.client_seq, key, value))

    def _check_proposals(self) -> None:
        for seq in sorted(self.pending_proposals):
            if self.min_seq >= seq:
                key, value = self.pending_proposals.pop(seq)
                self.approved_proposals[key] = value

    # -- stashed-op close + rehydrate (pendingStateManager.ts:205,
    #    containerRuntime.ts:3248 getPendingLocalState) ------------------

    def get_pending_local_state(self) -> dict:
        """Serializable snapshot for closing the process and resuming in a
        later session: the full container state at ref_seq (channel
        snapshots INCLUDE pending rows — unacked local stamps ride the
        state lanes — plus quorum/proposals/blob bindings/GC), in-flight
        ops parked per dead-connection generation (their fate resolves
        during rehydrate catch-up exactly like an ungraceful reconnect),
        and the never-sent offline tail."""
        gens = [
            {
                "client_id": gen["client_id"],
                "join_seq": gen["join_seq"],
                "pending": [
                    list(e) for e in gen["pending"]
                ],
                "proposals": [list(p) for p in gen["proposals"]],
                "entries": [list(e) for e in (gen.get("entries") or [])],
                "resolved": bool(gen.get("resolved")),
            }
            for gen in self._prior_gens
        ]
        if self.pending or self._inflight_proposals:
            gens.append(
                {
                    "client_id": self.client_id,
                    "join_seq": self._join_seq,
                    "pending": [list(e) for e in self.pending],
                    "proposals": [
                        list(p) for p in self._inflight_proposals
                    ],
                    "entries": [],
                    "resolved": False,
                }
            )
        offline = list(self._offline) + list(self._outbox)
        return {
            "ref_seq": self.ref_seq,
            # The slot whose stamps ride the channel snapshots: pending-row
            # restamping at rehydrate moves bits FROM this slot.
            "client_id": self.client_id,
            "summary": self._container_state_snapshot(),
            "gens": gens,
            "offline": [list(e) for e in offline],
            "offline_proposals": [list(p) for p in self._offline_proposals],
            "pending_attaches": {
                cid: list(tr) for cid, tr in self._pending_attaches.items()
            },
            "blobs": self.blobs.get_pending_state(),
        }

    @classmethod
    def rehydrate(
        cls,
        service,
        doc_id: str,
        stashed: dict,
        channels: tuple = (),
        channel_types=None,
        **kw,
    ) -> "ContainerRuntime":
        """Resume a closed session: restore channel state (including the
        optimistic pending rows) from the stash, catch up from the stash's
        ref seq, then regenerate every recorded entry through the per-
        channel resubmit path — the reference's applyStashedOpsAt flow."""
        return cls(
            service, doc_id, channels=channels, channel_types=channel_types,
            _stashed=stashed, **kw,
        )

    def _apply_stashed_state(self, stashed: dict) -> None:
        """Runs inside __init__ in place of summary load + plain catch-up.
        The flow is an ungraceful reconnect whose prior state comes from
        disk: in-flight generations park under their dead identities (so
        catch-up echoes ack them instead of double-applying, and only
        their LEAVEs trigger resubmission of the unsequenced remainder),
        and the offline tail queues behind them in authored order."""
        self._load_summary_dict(stashed["summary"], stashed["ref_seq"])
        # Stashed pending rows carry the closed session's client slot;
        # adopt this connection's (same restamp as reconnect — the old
        # slot must be current first so the removers bits move).
        gens = stashed.get("gens", [])
        old_id = stashed.get("client_id")
        for ch in self.channels.values():
            if old_id is not None:
                ch.adopt_stashed_slot(old_id)
            ch.on_reconnect(self.client_id)
        self._prior_gens = [
            {
                "client_id": g["client_id"],
                "join_seq": g["join_seq"],
                "pending": deque(tuple(e) for e in g["pending"]),
                "proposals": deque(tuple(p) for p in g["proposals"]),
                "entries": [tuple(e) for e in g.get("entries", [])],
                "resolved": bool(g.get("resolved")),
            }
            for g in gens
        ]
        offline = [tuple(e) for e in stashed.get("offline", [])]
        self._offline_proposals = [
            tuple(p) for p in stashed.get("offline_proposals", [])
        ]
        self._pending_attaches = {
            cid: tuple(tr)
            for cid, tr in stashed.get("pending_attaches", {}).items()
        }
        self.blobs.load_pending_state(stashed.get("blobs", {}))
        self._catch_up_and_resubmit(offline)

    # -- summaries (§3.4: summarize -> upload -> Summarize op -> scribe ack) --

    def run_gc(self, channel_summaries: Optional[dict] = None) -> GCResult:
        """Mark pass over the handle-reference graph (collectGarbage,
        garbageCollection.ts:1007): root channels seed reachability; every
        handle inside a reachable object's state references its target."""
        if channel_summaries is None:
            channel_summaries = {
                cid: ch.summarize_core() for cid, ch in self.channels.items()
            }
        from fluidframework_tpu_torch.runtime.datastore import FluidDataStore

        graph: Dict[str, list] = {}
        for cid, ch in self.channels.items():
            route = f"/{cid}"
            summary = channel_summaries[cid]
            if isinstance(ch, FluidDataStore):  # per-child nodes, no re-summarize
                children = summary["channels"]
                graph[route] = [f"{route}/{sub}" for sub in sorted(children)]
                for sub, sub_summary in children.items():
                    child_route = f"{route}/{sub}"
                    # Child -> parent edge: a referenced child keeps its
                    # datastore alive (a route implies all its ancestors).
                    graph[child_route] = [route] + collect_handle_routes(sub_summary)
            else:
                graph[route] = collect_handle_routes(summary)
        # Carried (unrealized) channels still participate: their verbatim
        # summaries may hold handles keeping other channels alive, and rooted
        # ones must stay roots — reachability must agree across replicas
        # whether or not this client can realize the type.
        roots = set(self._root_ids)
        for cid, carried in self._carried_summaries.items():
            graph[f"/{cid}"] = collect_handle_routes(carried)
            if self._unrealized.get(cid, (None, False))[1]:
                roots.add(cid)
        # Blob bindings participate as leaf nodes: alive only while some
        # channel state holds their handle (blobManager GC integration).
        graph.update(self.blobs.gc_routes())
        return self.gc.collect(graph, [f"/{cid}" for cid in sorted(roots)])

    def summarize(self) -> dict:
        """Full summary: channel trees + protocol state (quorum, proposals)
        — the ``.protocol`` tree of the reference's client summary — plus
        the ``gc`` tree (unreferenced-node tracking, D.3). Swept routes are
        excluded, so future loads never resurrect them."""
        assert not (set(self._unrealized) - set(self._carried_summaries)), (
            "cannot summarize with op-attached channels of unknown type "
            f"{self._unrealized!r}: the summary would erase them"
        )
        channel_summaries = {
            cid: ch.summarize_core() for cid, ch in self.channels.items()
        }
        channel_summaries.update(self._carried_summaries)
        gc_result = self.run_gc(channel_summaries)
        for route in gc_result.swept:
            cid = route.lstrip("/").split("/", 1)[0]
            channel_summaries.pop(cid, None)
        # Incremental reuse (ISummaryHandle, sharedObject.ts:722): a channel
        # untouched since the last ACKED summary uploads an O(1) handle to
        # its previous blob instead of its full tree. (GC above still reads
        # the in-memory state — reuse saves upload bytes, which is the
        # scaling cliff at fleet size, not serialization CPU.)
        if self._acked_summary is not None:
            prev_handle, prev_head = self._acked_summary
            try:
                prev_blobs = self._service.store.channel_blob_handles(
                    prev_handle
                )
            except Exception:
                prev_blobs = {}  # pruned/unknown tree: fall back to full
            from fluidframework_tpu_torch.service.summary_store import summary_handle

            for cid in list(channel_summaries):
                if (
                    self._channel_last_change.get(cid, 0) <= prev_head
                    and cid in prev_blobs
                ):
                    channel_summaries[cid] = summary_handle(prev_blobs[cid])
        return {
            "sequence_number": self.ref_seq,
            "quorum": [
                self.quorum_members[cid] for cid in sorted(self.quorum_members)
            ],
            "proposals": {
                str(seq): list(kv) for seq, kv in self.pending_proposals.items()
            },
            "approved": dict(self.approved_proposals),
            "channels": channel_summaries,
            "blobs": self.blobs.summarize(gc_result.swept),
            "channel_types": {
                cid: t
                for cid, t in {**self._channel_types, **self._unrealized}.items()
                if cid in channel_summaries
            },
            "gc": self.gc.summarize(),
        }

    def _container_state_snapshot(self) -> dict:
        """The container-level replica state at ref_seq as a summary-shaped
        dict (everything _load_summary_dict restores): channel trees,
        quorum, proposals, blob bindings, channel types, GC state. Unlike
        summarize() this takes no GC pass and allows pending local state —
        channel snapshots simply include the pending rows."""
        channel_summaries = {
            cid: ch.summarize_core() for cid, ch in self.channels.items()
        }
        channel_summaries.update(self._carried_summaries)
        return {
            "sequence_number": self.ref_seq,
            "quorum": [
                self.quorum_members[cid] for cid in sorted(self.quorum_members)
            ],
            "proposals": {
                str(seq): list(kv) for seq, kv in self.pending_proposals.items()
            },
            "approved": dict(self.approved_proposals),
            "channels": channel_summaries,
            "blobs": dict(self.blobs.bindings),
            "channel_types": {
                cid: t
                for cid, t in {
                    **self._channel_types, **self._unrealized
                }.items()
                if cid in channel_summaries
            },
            "gc": self.gc.summarize(),
        }

    def _load_summary(self, initial: tuple) -> None:
        handle, seq = initial
        summary = self._service.store.get_summary(handle)
        assert summary["sequence_number"] == seq
        self._load_summary_dict(summary, seq)
        # The served summary is by definition acked: channels untouched
        # since it can reuse its blobs in our own first summary.
        self._acked_summary = (handle, seq)

    def _load_summary_dict(self, summary: dict, seq: int) -> None:
        # Dynamically attached channels are reconstructed from their recorded
        # (type, root) before their summaries load (their ATTACH op is below
        # the summary seq, so replay won't recreate them). Unknown types keep
        # their summary verbatim so a future summary by this client carries
        # them forward instead of erasing them.
        for cid, (type_name, root) in summary.get("channel_types", {}).items():
            if cid not in self.channels and not self._realize_channel(
                cid, type_name, root
            ):
                self._carried_summaries[cid] = summary["channels"][cid]
        for cid, channel_summary in summary["channels"].items():
            if cid in self.channels:
                self.channels[cid].load_core(channel_summary)
        # Full member details (mode included) — election must agree between
        # live and summary-loaded replicas.
        self.quorum_members = {
            (c["client_id"] if isinstance(c, dict) else c): (
                c if isinstance(c, dict) else {"client_id": c, "mode": "write"}
            )
            for c in summary["quorum"]
        }
        self.pending_proposals = {
            int(seq_key): tuple(kv)
            for seq_key, kv in summary["proposals"].items()
        }
        self.approved_proposals = dict(summary["approved"])
        self.blobs.load(summary.get("blobs"))
        self.gc.load(summary.get("gc", {}))
        self.ref_seq = seq
        self.last_summary_seq = seq

    def submit_summary(self) -> str:
        """Upload the current summary and submit the Summarize op; the
        scribe acks or nacks it on the sequenced stream."""
        assert not self._has_unacked_local_state(), (
            "summarize with unacked local ops"
        )
        summary = self.summarize()
        handle = self._service.store.put_summary(summary)
        # A dead connection just means no Summarize op: the uploaded tree is
        # orphaned (content-addressed, harmless) and the next elected
        # summarizer retries.
        self._submit_system(
            MessageType.SUMMARIZE, {"handle": handle, "head": self.ref_seq}
        )
        return handle

    @property
    def is_summarizer(self) -> bool:
        """Oldest eligible quorum member is elected (the reference's
        orderedClientElection: earliest-joined write client wins)."""
        from fluidframework_tpu_torch.runtime.summarizer import SummarizerElection

        return SummarizerElection(self).is_elected

    def _has_unacked_local_state(self) -> bool:
        """Locally-applied edits not yet sequenced, in any holding area: a
        summary taken now would bake them in as committed state, and their
        later resubmission would double-apply them on loaders."""
        return bool(
            self.pending
            or self._outbox
            or self._offline
            or self._prior_gens
            or self.blobs.pending
            or self.blobs.offline
        )

    def _maybe_auto_summarize(self) -> None:
        if (
            self.summary_interval is not None
            and self.is_summarizer
            and not self._has_unacked_local_state()
            # Decline (don't crash op processing) while holding op-attached
            # channels of unknown type: our summary would erase them.
            and not (set(self._unrealized) - set(self._carried_summaries))
            and self.ref_seq - self.last_summary_seq >= self.summary_interval
        ):
            self.submit_summary()
