"""Partitioned stream-lambda framework + the four service lambdas.

Reference: ``server/routerlicious`` —
- ``lambdas-driver``: ``KafkaRunner`` -> ``PartitionManager`` (one ordered
  queue per partition with a ``CheckpointManager``,
  kafka-service/partitionManager.ts:25, checkpointManager.ts:10) ->
  ``DocumentLambda``/``DocumentPartition`` demultiplexing a partition into
  per-document lambdas (document-router/*.ts).
- ``services-core/src/lambdas.ts``: ``IPartitionLambda`` (:72) /
  ``IPartitionLambdaFactory`` (:88) — the plugin surface.
- ``lambdas``: **deli** (sequencer, deli/lambda.ts:379), **scribe**
  (summary validation + ack, scribe/lambda.ts:106), **scriptorium**
  (op persistence, scriptorium/lambda.ts:32), **broadcaster**
  (fan-out to client rooms, broadcaster/lambda.ts:62).

Execution model: lambdas are stateless replayable consumers; durable
state = checkpoints (offset + lambda state, reference ``IDeliState``
document.ts:56) written on a max-messages heuristic. Delivery is
at-least-once: a crash between produce and commit replays input, and the
replay deterministically re-produces the *same* sequenced messages, which
every downstream consumer absorbs idempotently (scriptorium upserts by
seq, broadcaster drops seqs already delivered to a connection).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    NackMessage,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.service import retry
from fluidframework_tpu_torch.service.queue import PartitionedLog
from fluidframework_tpu_torch.telemetry import (
    LumberEventName,
    Lumberjack,
    journal,
    metrics,
    profiler,
    tracing,
)
from fluidframework_tpu_torch.testing.faults import inject_fault
from fluidframework_tpu_torch.service.sequencer import (
    DocumentSequencer,
    SequencerCheckpoint,
)

RAW_TOPIC = "rawdeltas"
DELTAS_TOPIC = "deltas"
SIGNALS_TOPIC = "signals"

# Cached read-only aranges: frame stamping runs per frame on the serving
# path, and np.arange per call is measurable at 10k+ frames/round.
_ARANGES: Dict[int, np.ndarray] = {}


def _arange(n: int) -> np.ndarray:
    a = _ARANGES.get(n)
    if a is None:
        a = np.arange(n, dtype=np.int32)
        a.setflags(write=False)
        _ARANGES[n] = a
    return a


# ---------------------------------------------------------------------------
# Framework


class PartitionLambda:
    """IPartitionLambda: handle one record, emit (topic, key, value) tuples;
    expose/restore durable state for checkpoints.

    ``state()`` MUST return an independent snapshot (no references to
    live mutable structures): the checkpoint store keeps it as-is — a
    defensive deepcopy per checkpoint was the single largest cost on the
    serving pipeline at fleet scale. ``restore`` likewise must not
    mutate the state object it is given.

    ``wants``: optional frozenset of record types (``value["t"]``) the
    lambda acts on. The runner drops non-matching records BEFORE the
    handler call — a consumer that would return ``[]`` anyway must not
    pay Python dispatch (or per-doc demux and dirty-marking) per record
    on the serving path. None = every record (also required for topics
    whose records carry no ``t`` key)."""

    wants: Optional[frozenset] = None

    def handler(self, key: str, value: Any) -> List[Tuple[str, str, Any]]:
        raise NotImplementedError

    def state(self) -> Any:
        return None

    @classmethod
    def restore(cls, state: Any) -> "PartitionLambda":
        raise NotImplementedError


class BatchHandlerError(Exception):
    """Raised by ``handler_batch`` when a record mid-chunk fails: carries
    the outputs already produced and how many records completed, so the
    runner can emit them and commit the offset up to the failure —
    EXACTLY the per-record loop's crash semantics. Without this, outputs
    of records the lambdas already mutated state for (e.g. deli tickets)
    would be discarded while their replay dedup-drops — lost ops."""

    def __init__(self, outputs, n_ok: int, cause: BaseException):
        super().__init__(f"batch handler failed after {n_ok} records")
        self.outputs = outputs
        self.n_ok = n_ok
        self.cause = cause


class CheckpointStore:
    """Durable (in this harness: in-memory, survives lambda restarts)
    checkpoint documents — the Mongo IDeliState/IScribe analog.

    ``merge=True`` saves are INCREMENTAL: the given state is a partial
    per-document dict merged into the stored one (the reference
    checkpoints dirty document state, not the whole partition —
    ``deli/checkpointManager.ts``; serializing every doc every
    checkpoint is quadratic at fleet scale).

    States are stored WITHOUT a defensive copy: ``PartitionLambda.
    state()`` contracts to return an independent snapshot, and
    ``restore`` to treat its input as read-only (deepcopying every
    checkpoint was the dominant host cost of the serving pipeline)."""

    def __init__(self) -> None:
        self._data: Dict[Tuple[str, int], dict] = {}

    def save(self, group: str, partition: int, offset: int, state: Any,
             merge: bool = False) -> None:
        if merge:
            ent = self._data.setdefault(
                (group, partition), {"offset": 0, "state": {}}
            )
            ent["offset"] = offset
            ent["state"].update(state)
            return
        self._data[(group, partition)] = {"offset": offset, "state": state}

    def load(self, group: str, partition: int) -> Optional[dict]:
        ent = self._data.get((group, partition))
        return {"offset": ent["offset"], "state": ent["state"]} if ent else None


class DocumentLambda(PartitionLambda):
    """Demultiplexes one partition into per-document lambdas (the
    document-router): every record's key is its document id; each document
    gets its own lambda instance and strictly-ordered substream."""

    # state() returns only documents touched since the last call; the
    # checkpoint store merges them (dirty-doc checkpointing — without it
    # every checkpoint serializes the whole partition's documents, which
    # is quadratic in fleet size on the serving path).
    incremental_state = True

    def __init__(
        self,
        per_doc_factory: Callable[[str, Any], PartitionLambda],
        wants: Optional[frozenset] = None,
    ):
        self._factory = per_doc_factory
        self._docs: Dict[str, PartitionLambda] = {}
        self._dirty: set = set()
        self.wants = wants

    def doc(self, doc_id: str) -> PartitionLambda:
        if doc_id not in self._docs:
            self._docs[doc_id] = self._factory(doc_id, None)
        return self._docs[doc_id]

    def handler(self, key: str, value: Any) -> List[Tuple[str, str, Any]]:
        self._dirty.add(key)
        return self.doc(key).handler(key, value)

    def handler_batch(self, recs) -> List[Tuple[str, str, Any]]:
        """One read chunk through the router in a single call: the wants
        filter, dirty-marking, and demux run as one tight loop instead of
        per-record dispatch through the runner (documentLambda.ts routes
        per message; at 10k+ frames/round the layers ARE the cost).
        A failing record raises :class:`BatchHandlerError` carrying the
        completed prefix's outputs, preserving the per-record loop's
        output-before-commit crash contract."""
        out: List[Tuple[str, str, Any]] = []
        docs = self._docs
        dirty = self._dirty
        wants = self.wants
        for i, rec in enumerate(recs):
            value = rec.value
            if wants is not None and value.get("t") not in wants:
                continue
            key = rec.key
            lam = docs.get(key)
            if lam is None:
                lam = docs[key] = self._factory(key, None)
            dirty.add(key)
            try:
                res = lam.handler(key, value)
            except Exception as e:
                raise BatchHandlerError(out, i, e) from e
            if res:
                out.extend(res)
        return out

    def state(self) -> Any:
        dirty, self._dirty = self._dirty, set()
        return {
            doc_id: self._docs[doc_id].state()
            for doc_id in dirty
            if doc_id in self._docs
        }

    def restore_docs(self, state: Dict[str, Any]) -> None:
        for doc_id, doc_state in (state or {}).items():
            self._docs[doc_id] = self._factory(doc_id, doc_state)


class PartitionRunner:
    """One consumer group over one topic: per-partition ordered pump with
    offset commit + state checkpoint every ``checkpoint_every`` messages
    (KafkaRunner + PartitionManager + CheckpointManager collapsed for the
    in-proc synchronous harness)."""

    def __init__(
        self,
        log: PartitionedLog,
        topic: str,
        group: str,
        factory: Callable[[int, Optional[Any]], PartitionLambda],
        checkpoints: Optional[CheckpointStore] = None,
        checkpoint_every: int = 10,
    ):
        self.log = log
        self.topic = topic
        self.group = group
        self.checkpoints = checkpoints or CheckpointStore()
        self.checkpoint_every = checkpoint_every
        self._lambdas: Dict[int, PartitionLambda] = {}
        self._offsets: Dict[int, int] = {}
        self._since_checkpoint: Dict[int, int] = {}
        for p in range(log.n_partitions):
            saved = self.checkpoints.load(group, p)
            self._lambdas[p] = factory(p, saved["state"] if saved else None)
            self._offsets[p] = saved["offset"] if saved else 0
            self._since_checkpoint[p] = 0

    def pump(self) -> int:
        """Drain every partition's backlog; returns records processed.

        Lambdas exposing ``handler_batch`` consume each read chunk in one
        call (outputs flushed with one boxcar append per chunk); others
        run per-record with the ``wants`` type filter applied here.
        Offsets advance per chunk — output-before-commit order is
        preserved, so a crash replays at most one chunk (at-least-once,
        same contract as the per-record loop, coarser granularity)."""
        n = 0
        for p in range(self.log.n_partitions):
            lam = self._lambdas[p]
            batch = getattr(lam, "handler_batch", None)
            wants = getattr(lam, "wants", None)
            while True:
                recs = self.log.read(
                    self.topic, p, self._offsets[p], limit=256
                )
                if not recs:
                    break
                if batch is not None:
                    try:
                        outs = batch(recs)
                    except BatchHandlerError as be:
                        # Commit the completed prefix exactly as the
                        # per-record loop would have, then surface the
                        # failing record's error.
                        if be.outputs:
                            self._emit(be.outputs)
                        if be.n_ok:
                            self._offsets[p] = recs[be.n_ok - 1].offset + 1
                            self._since_checkpoint[p] += be.n_ok
                        raise be.cause
                    if outs:
                        self._emit(outs)
                else:
                    for rec in recs:
                        value = rec.value
                        if wants is not None and value.get("t") not in wants:
                            continue
                        outs = lam.handler(rec.key, value)
                        if outs:
                            self._emit(outs)
                self._offsets[p] = recs[-1].offset + 1
                n += len(recs)
                self._since_checkpoint[p] += len(recs)
                if self._since_checkpoint[p] >= self.checkpoint_every:
                    self.checkpoint(p)
        return n

    def _emit(self, outs: List[Tuple[str, str, Any]]) -> None:
        # Produce failures (the ``queue.send`` boundary) retry with
        # backoff: the in-proc log's boxcar append is atomic w.r.t. the
        # injection boundary, so a retried batch never half-lands; an
        # exhausted retry raises BEFORE the offset advances — the chunk
        # replays and deli's deterministic re-production plus downstream
        # dedup absorb it (the documented at-least-once model).
        by_topic: Dict[str, List[Tuple[str, Any]]] = {}
        for out_topic, out_key, out_value in outs:
            by_topic.setdefault(out_topic, []).append((out_key, out_value))
        for topic, entries in by_topic.items():
            send_batch = getattr(self.log, "send_batch", None)
            if send_batch is not None:
                retry.call_with_retry("queue.send", send_batch, topic, entries)
            else:  # minimal log impls (native binding) only expose send
                for key, value in entries:
                    retry.call_with_retry(
                        "queue.send", self.log.send, topic, key, value
                    )

    def checkpoint(self, partition: Optional[int] = None) -> None:
        parts = range(self.log.n_partitions) if partition is None else [partition]
        for p in parts:
            lam = self._lambdas[p]
            self.checkpoints.save(
                self.group, p, self._offsets[p], lam.state(),
                merge=getattr(lam, "incremental_state", False),
            )
            self.log.commit(self.group, self.topic, p, self._offsets[p])
            self._since_checkpoint[p] = 0


# ---------------------------------------------------------------------------
# Deli — the sequencer lambda


class DeliDocLambda(PartitionLambda):
    """Per-document deli: wraps the pure DocumentSequencer ticket loop and
    lowers raw control/op records to sequenced messages on ``deltas`` (and
    signal numbers on ``signals``)."""

    def __init__(self, doc_id: str, state: Optional[dict] = None):
        self.doc_id = doc_id
        checkpoint = None
        self._signal_counter = 0
        # Monotone dedupe floor per service-signal group: an upstream
        # service lambda (foreman) replaying under at-least-once delivery
        # re-emits signals it already sent; each carries a ``basis`` (the
        # sequenced message that caused it), and deli drops any at or
        # below the group's floor — exactly-once effect without the
        # emitter needing its own durable send state.
        self._signal_basis: Dict[str, int] = {}
        if state is not None:
            checkpoint = SequencerCheckpoint(**state["sequencer"])
            self._signal_counter = state["signals"]
            self._signal_basis = dict(state.get("signal_basis", {}))
        self.sequencer = DocumentSequencer(doc_id, checkpoint)

    def state(self) -> dict:
        return {
            "sequencer": self.sequencer.checkpoint_dict(),
            "signals": self._signal_counter,
            "signal_basis": dict(self._signal_basis),
        }

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        t = value["t"]
        if t == "opframe":
            # Hot path: no per-record metric object — a Lumber allocation
            # per frame was measurable serving-path overhead; sampled op
            # tracing (alfred's 1-in-N stamp) remains the observability
            # story for the data plane, metrics cover the control plane.
            return self._handle_frame(key, value)
        if t == "op":
            return self._handle(key, value, t)
        metric = Lumberjack.new_metric(
            LumberEventName.DeliHandler,
            {"tenantId": "local", "documentId": self.doc_id, "recordType": t},
        )
        try:
            out = self._handle(key, value, t)
        except Exception as e:  # pragma: no cover - defensive
            metric.error("deli handler failed", e)
            raise
        metric.success()
        return out

    def _handle(self, key: str, value: dict, t: str) -> List[Tuple[str, str, Any]]:
        out: List[Tuple[str, str, Any]] = []
        if t == "join":
            res = self.sequencer.join(value.get("mode", "write"))
            if isinstance(res, NackMessage):
                out.append(
                    (DELTAS_TOPIC, key, {"t": "nack", "token": value.get("token"),
                                         "nack": res})
                )
            else:
                # The reply token rides the sequenced join so the front
                # door can match slot assignments to connect calls.
                res.contents = {**res.contents, "token": value.get("token")}
                out.append((DELTAS_TOPIC, key, {"t": "seq", "msg": res}))
        elif t == "leave":
            res = self.sequencer.leave(value["client"])
            if res is not None:
                out.append((DELTAS_TOPIC, key, {"t": "seq", "msg": res}))
        elif t == "op":
            res = self.sequencer.ticket(value["client"], value["msg"])
            if isinstance(res, NackMessage):
                out.append(
                    (DELTAS_TOPIC, key,
                     {"t": "nack", "client": value["client"], "nack": res})
                )
            elif res is not None:
                out.append((DELTAS_TOPIC, key, {"t": "seq", "msg": res}))
            # duplicates (None) are dropped silently (checkOrder)
        elif t == "opframe":
            out.extend(self._handle_frame(key, value))
        elif t == "summary_decision":
            ack = self.sequencer._sequence_system(
                MessageType.SUMMARY_ACK if value["ok"] else MessageType.SUMMARY_NACK,
                contents={
                    "handle": value["handle"],
                    "summary_seq": value["summary_seq"],
                    "head": value["head"],
                },
            )
            out.append((DELTAS_TOPIC, key, {"t": "seq", "msg": ack}))
        elif t == "signal":
            group = value.get("group")
            if group is not None:
                basis = value["basis"]
                if basis <= self._signal_basis.get(group, 0):
                    return out  # replayed service signal: already sent
                self._signal_basis[group] = basis
            self._signal_counter += 1
            out.append(
                (SIGNALS_TOPIC, key,
                 {"client": value["client"], "num": self._signal_counter,
                  "content": value["content"]})
            )
        else:  # pragma: no cover
            raise ValueError(f"unknown raw record {value!r}")
        return out

    def _handle_frame(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        """Ticket a batched binary op frame (protocol/opframe.py) in one
        vectorized call and emit the sequenced frame as ONE deltas record
        — the wire path that keeps per-op Python off the serving path.
        The whole-frame-valid case (no dup prefix, no trailing nack — the
        steady-state stream) stamps with cached aranges and reuses the
        frame's texts tuple without the per-op insert scan."""
        from fluidframework_tpu_torch.protocol.constants import (
            F_CLIENT, F_MSN, F_REF, F_SEQ, F_TYPE, OP_INSERT,
        )
        from fluidframework_tpu_torch.protocol.opframe import SeqFrame
        from fluidframework_tpu_torch.service.sequencer import FrameTicket

        client = value["client"]
        frame = value["frame"]
        # Sampled frame (trace list rides the record envelope): the
        # alfred span closes at pump dequeue, the deli span brackets the
        # vectorized ticket. Untraced frames skip every stamp.
        traces = value.get("traces")
        if traces is not None:
            tracing.stamp(traces, tracing.STAGE_ALFRED, "end")
            tracing.stamp(traces, tracing.STAGE_DELI, "start")
        fr = frame.rows
        prof = profiler._ON  # the timeline's ticket lane (one
        # predicate untraced; armed, the SAME two perf_counter reads
        # bracket the native ticketer call)
        if prof:
            t_tk0 = time.perf_counter()
        res = self.sequencer.ticket_frame(
            client, frame.csn0, frame.n, fr[:, F_REF]
        )
        if prof:
            profiler.record(
                "ticket", t_tk0, time.perf_counter(), rows=frame.n
            )
        if traces is not None:
            tracing.stamp(traces, tracing.STAGE_DELI, "end")
        if res is None:
            # Whole-frame duplicate (MSN/csn dedup): silently dropped on
            # the wire by contract — but the flight recorder remembers,
            # so a dup-nacked op's lineage shows WHERE its resubmit died.
            if journal._ON:
                journal.record(
                    "frame.nack", doc=key, client=client, csn=frame.csn0,
                    csn_hi=frame.csn0 + frame.n - 1, reason="dup",
                )
            return []
        if isinstance(res, NackMessage):
            if journal._ON:
                journal.record(
                    "frame.nack", doc=key, client=client, csn=frame.csn0,
                    csn_hi=frame.csn0 + frame.n - 1,
                    reason=getattr(
                        res.error_type, "name", str(res.error_type)
                    ),
                )
            return [(DELTAS_TOPIC, key, {"t": "nack", "client": client,
                                         "nack": res})]
        assert isinstance(res, FrameTicket)
        whole = res.drop == 0 and res.m == frame.n
        rows = np.array(fr if whole else fr[res.drop : res.drop + res.m],
                        np.int32)
        rows[:, F_SEQ] = res.seq0 + _arange(res.m)
        rows[:, F_MSN] = res.msn
        rows[:, F_CLIENT] = client
        if whole:
            texts = frame.texts
        else:
            ins = fr[:, F_TYPE] == OP_INSERT
            t_lo = int(np.count_nonzero(ins[: res.drop]))
            t_hi = int(np.count_nonzero(ins[: res.drop + res.m]))
            texts = frame.texts[t_lo:t_hi]
        sf = SeqFrame(
            frame.address, client, frame.csn0 + res.drop, rows, texts,
            res.timestamp,
        )
        if journal._ON:
            # The ticket event is the lineage JOIN point: it maps the
            # op's pre-sequencing identity (client, csn) to its sequence
            # number, so journal.lineage(doc, seq) can pull in the
            # submit/admit half recorded before a seq existed.
            journal.record(
                "frame.ticket", doc=key, seq=res.seq0,
                seq_hi=res.seq0 + res.m - 1, csn=frame.csn0 + res.drop,
                csn_hi=frame.csn0 + res.drop + res.m - 1, client=client,
            )
        seq_rec: Dict[str, Any] = {"t": "seqframe", "frame": sf}
        if traces is not None:
            # The SAME list object rides the sequenced record: every
            # downstream consumer group (scriptorium, broadcaster, the
            # device stage) stamps into it in-proc.
            seq_rec["traces"] = traces
        out: List[Tuple[str, str, Any]] = [(DELTAS_TOPIC, key, seq_rec)]
        if res.trailing_nack is not None:
            out.append((DELTAS_TOPIC, key, {"t": "nack", "client": client,
                                            "nack": res.trailing_nack}))
        return out


# ---------------------------------------------------------------------------
# Scribe — summary validation + ack decision


class ScribeDocLambda(PartitionLambda):
    def __init__(self, doc_id: str, state: Optional[dict], store):
        self.doc_id = doc_id
        self.store = store
        self.protocol_head = state["protocol_head"] if state else 0
        self.latest_summary: Optional[tuple] = (
            tuple(state["latest"]) if state and state["latest"] else None
        )
        self._decided: set = set(state["decided"]) if state else set()

    def state(self) -> dict:
        return {
            "protocol_head": self.protocol_head,
            "latest": list(self.latest_summary) if self.latest_summary else None,
            "decided": sorted(self._decided),
        }

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        if value["t"] != "seq":
            return []
        msg: SequencedDocumentMessage = value["msg"]
        if msg.type != MessageType.SUMMARIZE:
            return []
        if msg.sequence_number in self._decided:
            return []  # replay after crash: decision already produced
        self._decided.add(msg.sequence_number)
        from fluidframework_tpu_torch.service.summary_store import scribe_decide

        m = Lumberjack.new_metric(
            LumberEventName.SummaryWrite,
            {"tenantId": "local", "documentId": self.doc_id,
             "summarySequenceNumber": msg.sequence_number},
        )
        ok, contents = scribe_decide(msg, self.protocol_head, self.store)
        handle, head = contents["handle"], contents["head"]
        if ok:
            self.latest_summary = (handle, head)
            self.protocol_head = msg.sequence_number
            m.success()
        else:
            m.error("summary nacked")
        return [
            (RAW_TOPIC, key,
             {"t": "summary_decision", "ok": ok, "handle": handle,
              "head": head, "summary_seq": msg.sequence_number})
        ]


# ---------------------------------------------------------------------------
# Scriptorium — durable op log (the Mongo deltas collection)


def stored_message(v) -> SequencedDocumentMessage:
    """Materialize one ops-store entry: plain sequenced messages are
    stored as-is; frame ops are stored as ``(SeqFrame, i)`` and expand
    lazily here (read-time cost, only for the range a reader asks for)."""
    return v[0].message(v[1]) if isinstance(v, tuple) else v


class DocOpLog:
    """One document's durable op index (the Mongo deltas collection).

    Point ops (the JSON wire, system messages) store per seq; a sequenced
    FRAME stores ONCE — one list append for its whole contiguous seq run,
    not a dict write per covered op (at 10k+ frames/round the per-op
    writes were the entire scriptorium stage cost). Reads resolve frame
    seqs by bisect and expand lazily through :func:`stored_message`, so
    the read-time shape is unchanged: this class keeps the seq-keyed
    mapping surface (iter/len/contains/getitem/items) the service's
    delta readers and tests already use.

    Idempotence under at-least-once replay: deli re-produces identical
    frames, and per-doc partition order means a replayed frame's run can
    never extend past the stored head — anything at or below it drops.
    """

    __slots__ = ("ops", "frames", "_starts", "head")

    def __init__(self):
        self.ops: Dict[int, SequencedDocumentMessage] = {}
        self.frames: list = []  # ascending, non-overlapping seq runs
        self._starts: List[int] = []  # frames[i].first_seq (bisect key)
        self.head = 0  # highest stored seq (O(1) doc_head probe)

    @inject_fault("store.append")
    def add_msg(self, msg: SequencedDocumentMessage) -> None:
        seq = msg.sequence_number
        self.ops[seq] = msg
        if seq > self.head:
            self.head = seq

    @inject_fault("store.append")
    def add_frame(self, frame) -> None:
        if frame.last_seq <= self.head:
            return  # replay duplicate: identical re-production, drop
        self.frames.append(frame)
        self._starts.append(frame.first_seq)
        self.head = frame.last_seq

    def _frame_entry(self, seq: int):
        import bisect

        i = bisect.bisect_right(self._starts, seq) - 1
        if i >= 0:
            f = self.frames[i]
            if seq <= f.last_seq:
                return (f, seq - f.first_seq)
        return None

    # -- the seq-keyed mapping surface ----------------------------------------

    def __len__(self) -> int:
        return len(self.ops) + sum(f.n for f in self.frames)

    def __iter__(self):
        yield from self.ops
        for f in self.frames:
            yield from range(f.first_seq, f.last_seq + 1)

    def __contains__(self, seq) -> bool:
        return seq in self.ops or self._frame_entry(seq) is not None

    def __getitem__(self, seq):
        m = self.ops.get(seq)
        if m is not None:
            return m
        entry = self._frame_entry(seq)
        if entry is None:
            raise KeyError(seq)
        return entry

    def get(self, seq, default=None):
        m = self.ops.get(seq)
        if m is not None:
            return m
        entry = self._frame_entry(seq)
        return default if entry is None else entry

    def items(self):
        yield from self.ops.items()
        for f in self.frames:
            s0 = f.first_seq
            for i in range(f.n):
                yield s0 + i, (f, i)

    def keys(self):
        return iter(self)


class ScriptoriumLambda(PartitionLambda):
    """Idempotent insert of sequenced ops keyed by (doc, seq): one
    :class:`DocOpLog` per document, frames stored whole.

    Recovery contract for the ``store.append`` boundary: appends retry
    with jittered backoff (``service/retry.py`` — the append is
    idempotent under the head watermark, so a retry of a half-observed
    failure cannot double-store); EXHAUSTED retries raise through the
    runner, whose offset then never advances past the frame — the record
    replays on the next pump (at-least-once), so no sequenced op is ever
    lost to a store outage and none duplicates."""

    wants = frozenset({"seq", "seqframe"})

    def __init__(self, ops_store: Dict[str, DocOpLog]):
        self.ops_store = ops_store

    def _doc(self, key: str) -> DocOpLog:
        log = self.ops_store.get(key)
        if log is None:
            log = self.ops_store[key] = DocOpLog()
        return log

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        if value["t"] == "seq":
            retry.call_with_retry(
                "store.append", self._doc(key).add_msg, value["msg"]
            )
            if journal._ON:
                journal.record(
                    "log.append", doc=key,
                    seq=value["msg"].sequence_number,
                )
        elif value["t"] == "seqframe":
            traces = value.get("traces")
            if traces is not None:
                tracing.stamp(traces, tracing.STAGE_SCRIPTORIUM, "start")
            retry.call_with_retry(
                "store.append", self._doc(key).add_frame, value["frame"]
            )
            if traces is not None:
                tracing.stamp(traces, tracing.STAGE_SCRIPTORIUM, "end")
            if journal._ON:
                journal.record(
                    "log.append", doc=key, seq=value["frame"].first_seq,
                    seq_hi=value["frame"].last_seq,
                )
        return []

    def handler_batch(self, recs) -> List[Tuple[str, str, Any]]:
        store = self.ops_store
        for rec in recs:
            value = rec.value
            t = value.get("t")
            if t == "seqframe":
                traces = value.get("traces")
                if traces is not None:
                    tracing.stamp(
                        traces, tracing.STAGE_SCRIPTORIUM, "start"
                    )
                log = store.get(rec.key)
                if log is None:
                    log = store[rec.key] = DocOpLog()
                retry.call_with_retry(
                    "store.append", log.add_frame, value["frame"]
                )
                if traces is not None:
                    tracing.stamp(traces, tracing.STAGE_SCRIPTORIUM, "end")
                if journal._ON:
                    journal.record(
                        "log.append", doc=rec.key,
                        seq=value["frame"].first_seq,
                        seq_hi=value["frame"].last_seq,
                    )
            elif t == "seq":
                retry.call_with_retry(
                    "store.append", self._doc(rec.key).add_msg, value["msg"]
                )
                if journal._ON:
                    journal.record(
                        "log.append", doc=rec.key,
                        seq=value["msg"].sequence_number,
                    )
        return []

    def state(self) -> Any:
        return None  # the store itself is the durable artifact


# ---------------------------------------------------------------------------
# Broadcaster — fan-out to client connections (socket rooms)


class BroadcasterLambda(PartitionLambda):
    """Delivers sequenced ops to every connection in the document's room,
    dropping anything a connection already saw (idempotent under replay)."""

    wants = frozenset({"seq", "seqframe", "nack"})

    def __init__(self, rooms: Dict[str, list], observe_traces: bool = False):
        self.rooms = rooms
        # Per-op span reduction is OPT-IN, on only when the SERVICE
        # samples traces (traces is a client-controlled wire field; with
        # sampling off nothing the server didn't ask for may reach the
        # registry — so client-trust must never be the default).
        self.observe_traces = observe_traces

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        conns = self.rooms.get(key, [])
        if value["t"] == "seq":
            msg = value["msg"]
            if (
                self.observe_traces
                and msg.traces
                and tracing.has_stamp(
                    msg.traces, tracing.STAGE_ALFRED, "start"
                )
                and not tracing.has_stamp(
                    msg.traces, tracing.STAGE_ALFRED, "end"
                )
            ):
                # Sampled per-op path: broadcast is where the op leaves
                # the service, so the front door's span closes HERE — the
                # missing ``alfred end`` that kept spans() from ever
                # producing ``alfred_ms`` — and the completed trace
                # reduces into the registry. The not-already-ended guard
                # keeps a deli crash/replay (same sequenced op re-emitted
                # downstream) from double-observing the span.
                tracing.stamp(msg.traces, tracing.STAGE_ALFRED, "end")
                metrics.observe_stage_spans(tracing.spans(msg.traces))
            if journal._ON:
                journal.record(
                    "broadcast", doc=key, seq=msg.sequence_number,
                    conns=len(conns),
                )
            for conn in conns:
                if msg.sequence_number > conn.delivered_seq:
                    conn.inbox.append(msg)
                    conn.delivered_seq = msg.sequence_number
        elif value["t"] == "seqframe":
            # One inbox append per frame per connection; take_inbox (or
            # the socket drain) expands. A partially-delivered frame
            # (replay straddling the watermark) expands the tail only.
            frame = value["frame"]
            traces = value.get("traces")
            if traces is not None:
                tracing.stamp(traces, tracing.STAGE_BROADCAST, "start")
            if journal._ON:
                journal.record(
                    "broadcast", doc=key, seq=frame.first_seq,
                    seq_hi=frame.last_seq, conns=len(conns),
                )
            for conn in conns:
                if frame.last_seq <= conn.delivered_seq:
                    continue
                if frame.first_seq > conn.delivered_seq:
                    conn.inbox.append(frame)
                else:
                    conn.inbox.extend(
                        frame.messages(conn.delivered_seq - frame.first_seq + 1)
                    )
                conn.delivered_seq = frame.last_seq
            if traces is not None:
                tracing.stamp(traces, tracing.STAGE_BROADCAST, "end")
        elif value["t"] == "nack":
            for conn in conns:
                if value.get("client") == conn.client_id or (
                    value.get("token") is not None
                    and value.get("token") == conn.token
                ):
                    conn.nacks.append(value["nack"])
                    if conn.on_nack:
                        conn.on_nack(value["nack"])
        return []


class SignalBroadcasterLambda(PartitionLambda):
    def __init__(self, rooms: Dict[str, list]):
        self.rooms = rooms

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        from fluidframework_tpu_torch.protocol.types import SignalMessage

        for conn in self.rooms.get(key, []):
            if value["num"] > conn.delivered_signal:
                conn.signals.append(
                    SignalMessage(
                        client_id=value["client"],
                        client_connection_number=value["num"],
                        content=value["content"],
                    )
                )
                conn.delivered_signal = value["num"]
        return []
