"""The sequencer — deli semantics as a pure per-document state machine.

TPU-native re-design of the reference's deli lambda
(``server/routerlicious/packages/lambdas/src/deli/lambda.ts`` — ``ticket()``
at :742, MSN calc :929-938, dedup/gap ``checkOrder`` :789-798, nack rules
:864-893) and its per-client heap (``clientSeqManager.ts``).

One :class:`DocumentSequencer` owns one document's total order: it validates
inbound raw ops (dedup, gap, stale refSeq), assigns ``sequenceNumber``,
maintains the client table and the minimum sequence number, and emits
sequenced messages. It is deliberately pure/host-side — the ordering path is
not device work; its output batches are what the TPU kernel consumes.

Client slots are small ints (0..MAX_WRITERS-1) so sequenced ops lower
directly to int32 kernel rows.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from fluidframework_tpu_torch.protocol.constants import MAX_WRITERS
from fluidframework_tpu_torch.telemetry import tracing
from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    MessageType,
    NackErrorType,
    NackMessage,
    SequencedDocumentMessage,
)


FULL_SCOPES = ("doc:read", "doc:write", "summary:write")


@dataclass
class _ClientEntry:
    client_id: int
    ref_seq: int
    client_seq: int  # highest clientSequenceNumber seen
    can_evict: bool = True
    mode: str = "write"
    last_seen: float = 0.0  # wall time of last op/join (idle expiry)
    scopes: tuple = FULL_SCOPES  # token claims (reference scopes.ts)


@dataclass
class FrameTicket:
    """Result of a successful (possibly partial) ``ticket_frame``."""

    drop: int  # leading replay duplicates dropped
    m: int  # ops ticketed (rows drop..drop+m-1)
    seq0: int  # first assigned sequence number (contiguous run of m)
    msn: "object"  # np.ndarray [m] per-op minimum sequence numbers
    timestamp: float
    trailing_nack: Optional[NackMessage] = None  # first op past the valid run


@dataclass
class SequencerCheckpoint:
    """Durable sequencer state (reference ``IDeliState``,
    services-core/src/document.ts:56): enough to resume after a crash."""

    sequence_number: int
    minimum_sequence_number: int
    clients: List[dict] = field(default_factory=list)
    next_slot: int = 0
    free_slots: List[List[int]] = field(default_factory=list)  # [slot, leave_seq]
    connection_count: int = 0  # monotonic join ordinal, never recycled


class DocumentSequencer:
    """Assigns the total order for one document (deli ``ticket()``)."""

    def __init__(self, doc_id: str, checkpoint: Optional[SequencerCheckpoint] = None):
        self.doc_id = doc_id
        self.seq = 0
        self.min_seq = 0
        # Control plane (reference deli lambda.ts:989+ ControlMessageType):
        # durable sequence number (UpdateDSN — the log-truncation floor) and
        # maintenance nacking (NackMessages).
        self.durable_seq = 0
        self._nack_all: Optional[dict] = None  # {"code", "message"}
        self._no_client_emitted = True  # fresh doc has no clients
        self.clients: Dict[int, _ClientEntry] = {}
        self._next_slot = 0
        # Slots released by leaves, reusable once their leave seq falls at or
        # below the collab-window floor: every stamp from the old holder is
        # then acked and outside any perspective the kernel can be asked for,
        # so a new holder cannot collide (deli has no cap — string client
        # ids; the int-slot design needs recycling to live that long).
        self._free_slots: List[List[int]] = []
        # Slots are kernel-facing and recycle; the connection ordinal is the
        # never-recycled identity clients scope content ids to (a recycled
        # slot must not collide payload/cell id keyspaces).
        self._conn_count = 0
        if checkpoint is not None:
            self.seq = checkpoint.sequence_number
            self.min_seq = checkpoint.minimum_sequence_number
            self._next_slot = checkpoint.next_slot
            self._free_slots = [list(x) for x in checkpoint.free_slots]
            self._conn_count = checkpoint.connection_count
            for c in checkpoint.clients:
                self.clients[c["client_id"]] = _ClientEntry(**c)

    # -- session management --------------------------------------------------

    def join(
        self, mode: str = "write", scopes: tuple = FULL_SCOPES
    ) -> Union[SequencedDocumentMessage, NackMessage]:
        """Admit a client; returns the sequenced ClientJoin op.

        The slot cap mirrors the kernel's removers bitmask width: deli's
        1M-clients/doc cap (config.json:57) becomes MAX_WRITERS concurrent
        write slots per document in round 1.
        """
        slot = None
        for i, (s, leave_seq) in enumerate(self._free_slots):
            if leave_seq <= self.min_seq:
                slot = s
                del self._free_slots[i]
                break
        if slot is None:
            if self._next_slot >= MAX_WRITERS:
                return NackMessage(
                    self.seq, 429, NackErrorType.LIMIT_EXCEEDED,
                    f"document writer slots exhausted ({MAX_WRITERS})",
                )
            slot = self._next_slot
            self._next_slot += 1
        # Join contents carry the client detail (reference ClientJoin op's
        # IClient payload) — election needs the mode for eligibility, and
        # connNo is the never-recycled ordinal content ids scope to.
        self._conn_count += 1
        self._no_client_emitted = False
        msg = self._sequence_system(
            MessageType.CLIENT_JOIN,
            contents={"clientId": slot, "mode": mode, "connNo": self._conn_count},
        )
        # The new client's collab-window floor is the join op itself.
        self.clients[slot] = _ClientEntry(
            client_id=slot, ref_seq=msg.sequence_number, client_seq=0, mode=mode,
            last_seen=time.time(), scopes=tuple(scopes),
        )
        return msg

    def leave(self, client_id: int) -> Optional[SequencedDocumentMessage]:
        if client_id not in self.clients:
            return None
        del self.clients[client_id]
        msg = self._sequence_system(MessageType.CLIENT_LEAVE, contents=client_id)
        self._free_slots.append([client_id, msg.sequence_number])
        return msg

    def maybe_no_client(self) -> Optional[SequencedDocumentMessage]:
        """Emit a NoClient system op once when the last client departs
        (reference deli op-events, lambda.ts:136-150) — the service's
        trigger for an end-of-session service summary."""
        if self.clients or self._no_client_emitted:
            return None
        self._no_client_emitted = True
        return self._sequence_system(MessageType.NO_CLIENT, contents=None)

    # -- control plane (reference ControlMessageType, deli lambda.ts:989+) ---

    def control(self, contents: dict) -> SequencedDocumentMessage:
        """Apply a sequenced service control message.

        - ``{"type": "updateDSN", "dsn": N}`` advances the durable sequence
          number (the storage-confirmed floor log truncation may use);
        - ``{"type": "nackMessages", "enable": bool, "code"?, "message"?}``
          toggles maintenance mode: while enabled every client op is nacked
          with the given code (the reference's NackMessages control).
        """
        kind = contents.get("type")
        if kind == "updateDSN":
            self.durable_seq = max(self.durable_seq, int(contents["dsn"]))
        elif kind == "nackMessages":
            if contents.get("enable", True):
                self._nack_all = {
                    "code": int(contents.get("code", 503)),
                    "message": contents.get("message", "service paused"),
                }
            else:
                self._nack_all = None
        else:
            raise ValueError(f"unknown control message {kind!r}")
        return self._sequence_system(MessageType.CONTROL, contents=contents)

    def expire_idle(
        self, timeout_s: float, now: Optional[float] = None
    ) -> List[SequencedDocumentMessage]:
        """Evict clients idle past ``timeout_s`` (reference deli expires
        stale clients via ClientSequenceTimeout so a crashed client that
        never sent leave cannot pin the MSN forever). Returns the sequenced
        leave messages to broadcast."""
        now = time.time() if now is None else now
        stale = [
            c.client_id
            for c in self.clients.values()
            if c.can_evict and now - c.last_seen > timeout_s
        ]
        out = []
        for cid in stale:
            msg = self.leave(cid)
            if msg is not None:
                out.append(msg)
        return out

    # -- the ticket loop ------------------------------------------------------

    def ticket(
        self, client_id: int, msg: DocumentMessage
    ) -> Union[SequencedDocumentMessage, NackMessage, None]:
        """Sequence one raw client op. Returns the sequenced message, a nack,
        or None for a duplicate (silently dropped, reference checkOrder)."""
        entry = self.clients.get(client_id)
        if entry is None:
            return NackMessage(
                self.seq, 400, NackErrorType.BAD_REQUEST, "unknown client"
            )
        if entry.mode != "write":
            return NackMessage(
                self.seq, 403, NackErrorType.INVALID_SCOPE, "read-only client"
            )
        if self._nack_all is not None:
            # Maintenance mode (NackMessages control): reject without
            # consuming the clientSequenceNumber so a later resubmit works.
            return NackMessage(
                self.seq, self._nack_all["code"],
                NackErrorType.LIMIT_EXCEEDED, self._nack_all["message"],
                retry_after_s=1.0,
                client_sequence_number=msg.client_sequence_number,
            )
        # Duplicate: clientSequenceNumber at-or-below the highest seen.
        if msg.client_sequence_number <= entry.client_seq:
            return None
        # Gap: the client skipped a clientSequenceNumber.
        if msg.client_sequence_number != entry.client_seq + 1:
            return NackMessage(
                self.seq, 400, NackErrorType.BAD_REQUEST,
                f"clientSequenceNumber gap (expected {entry.client_seq + 1})",
                client_sequence_number=msg.client_sequence_number,
            )
        # Stale reference: below the collab window floor.
        if msg.reference_sequence_number < self.min_seq:
            return NackMessage(
                self.seq, 400, NackErrorType.BAD_REQUEST,
                f"refSeq {msg.reference_sequence_number} below MSN {self.min_seq}",
                client_sequence_number=msg.client_sequence_number,
            )
        if (
            msg.type == MessageType.SUMMARIZE
            and "summary:write" not in entry.scopes
        ):
            # Unauthorized Summarize -> 403 (reference deli lambda.ts:884-893).
            return NackMessage(
                self.seq, 403, NackErrorType.INVALID_SCOPE,
                "client token lacks summary:write",
                client_sequence_number=msg.client_sequence_number,
            )
        entry.client_seq = msg.client_sequence_number
        entry.ref_seq = msg.reference_sequence_number
        entry.last_seen = time.time()

        # Sampled op tracing: if the front door stamped this message, the
        # sequencer appends its own span (reference deli/lambda.ts:1451).
        # Stamps go on a copy — the inbound message stays caller-owned.
        traces = list(msg.traces)
        if traces:
            tracing.stamp(traces, "deli", "start")

        # Unlike the reference (deli lambda.ts:896-927 leaves NoOps
        # un-sequenced and coalesces them), NOOPs here consume a sequence
        # number like any op: clients then see a strictly gapless stream,
        # which keeps the device-side scan and the dedup rules uniform.
        self.seq += 1
        if traces:
            tracing.stamp(traces, "deli", "end")
        return SequencedDocumentMessage(
            client_id=client_id,
            sequence_number=self.seq,
            client_sequence_number=msg.client_sequence_number,
            reference_sequence_number=msg.reference_sequence_number,
            minimum_sequence_number=self._compute_msn(),
            type=msg.type,
            contents=msg.contents,
            metadata=msg.metadata,
            timestamp=time.time(),
            traces=traces,
        )

    def ticket_frame(
        self, client_id: int, csn0: int, n: int, refs
    ) -> Union["FrameTicket", NackMessage, None]:
        """Vectorized ticket for an :class:`~fluidframework_tpu_torch.protocol.
        opframe.OpFrame`: n contiguous client ops in one call, with
        per-op semantics identical to n ``ticket()`` calls on OPERATION
        messages — duplicate csns drop from the front, the first invalid
        op nacks and (as per-op ticketing would, via the resulting csn
        gap) implicitly rejects everything after it, MSN advances per op.

        Returns a :class:`FrameTicket` (drop count, valid count, seq0,
        per-op msn array), a NackMessage (``client_sequence_number`` =
        first rejected csn), or None when every op is a replay duplicate.
        """
        import numpy as np

        entry = self.clients.get(client_id)
        if entry is None:
            return NackMessage(
                self.seq, 400, NackErrorType.BAD_REQUEST, "unknown client"
            )
        if entry.mode != "write":
            return NackMessage(
                self.seq, 403, NackErrorType.INVALID_SCOPE, "read-only client"
            )
        if self._nack_all is not None:
            return NackMessage(
                self.seq, self._nack_all["code"],
                NackErrorType.LIMIT_EXCEEDED, self._nack_all["message"],
                retry_after_s=1.0, client_sequence_number=csn0,
            )
        drop = max(0, entry.client_seq - csn0 + 1)
        if drop >= n:
            return None  # whole frame is a replay duplicate
        if csn0 + drop != entry.client_seq + 1:
            return NackMessage(
                self.seq, 400, NackErrorType.BAD_REQUEST,
                f"clientSequenceNumber gap (expected {entry.client_seq + 1})",
                client_sequence_number=csn0 + drop,
            )
        # Fast path — the steady-state serving stream: no dup prefix and
        # every op in the frame shares one refSeq (a client-turn batch
        # authored against one head). MSN per op is then a constant:
        # max(floor, min(r0, others_min)), no per-op pass at all.
        now = time.time()
        if drop == 0:
            r0 = int(refs[0])
            if r0 == int(refs[-1]) and r0 >= self.min_seq and (
                n < 3 or (np.asarray(refs) == r0).all()
            ):
                others_min = None
                for c in self.clients.values():
                    if c.client_id != client_id and (
                        others_min is None or c.ref_seq < others_min
                    ):
                        others_min = c.ref_seq
                floor = r0 if others_min is None else min(r0, others_min)
                if floor < self.min_seq:
                    floor = self.min_seq
                entry.client_seq = csn0 + n - 1
                entry.ref_seq = r0
                entry.last_seen = now
                seq0 = self.seq + 1
                self.seq += n
                self.min_seq = floor
                return FrameTicket(
                    drop=0, m=n, seq0=seq0,
                    msn=np.full(n, floor, np.int32), timestamp=now,
                )
        # General path (per-op semantics in one pass): op i is stale
        # against the MSN established by op i-1 (the freshly advanced
        # floor per-op ticket() checks), and msn_i = max(floor,
        # min(others_min, refs[i])) never regresses. A plain Python loop
        # beats numpy well past typical frame sizes (array overhead
        # ~20µs/frame dominates the deli stage at n<=64).
        others = [
            c.ref_seq for c in self.clients.values() if c.client_id != client_id
        ]
        others_min = min(others) if others else None
        refs_l = [int(x) for x in refs[drop:]]
        n_rem = len(refs_l)
        floor = self.min_seq
        msn_l: List[int] = []
        m = 0
        for r in refs_l:
            if r < floor:
                break
            cand = r if others_min is None else min(r, others_min)
            if cand > floor:
                floor = cand
            msn_l.append(floor)
            m += 1
        if m == 0:
            return NackMessage(
                self.seq, 400, NackErrorType.BAD_REQUEST,
                f"refSeq {refs_l[0]} below MSN {self.min_seq}",
                client_sequence_number=csn0 + drop,
            )
        msn = np.asarray(msn_l, np.int32)
        entry.client_seq = csn0 + drop + m - 1
        entry.ref_seq = refs_l[m - 1]
        entry.last_seen = now
        seq0 = self.seq + 1
        self.seq += m
        self.min_seq = int(msn_l[-1])
        nack = None
        if m < n_rem:
            nack = NackMessage(
                self.seq, 400, NackErrorType.BAD_REQUEST,
                f"refSeq below MSN {self.min_seq}",
                client_sequence_number=csn0 + drop + m,
            )
        return FrameTicket(drop=drop, m=m, seq0=seq0, msn=msn,
                           timestamp=now, trailing_nack=nack)

    # -- internals ------------------------------------------------------------

    def _compute_msn(self) -> int:
        """MSN = min over per-client refSeq; no clients -> current seq
        (deli lambda.ts:929-938). The MSN never regresses."""
        if not self.clients:
            msn = self.seq
        else:
            msn = min(c.ref_seq for c in self.clients.values())
        self.min_seq = max(self.min_seq, msn)
        return self.min_seq

    def _sequence_system(self, ty: MessageType, contents) -> SequencedDocumentMessage:
        self.seq += 1
        return SequencedDocumentMessage(
            client_id=-1,
            sequence_number=self.seq,
            client_sequence_number=-1,
            reference_sequence_number=-1,
            minimum_sequence_number=self._compute_msn(),
            type=ty,
            contents=contents,
            timestamp=time.time(),
        )

    def checkpoint_dict(self) -> dict:
        """Durable state as a plain dict — the ONE serialization of the
        sequencer (``checkpoint()`` wraps it; deli's hot-path checkpoint
        uses it directly to skip the dataclass allocation per dirty doc).
        Keys mirror :class:`SequencerCheckpoint`'s fields exactly."""
        return {
            "sequence_number": self.seq,
            "minimum_sequence_number": self.min_seq,
            "clients": [c.__dict__.copy() for c in self.clients.values()],
            "next_slot": self._next_slot,
            "free_slots": [list(x) for x in self._free_slots],
            "connection_count": self._conn_count,
        }

    def checkpoint(self) -> SequencerCheckpoint:
        return SequencerCheckpoint(**self.checkpoint_dict())
