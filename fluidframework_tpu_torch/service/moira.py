"""Moira — changeset streaming to an external index.

Reference: ``server/routerlicious/packages/lambdas/src/moira/lambda.ts:19``
— the one service stage whose job is feeding a NON-Fluid consumer: it
batches sequenced ops per document, derives a commit guid from a content
hash, and POSTs branch/commit records to the materialized-history
endpoint, checkpointing its input offset only after the external service
acknowledged the batch. Delivery is therefore at-least-once: a crash
between post and checkpoint replays the batch, and the external service
absorbs the duplicate because commits are keyed by their deterministic
guid.

This analog keeps exactly that shape on the ``deltas`` topic:

- :class:`MoiraLambda` is a :class:`~fluidframework_tpu_torch.service.lambdas.
  PartitionLambda` batching content-bearing sequenced ops per document
  and pushing commit records into an :class:`IndexSink`;
- commit guids are sha256 over ``(doc, seq, serialized op)`` — replays
  re-derive byte-identical guids, so the sink's upsert is the
  idempotence point (the reference's moira service behaves the same);
- the lambda's durable state is the per-doc high-water seq of commits
  the SINK ACKNOWLEDGED — restored on restart, so resume never skips
  (gap-free) and the guid upsert never duplicates (dup-free);
- a sink failure leaves the batch pending: the lambda re-raises so the
  runner does NOT advance the offset, and the next pump retries
  (at-least-once against a flaky external service).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.protocol.types import MessageType
from fluidframework_tpu_torch.service.lambdas import PartitionLambda


class SinkUnavailable(Exception):
    """The external index refused a batch — retry on a later pump."""


class IndexSink:
    """The external-consumer contract: branch per document, commits
    upserted by guid. Implementations must make ``commit`` idempotent on
    ``guid`` — that is the at-least-once absorption point."""

    def ensure_branch(self, doc_id: str) -> str:
        raise NotImplementedError

    def commit(self, branch: str, guid: str, record: dict) -> None:
        raise NotImplementedError


class MaterializedIndexSink(IndexSink):
    """In-proc reference sink (the materialized-history analog): ordered
    per-branch commit log, guid-idempotent. Counts duplicate posts so
    tests can PROVE absorption happened rather than absence of retries.
    ``fail_every`` injects transient unavailability (every Nth commit
    call raises before applying) to exercise the retry path."""

    def __init__(self, fail_every: int = 0):
        self.branches: Dict[str, str] = {}
        self.commits: Dict[str, Dict[str, dict]] = {}
        self.order: Dict[str, List[str]] = {}
        self.duplicate_posts = 0
        self.commit_calls = 0
        self.fail_every = fail_every

    def ensure_branch(self, doc_id: str) -> str:
        b = self.branches.get(doc_id)
        if b is None:
            b = self.branches[doc_id] = f"branch-{len(self.branches)}"
            self.commits[b] = {}
            self.order[b] = []
        return b

    def commit(self, branch: str, guid: str, record: dict) -> None:
        self.commit_calls += 1
        if self.fail_every and self.commit_calls % self.fail_every == 0:
            raise SinkUnavailable("injected index outage")
        if guid in self.commits[branch]:
            self.duplicate_posts += 1  # absorbed, not re-applied
            return
        self.commits[branch][guid] = record
        self.order[branch].append(guid)

    def doc_seqs(self, doc_id: str) -> List[int]:
        """Sequence numbers indexed for a document, in commit order."""
        b = self.branches.get(doc_id)
        if b is None:
            return []
        return [self.commits[b][g]["seq"] for g in self.order[b]]


def _commit_guid(doc_id: str, seq: int, payload: str) -> str:
    return hashlib.sha256(
        f"{doc_id}:{seq}:{payload}".encode()
    ).hexdigest()


class MoiraLambda(PartitionLambda):
    """Changeset streamer on the deltas topic (moira/lambda.ts:19).

    Durable state: per-doc acked high-water seq. The handler filters
    content-bearing sequenced ops at or below the high-water (replayed
    input after a crash) and posts the rest; only a fully-acked batch
    advances the water mark, and any sink failure propagates so the
    partition offset stays put (the runner replays from the checkpoint)."""

    def __init__(self, sink: IndexSink, state: Optional[dict] = None):
        self.sink = sink
        self.acked_seq: Dict[str, int] = dict(
            (state or {}).get("acked_seq", {})
        )
        self.posted = 0
        self.skipped_replays = 0

    def state(self) -> dict:
        return {"acked_seq": dict(self.acked_seq)}

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        if value.get("t") == "seqframe":
            # Batched binary wire: expand to per-op commits (the external
            # index consumes one changeset per op; this path is opt-in
            # and off the serving hot loop). Partial-failure safety is
            # per-op: acked_seq advances as each commit lands, so a sink
            # outage mid-frame replays only the tail.
            for m in value["frame"].messages():
                self.handler(key, {"t": "seq", "msg": m})
            return []
        if value.get("t") != "seq":
            return []
        msg = value["msg"]
        if msg.type != MessageType.OPERATION or msg.contents is None:
            return []
        doc_id = key
        seq = msg.sequence_number
        if seq <= self.acked_seq.get(doc_id, 0):
            self.skipped_replays += 1  # replayed input below the water
            return []
        payload = json.dumps(msg.contents, sort_keys=True, default=str)
        guid = _commit_guid(doc_id, seq, payload)
        branch = self.sink.ensure_branch(doc_id)
        # May raise SinkUnavailable: the runner then neither advances the
        # offset nor checkpoints — this exact record replays next pump.
        self.sink.commit(
            branch, guid,
            {
                "doc": doc_id,
                "seq": seq,
                "client": msg.client_id,
                "ref": msg.reference_sequence_number,
                "contents": payload,
            },
        )
        self.acked_seq[doc_id] = seq
        self.posted += 1
        return []
