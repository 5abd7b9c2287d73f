"""Summarizer machinery — election, heuristics, retry, ack tracking.

Reference: ``packages/runtime/container-runtime`` summarizer stack —
``SummaryManager`` spawns the summarizer for the elected client
(summaryManager.ts), ``summarizerClientElection.ts`` +
``orderedClientElection.ts`` pick the oldest eligible interactive client,
``RunningSummarizer`` (runningSummarizer.ts:53,430) runs heuristics
(``summarizerHeuristics.ts``: maxOps / maxTime / idle triggers),
``SummaryGenerator`` submits with retries, and ``SummaryCollection``
(summaryCollection.ts) tracks Summarize -> SummaryAck/Nack on the
sequenced stream.

Host-side control logic: summaries are not device work; the kernels only
feed the channel summary blobs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class SummaryConfig:
    """Heuristic knobs (reference ISummaryConfiguration defaults scaled to
    the in-proc harness)."""

    max_ops: int = 100  # summarize after this many ops since last summary
    max_time_s: float = 60.0  # ... or this much elapsed time with any ops
    min_ops_for_attempt: int = 1  # never summarize with fewer ops than this
    max_attempts: int = 3  # nack/failure retries per summary cycle
    clock: Callable[[], float] = time.time


class SummarizerElection:
    """Oldest eligible client wins (orderedClientElection.ts): quorum join
    order is the election order; read-only clients are ineligible. Runs
    identically on every replica, so no coordination op is needed."""

    def __init__(self, container):
        self._container = container

    @property
    def elected_client_id(self) -> Optional[int]:
        eligible = [
            (detail.get("join_seq", 0), cid)
            for cid, detail in self._container.quorum_members.items()
            if detail.get("mode", "write") == "write"
        ]
        # Earliest-joined wins; slot number only tie-breaks. Slot numbers
        # recycle, so ordering by slot would let a brand-new client that
        # lands a low recycled slot steal the election.
        return min(eligible)[1] if eligible else None

    @property
    def is_elected(self) -> bool:
        return self.elected_client_id == self._container.client_id


@dataclass
class SummaryAttempt:
    handle: str
    head: int
    submitted_at: float
    acked: Optional[bool] = None  # None = in flight


class SummaryCollection:
    """Watches the sequenced stream for Summarize/Ack/Nack (the reference
    SummaryCollection): exposes the latest acked head and pending acks."""

    def __init__(self) -> None:
        self.latest_ack_head = 0
        self.acks: List[dict] = []
        self.nacks: List[dict] = []

    def observe(self, msg) -> None:
        from fluidframework_tpu_torch.protocol.types import MessageType

        if msg.type == MessageType.SUMMARY_ACK:
            self.acks.append(msg.contents)
            self.latest_ack_head = max(self.latest_ack_head, msg.contents["head"])
        elif msg.type == MessageType.SUMMARY_NACK:
            self.nacks.append(msg.contents)


class RunningSummarizer:
    """Heuristic-driven summary loop for the elected client.

    Call :meth:`on_op` for every processed sequenced op (wire it to
    ``container.on_op``) and :meth:`tick` when idle; when the heuristics
    fire it submits a summary and tracks the ack, retrying on nack up to
    ``max_attempts`` (SummaryGenerator retry semantics).
    """

    def __init__(self, container, config: Optional[SummaryConfig] = None):
        self._container = container
        self.config = config or SummaryConfig()
        self.election = SummarizerElection(container)
        self.collection = SummaryCollection()
        self._last_summary_time = self.config.clock()
        self._last_attempt_time = self.config.clock()
        self._attempt: Optional[SummaryAttempt] = None
        self._attempts_this_cycle = 0
        self.summaries_submitted = 0
        # Ops counted toward the heuristics: real operations only — the
        # Summarize/Ack traffic a summary itself generates must not
        # re-trigger the heuristics (else the loop never quiesces).
        self._ops_since_summary = 0

    # -- stream hooks ----------------------------------------------------------

    def on_op(self, msg) -> None:
        from fluidframework_tpu_torch.protocol.types import MessageType

        self.collection.observe(msg)
        if msg.type == MessageType.OPERATION:
            self._ops_since_summary += 1
        if msg.type == MessageType.SUMMARY_ACK:
            self._ops_since_summary = 0
            self._last_summary_time = self.config.clock()
            if self._attempt is not None:
                self._attempt.acked = True
                self._attempt = None
                self._attempts_this_cycle = 0
        elif msg.type == MessageType.SUMMARY_NACK and self._attempt is not None:
            self._attempt.acked = False
            self._attempt = None
        self.tick()

    def tick(self) -> None:
        """Evaluate heuristics; submit when they fire (heuristics run only
        on the elected client, with no unacked local ops in flight)."""
        c = self._container
        if (
            self._attempt is not None
            or not self.election.is_elected
            or c.pending
            or c._outbox
        ):
            return
        ops_since = self._ops_since_summary
        if ops_since < self.config.min_ops_for_attempt:
            return
        if self._attempts_this_cycle >= self.config.max_attempts:
            # Throttled respawn (reference SummaryManager restarts the
            # summarizer after stopReason maxAttempts): a fresh cycle opens
            # after max_time_s — never give up for the container lifetime.
            last = self._attempt.submitted_at if self._attempt else self._last_attempt_time
            if self.config.clock() - last < self.config.max_time_s:
                return
            self._attempts_this_cycle = 0
        elapsed = self.config.clock() - self._last_summary_time
        if ops_since >= self.config.max_ops or elapsed >= self.config.max_time_s:
            self._submit()

    def _submit(self) -> None:
        handle = self._container.submit_summary()
        self._attempt = SummaryAttempt(
            handle=handle,
            head=self._container.ref_seq,
            submitted_at=self.config.clock(),
        )
        self._last_attempt_time = self._attempt.submitted_at
        self._attempts_this_cycle += 1
        self.summaries_submitted += 1
