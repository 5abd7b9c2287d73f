"""Replay driver — play a stored op stream as a read-only live connection.

Reference: ``packages/drivers/replay-driver`` (``replayController.ts``,
``replayDocumentService.ts``): a container attaches to a canned op log
and receives it as if live, optionally stopping at a chosen sequence
number and stepping forward — the perf/debug baseline harness (config 1
of ``bench_configs.py`` replays a single document's log this way). A copy
of ``fluidframework_tpu/drivers/replay_driver.py`` with the port's imports.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from fluidframework_tpu_torch.protocol.types import (
    DocumentMessage,
    NackMessage,
    SequencedDocumentMessage,
    SignalMessage,
)
from fluidframework_tpu_torch.service.summary_store import SummaryStore

READONLY_CLIENT = -2  # synthetic id: never matches a sequenced op's author


class ReplayConnection:
    """Read-only connection surface (submits are dropped, as the reference
    replay connection does for its read-only delta connection)."""

    def __init__(self, owner: "ReplayDocumentService", from_seq: int):
        self._owner = owner
        self.doc_id = owner.doc_id
        self.client_id = READONLY_CLIENT
        self.inbox: List[SequencedDocumentMessage] = []
        self.signals: List[SignalMessage] = []
        self.nacks: List[NackMessage] = []
        self.on_nack: Optional[Callable] = None
        self.initial_summary = owner.initial_summary if from_seq == 0 else None
        self._cursor = from_seq
        if self.initial_summary is not None:
            self._cursor = max(self._cursor, self.initial_summary[1])

    def submit(self, msg: DocumentMessage) -> None:
        pass  # read-only: local noops/ops never reach a sequencer

    def submit_signal(self, content) -> None:
        pass

    def take_inbox(self, n: Optional[int] = None) -> List[SequencedDocumentMessage]:
        self._fill()
        n = len(self.inbox) if n is None else min(n, len(self.inbox))
        out, self.inbox[:] = self.inbox[:n], self.inbox[n:]
        return out

    def _fill(self) -> None:
        limit = self._owner.replay_head
        for m in self._owner.ops:
            if self._cursor < m.sequence_number <= limit:
                self.inbox.append(m)
                self._cursor = m.sequence_number

    def disconnect(self) -> None:
        pass


class ReplayDocumentService:
    """Serves one document's canned log (ReplayController semantics:
    ``replay_to`` gates how far connections may read — start at 0 and step
    to inspect intermediate states, or leave at the default head)."""

    def __init__(
        self,
        ops: List[SequencedDocumentMessage],
        doc_id: str = "replay",
        initial_summary: Optional[tuple] = None,
        store: Optional[SummaryStore] = None,
        replay_to: Optional[int] = None,
    ):
        self.ops = sorted(ops, key=lambda m: m.sequence_number)
        self.doc_id = doc_id
        self.initial_summary = initial_summary
        self.store = store or SummaryStore()
        self.replay_head = (
            replay_to
            if replay_to is not None
            else (self.ops[-1].sequence_number if self.ops else 0)
        )

    # -- controller ------------------------------------------------------------

    def replay_to(self, seq: int) -> None:
        assert seq >= self.replay_head, "replay never rewinds"
        self.replay_head = seq

    def replay_all(self) -> None:
        if self.ops:
            self.replay_head = self.ops[-1].sequence_number

    # -- the service surface ContainerRuntime consumes -------------------------

    def connect(self, doc_id: str, mode: str = "read", from_seq: int = 0):
        assert doc_id == self.doc_id
        return ReplayConnection(self, from_seq)

    def get_deltas(
        self, doc_id: str, from_seq: int = 0, to_seq: Optional[int] = None
    ) -> List[SequencedDocumentMessage]:
        return [
            m
            for m in self.ops
            if m.sequence_number > from_seq
            and (to_seq is None or m.sequence_number <= to_seq)
        ]
