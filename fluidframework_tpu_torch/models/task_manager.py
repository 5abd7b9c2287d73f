"""TaskManager — distributed task queue/lock.

Reference: ``packages/dds/task-manager`` (``taskManager.ts``): clients
volunteer for a named task; the sequenced volunteer order forms a queue and
the front of the queue holds the task. Abandon or client departure passes
the task to the next in queue.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


class TaskManager(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._queues: Dict[str, List[int]] = {}  # task -> client queue

    # -- reads ----------------------------------------------------------------

    def assigned_to(self, task: str) -> Optional[int]:
        q = self._queues.get(task)
        return q[0] if q else None

    def assigned(self, task: str) -> bool:
        return self.assigned_to(task) == self.client_id

    def queued(self, task: str) -> bool:
        return self.client_id in self._queues.get(task, [])

    # -- ops ------------------------------------------------------------------

    def volunteer(self, task: str) -> None:
        if self.queued(task):
            return
        self.submit_local_message({"k": "vol", "task": task})

    def abandon(self, task: str) -> None:
        if not self.queued(task):
            return
        self.submit_local_message({"k": "abandon", "task": task})

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        c = msg.contents
        q = self._queues.setdefault(c["task"], [])
        if c["k"] == "vol":
            if msg.client_id not in q:
                q.append(msg.client_id)
        elif c["k"] == "abandon":
            if msg.client_id in q:
                q.remove(msg.client_id)

    def on_client_leave(self, client_id: int) -> None:
        for q in self._queues.values():
            if client_id in q:
                q.remove(client_id)

    def summarize_core(self) -> dict:
        # Queue membership is connection-scoped; summaries persist nothing
        # (matches the reference: task assignment does not survive sessions).
        return {}

    def load_core(self, summary: dict) -> None:
        self._queues = {}
