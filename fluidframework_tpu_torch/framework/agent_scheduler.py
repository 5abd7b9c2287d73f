"""AgentScheduler — distributed singleton task election.

Reference: ``packages/framework/agent-scheduler`` — clients ``pick`` tasks;
exactly one connected client holds each task at a time; when the holder
leaves the quorum the task is re-elected among remaining volunteers. The
reference builds this on consensus registers; here claim ops go through
the same sequenced stream, so "first claim sequenced wins" is exactly the
total order doing the election.

A copy of ``fluidframework_tpu/framework/agent_scheduler.py``
with the port's imports; host-only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject

UNCLAIMED = -1


class AgentScheduler(SharedObject):
    """Events: ``picked(task_id)`` when this client wins a task,
    ``lost(task_id)`` when it loses/releases one."""

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._holders: Dict[str, int] = {}  # task -> client_id (or absent)
        self._wanted: Set[str] = set()  # tasks this client volunteers for

    # -- queries -----------------------------------------------------------

    def holder_of(self, task_id: str) -> int:
        return self._holders.get(task_id, UNCLAIMED)

    def picked_tasks(self) -> Set[str]:
        return {
            t for t, holder in self._holders.items() if holder == self.client_id
        }

    # -- volunteering ------------------------------------------------------

    def pick(self, task_id: str) -> None:
        """Volunteer for a task. If it is currently unclaimed, submit a
        claim; either way, stay a candidate for future re-election."""
        self._wanted.add(task_id)
        if self.holder_of(task_id) == UNCLAIMED:
            self.submit_local_message({"k": "claim", "task": task_id})

    def release(self, task_id: str) -> None:
        """Stop volunteering; if currently held, give the task up."""
        self._wanted.discard(task_id)
        if self.holder_of(task_id) == self.client_id:
            self.submit_local_message({"k": "release", "task": task_id})

    # -- sequenced stream --------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        c = msg.contents
        task = c["task"]
        if c["k"] == "claim":
            # First sequenced claim on an unclaimed task wins; later
            # concurrent claims are no-ops (their senders stay candidates).
            if self._holders.get(task, UNCLAIMED) == UNCLAIMED:
                self._holders[task] = msg.client_id
                if msg.client_id == self.client_id:
                    self.emit("picked", task)
        elif c["k"] == "release":
            if self._holders.get(task) == msg.client_id:
                self._holders[task] = UNCLAIMED
                if msg.client_id == self.client_id:
                    self.emit("lost", task)
                self._revolunteer(task)

    def on_client_leave(self, client_id: int) -> None:
        """Sequenced CLIENT_LEAVE: release every task the departed client
        held — deterministic on all replicas — then re-volunteer."""
        for task, holder in list(self._holders.items()):
            if holder == client_id:
                self._holders[task] = UNCLAIMED
                self._revolunteer(task)

    def _revolunteer(self, task: str) -> None:
        if task in self._wanted and self._runtime is not None and (
            getattr(self._runtime, "connected", True)
        ):
            self.submit_local_message({"k": "claim", "task": task})

    # -- summary -----------------------------------------------------------

    def summarize_core(self) -> dict:
        return {"holders": dict(self._holders)}

    def load_core(self, summary: dict) -> None:
        self._holders = dict(summary["holders"])
