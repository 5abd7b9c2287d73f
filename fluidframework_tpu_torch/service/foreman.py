"""Foreman — service-side task assignment lambda.

Reference: ``server/routerlicious/packages/lambdas/src/foreman/lambda.ts:20``
— a consumer on the sequenced stream that farms service tasks (snapshot,
intel, translation) out to connected clients and re-farms them when the
assignee disconnects. The client side (volunteering, election among
volunteers) already exists as ``framework/agent_scheduler.py`` +
``models/task_manager.py``; this stage is the PUSH half: the service
decides which client should run each configured task and tells it via a
signal (the reference's queued help message).

Exactly-once effect under at-least-once replay: assignments are a pure
function of the sequenced join/leave stream (assignee = live write-mode
client with the smallest join seq), and every assignment signal carries
its ``basis`` — the sequenced message that caused it — plus a per-task
group key. Deli keeps a checkpointed monotone basis floor per group and
drops re-emissions at or below it, so a foreman that crashes and replays
its input never delivers a duplicate or stale assignment signal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.protocol.types import MessageType
from fluidframework_tpu_torch.service.lambdas import RAW_TOPIC, PartitionLambda

DEFAULT_TASKS = ("summarizer",)


class ForemanDocLambda(PartitionLambda):
    """Per-document foreman (demuxed by DocumentLambda on ``deltas``)."""

    def __init__(
        self,
        doc_id: str,
        state: Optional[dict] = None,
        tasks: Tuple[str, ...] = DEFAULT_TASKS,
    ):
        self.doc_id = doc_id
        self.tasks = tuple(tasks)
        # client_id -> join seq (write-mode members only).
        self.members: Dict[int, int] = (
            {int(k): v for k, v in state["members"].items()} if state else {}
        )
        self.assignments: Dict[str, int] = (
            dict(state["assignments"]) if state else {}
        )

    def state(self) -> dict:
        return {
            "members": dict(self.members),
            "assignments": dict(self.assignments),
        }

    def handler(self, key: str, value: dict) -> List[Tuple[str, str, Any]]:
        if value["t"] != "seq":
            return []
        msg = value["msg"]
        if msg.type == MessageType.CLIENT_JOIN:
            detail = msg.contents
            if detail.get("mode", "write") == "write":
                self.members[detail["clientId"]] = msg.sequence_number
            return self._reassign(key, msg.sequence_number)
        if msg.type == MessageType.CLIENT_LEAVE:
            self.members.pop(msg.contents, None)
            return self._reassign(key, msg.sequence_number)
        return []

    def _reassign(
        self, key: str, basis: int
    ) -> List[Tuple[str, str, Any]]:
        """Re-derive assignments; emit a signal per change (routed through
        deli via the raw topic so signal numbering stays deterministic)."""
        out: List[Tuple[str, str, Any]] = []
        # Oldest connected write client: smallest join seq (slot numbers
        # recycle; join order does not).
        candidate = min(
            self.members, key=lambda c: self.members[c], default=None
        )
        for task in self.tasks:
            holder = self.assignments.get(task)
            if holder is not None and holder in self.members:
                continue  # assignee still connected
            if candidate is None:
                if holder is not None:
                    del self.assignments[task]
                continue
            self.assignments[task] = candidate
            out.append(
                (
                    RAW_TOPIC,
                    key,
                    {
                        "t": "signal",
                        "client": -1,  # service-originated
                        "group": f"foreman:{task}",
                        "basis": basis,  # deli's exactly-once floor
                        "content": {
                            "foreman": task,
                            "assignee": candidate,
                        },
                    },
                )
            )
        return out
