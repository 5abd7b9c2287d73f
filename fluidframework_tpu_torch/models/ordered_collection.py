"""ConsensusOrderedCollection — a consensus queue with acquire/complete/release.

Reference: ``packages/dds/ordered-collection``
(``consensusOrderedCollection.ts``): add/acquire take effect only when
sequenced. ``acquire`` hands the front item to exactly one client (the
acquirer named in the sequenced op); the item stays "in flight" until
``complete`` (permanently removed) or ``release`` (returned to the front),
and is auto-released if the holder leaves the quorum.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import MessageType, SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


class ConsensusOrderedCollection(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._items: List[tuple] = []  # (item_id, value)
        self._in_flight: Dict[str, tuple] = {}  # item_id -> (value, client_id)
        self._acquired_here: Dict[str, Any] = {}

    # -- reads ----------------------------------------------------------------

    def size(self) -> int:
        return len(self._items)

    def peek(self, default: Any = None) -> Any:
        return self._items[0][1] if self._items else default

    def acquired(self) -> Dict[str, Any]:
        """Items this client currently holds (item_id -> value)."""
        return dict(self._acquired_here)

    # -- ops ------------------------------------------------------------------

    def add(self, value: Any) -> None:
        self.submit_local_message(
            {"k": "add", "id": uuid.uuid4().hex[:16], "val": value}
        )

    def acquire(self) -> None:
        """Request the front item; grant arrives via the sequenced op."""
        self.submit_local_message({"k": "acquire"})

    def complete(self, item_id: str) -> None:
        assert item_id in self._acquired_here, "complete() of unheld item"
        self.submit_local_message({"k": "complete", "id": item_id})

    def release(self, item_id: str) -> None:
        assert item_id in self._acquired_here, "release() of unheld item"
        self.submit_local_message({"k": "release", "id": item_id})

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        c = msg.contents
        if c["k"] == "add":
            self._items.append((c["id"], c["val"]))
        elif c["k"] == "acquire":
            if self._items:
                item_id, value = self._items.pop(0)
                self._in_flight[item_id] = (value, msg.client_id)
                if local:
                    self._acquired_here[item_id] = value
        elif c["k"] == "complete":
            self._in_flight.pop(c["id"], None)
            if local:
                self._acquired_here.pop(c["id"], None)
        elif c["k"] == "release":
            entry = self._in_flight.pop(c["id"], None)
            if entry is not None:
                self._items.insert(0, (c["id"], entry[0]))
            if local:
                self._acquired_here.pop(c["id"], None)

    def on_client_leave(self, client_id: int) -> None:
        """Auto-release items held by a departed client (runtime hook)."""
        for item_id, (value, holder) in list(self._in_flight.items()):
            if holder == client_id:
                del self._in_flight[item_id]
                self._items.insert(0, (item_id, value))

    def summarize_core(self) -> dict:
        return {
            "items": [[i, v] for i, v in self._items],
            "in_flight": {k: [v, c] for k, (v, c) in self._in_flight.items()},
        }

    def load_core(self, summary: dict) -> None:
        self._items = [(i, v) for i, v in summary["items"]]
        self._in_flight = {k: (v, c) for k, (v, c) in summary["in_flight"].items()}
