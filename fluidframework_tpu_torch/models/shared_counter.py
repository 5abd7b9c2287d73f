"""SharedCounter — commutative increments (reference ``packages/dds/counter``).

Increments commute, so every replica just sums the sequenced deltas; the
local echo applies optimistically and the ack is a no-op.
"""

from __future__ import annotations

from typing import Any, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


class SharedCounter(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def increment(self, delta: int = 1) -> None:
        assert isinstance(delta, int), "counter increments must be integral"
        self._value += delta
        self.submit_local_message({"d": delta})

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        if local:
            return  # already applied optimistically
        self._value += msg.contents["d"]

    def summarize_core(self) -> dict:
        return {"value": self._value}

    def load_core(self, summary: dict) -> None:
        self._value = summary["value"]
