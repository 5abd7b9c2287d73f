"""SharedCell — single LWW value (reference ``packages/dds/cell``)."""

from __future__ import annotations

from typing import Any, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject

_EMPTY = object()


class SharedCell(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._value: Any = _EMPTY
        self._pending = 0  # unacked local ops (local wins until acked)

    def get(self, default: Any = None) -> Any:
        return default if self._value is _EMPTY else self._value

    @property
    def empty(self) -> bool:
        return self._value is _EMPTY

    def set(self, value: Any) -> None:
        self._value = value
        self._pending += 1
        self.submit_local_message({"k": "set", "val": value})

    def delete(self) -> None:
        self._value = _EMPTY
        self._pending += 1
        self.submit_local_message({"k": "del"})

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        if local:
            self._pending -= 1
            return
        if self._pending > 0:
            return  # pending local op wins (sequenced later)
        self._value = msg.contents["val"] if msg.contents["k"] == "set" else _EMPTY

    def summarize_core(self) -> dict:
        return {"empty": self.empty, "value": None if self.empty else self._value}

    def load_core(self, summary: dict) -> None:
        self._value = _EMPTY if summary["empty"] else summary["value"]
