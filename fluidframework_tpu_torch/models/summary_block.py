"""SharedSummaryBlock — summary-only data, no op traffic.

Reference: ``packages/dds/shared-summary-block``: values set locally are
never sent as ops; they are only communicated through the summary. Used
for data the summarizer computes (e.g. search indexes) where per-op
replication would be waste — replicas see it on next load-from-summary.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


class SharedSummaryBlock(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._data: Dict[str, Any] = {}

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def set(self, key: str, value: Any) -> None:
        """Local-only write; rides the next summary (no op submitted)."""
        self._data[key] = value

    def keys(self):
        return self._data.keys()

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:  # pragma: no cover - the DDS never submits ops
        raise AssertionError("SharedSummaryBlock receives no ops")

    def summarize_core(self) -> dict:
        return {"data": dict(self._data)}

    def load_core(self, summary: dict) -> None:
        self._data = dict(summary["data"])
