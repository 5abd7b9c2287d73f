"""SharedMap — last-writer-wins key/value DDS.

Reference: ``packages/dds/map`` (``map.ts:395``, pending-ack conflict logic
in ``mapKernel.ts``): local sets apply optimistically and win over remote
sets on the same key until acked (the sequencer gives the local op a later
seq, so optimistic-local-wins equals last-writer-wins at final seqs).
Host-side state — map merge is O(1) bookkeeping, not kernel work. A copy of
``fluidframework_tpu/models/shared_map.py`` with the port's imports.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


class SharedMap(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._data: Dict[str, Any] = {}
        # key -> count of unacked local ops (reference mapKernel pending).
        self._pending: Dict[str, int] = {}

    # -- reads ----------------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def has(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __len__(self) -> int:
        return len(self._data)

    # -- local edits ----------------------------------------------------------

    def set(self, key: str, value: Any) -> None:
        prev = self._data.get(key)
        self._data[key] = value
        self._pending[key] = self._pending.get(key, 0) + 1
        self.submit_local_message({"k": "set", "key": key, "val": value})
        # valueChanged fires at the point of visible change — optimistically
        # for local edits (reference map.ts IValueChanged events).
        self.emit("valueChanged", {"key": key, "previousValue": prev}, True)

    def delete(self, key: str) -> None:
        existed = key in self._data
        prev = self._data.pop(key, None)
        self._pending[key] = self._pending.get(key, 0) + 1
        self.submit_local_message({"k": "del", "key": key})
        if existed:  # deleting an absent key changes nothing visible
            self.emit("valueChanged", {"key": key, "previousValue": prev}, True)

    def clear(self) -> None:
        self._data.clear()
        self._pending["\0clear"] = self._pending.get("\0clear", 0) + 1
        self.submit_local_message({"k": "clear"})
        self.emit("clear", True)

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        c = msg.contents
        if local:
            key = c.get("key", "\0clear")
            left = self._pending.get(key, 0) - 1
            if left <= 0:
                self._pending.pop(key, None)
            else:
                self._pending[key] = left
            return  # value already applied optimistically
        if c["k"] == "clear":
            # Remote clear wipes everything except keys with pending local
            # edits (their later-sequenced ops win).
            self._data = {
                k: v for k, v in self._data.items() if self._pending.get(k, 0) > 0
            }
            self.emit("clear", False)
            return
        key = c["key"]
        if self._pending.get("\0clear", 0) > 0:
            # A local clear is in flight: it will sequence after this op
            # and wipe the key, so applying it here would diverge from
            # replicas that see set-then-clear (reference mapKernel
            # pendingClearMessageId shadowing).
            return
        if self._pending.get(key, 0) > 0:
            return  # local pending op on this key wins until acked
        existed = key in self._data
        prev = self._data.get(key)
        if c["k"] == "set":
            self._data[key] = c["val"]
        elif c["k"] == "del":
            if not existed:
                return  # nothing visible changed
            self._data.pop(key, None)
        self.emit("valueChanged", {"key": key, "previousValue": prev}, False)

    # -- summary / load -------------------------------------------------------

    def summarize_core(self) -> dict:
        return {"data": dict(self._data)}

    def load_core(self, summary: dict) -> None:
        self._data = dict(summary["data"])
