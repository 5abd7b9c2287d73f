"""PactMap — key/value with unanimous-consent set semantics.

Reference: ``packages/dds/pact-map`` (``pactMap.ts``): a set is *pending*
until every client that was connected when the set was sequenced has
accepted it. Replicas auto-submit accepts when they process a remote pending
set; departure of a yet-to-accept client also counts as consent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


@dataclass
class _PendingPact:
    value: Any
    seq: int
    awaiting: Set[int] = field(default_factory=set)


class PactMap(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._committed: Dict[str, Any] = {}
        self._pending: Dict[str, _PendingPact] = {}

    # -- reads ----------------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        """The committed value (pending pacts are not readable yet)."""
        return self._committed.get(key, default)

    def get_pending(self, key: str, default: Any = None) -> Any:
        p = self._pending.get(key)
        return p.value if p is not None else default

    # -- ops ------------------------------------------------------------------

    def set(self, key: str, value: Any) -> None:
        """Propose a pact; commits once all connected clients accept."""
        self.submit_local_message({"k": "set", "key": key, "val": value})

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        c = msg.contents
        key = c["key"]
        if c["k"] == "set":
            if key in self._pending:
                return  # a pact is already in flight; later sets are dropped
            members = set(self._runtime.quorum_members.keys())
            members.discard(msg.client_id)  # proposer implicitly accepts
            pact = _PendingPact(c["val"], msg.sequence_number, members)
            self._pending[key] = pact
            if not local and self.client_id in pact.awaiting:
                self.submit_local_message({"k": "accept", "key": key})
            self._maybe_commit(key)
        elif c["k"] == "accept":
            pact = self._pending.get(key)
            if pact is not None:
                pact.awaiting.discard(msg.client_id)
                self._maybe_commit(key)

    def on_client_leave(self, client_id: int) -> None:
        for key, pact in list(self._pending.items()):
            pact.awaiting.discard(client_id)
            self._maybe_commit(key)

    def _maybe_commit(self, key: str) -> None:
        pact = self._pending.get(key)
        if pact is not None and not pact.awaiting:
            self._committed[key] = pact.value
            del self._pending[key]

    def summarize_core(self) -> dict:
        return {
            "committed": dict(self._committed),
            "pending": {
                k: {"value": p.value, "seq": p.seq, "awaiting": sorted(p.awaiting)}
                for k, p in self._pending.items()
            },
        }

    def load_core(self, summary: dict) -> None:
        self._committed = dict(summary["committed"])
        self._pending = {
            k: _PendingPact(d["value"], d["seq"], set(d["awaiting"]))
            for k, d in summary["pending"].items()
        }
