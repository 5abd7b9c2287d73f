"""ConsensusRegisterCollection — atomic versioned registers.

Reference: ``packages/dds/register-collection``
(``consensusRegisterCollection.ts``): writes take effect only when sequenced
(no optimistic local apply); concurrent writes are resolved by sequence
order, and each register keeps the set of concurrently-written versions
(writes whose refSeq predates the winning write's seq) until the window
passes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


@dataclass
class _Version:
    value: Any
    seq: int


class ConsensusRegisterCollection(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._registers: Dict[str, List[_Version]] = {}

    def read(self, key: str, default: Any = None) -> Any:
        """The committed (latest-sequenced) value."""
        versions = self._registers.get(key)
        return versions[-1].value if versions else default

    def read_versions(self, key: str) -> List[Any]:
        """All concurrent versions currently retained for the key."""
        return [v.value for v in self._registers.get(key, [])]

    def keys(self):
        return self._registers.keys()

    def write(self, key: str, value: Any) -> None:
        """Submit a write; it has NO local effect until sequenced."""
        self.submit_local_message({"key": key, "val": value})

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        key = msg.contents["key"]
        versions = self._registers.setdefault(key, [])
        # Versions whose write happened-before this one (their seq is at or
        # below the new write's refSeq) are superseded; concurrent ones stay.
        versions[:] = [
            v for v in versions if v.seq > msg.reference_sequence_number
        ]
        versions.append(_Version(msg.contents["val"], msg.sequence_number))

    def summarize_core(self) -> dict:
        return {
            "registers": {
                k: [[v.value, v.seq] for v in vs]
                for k, vs in self._registers.items()
            }
        }

    def load_core(self, summary: dict) -> None:
        self._registers = {
            k: [_Version(val, seq) for val, seq in vs]
            for k, vs in summary["registers"].items()
        }
