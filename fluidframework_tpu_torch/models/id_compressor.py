"""IdCompressor — distributed UUID ⇄ small-int id compression.

Reference: ``packages/dds/tree/src/id-compressor`` (``IdCompressor``
idCompressor.ts:272): every session (client) can mint ids with no
coordination — locally they are negative ints, usable immediately — and
the sequenced op stream *finalizes* them into dense non-negative final
ids allocated in per-session **clusters** (contiguous blocks, default
capacity 512). Because a session's next finalization usually lands inside
its already-reserved cluster, the common case allocates no new range, and
final ids stay dense enough to index device-side arrays directly — the
property the survey calls out as "needed for batched/vectorized ids"
(SURVEY.md §2.2 id-compressor).

Deterministic merge: cluster allocation is a pure fold over the sequenced
ops, so every replica computes the identical uuid⇄int tables.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject

DEFAULT_CLUSTER_CAPACITY = 512


@dataclass
class _Cluster:
    session: str
    base_final: int  # first final id of the block
    base_index: int  # session-local index of the block's first id
    capacity: int
    used: int = 0


class IdCompressor(SharedObject):
    """Session-local id minting with sequenced cluster finalization."""

    def __init__(
        self,
        channel_id: str,
        cluster_capacity: int = DEFAULT_CLUSTER_CAPACITY,
        session_id: Optional[str] = None,
    ):
        super().__init__(channel_id)
        self.cluster_capacity = cluster_capacity
        self.session_id = session_id or _uuid.uuid4().hex
        # locals: -1, -2, ... in mint order; -(k+1) is session index k.
        self._local_count = 0
        self._unsubmitted = 0
        # Shared (sequenced) state — identical on every replica:
        self._next_final = 0
        self._clusters: List[_Cluster] = []
        self._session_clusters: Dict[str, List[_Cluster]] = {}
        self._finalized_count: Dict[str, int] = {}  # session -> #finalized

    # -- minting ---------------------------------------------------------------

    def generate_id(self) -> int:
        """Mint one id, usable immediately in this session (negative)."""
        self._local_count += 1
        self._unsubmitted += 1
        return -self._local_count

    def generate_ids(self, n: int) -> List[int]:
        return [self.generate_id() for _ in range(n)]

    def take_id_range(self) -> None:
        """Submit the unsubmitted locals for finalization (the reference
        attaches this range to the next outbox flush — the idAllocation
        lane). No-op when nothing is pending."""
        if self._unsubmitted:
            n, self._unsubmitted = self._unsubmitted, 0
            self.submit_local_message({"uuid": self.session_id, "n": n})

    # -- queries ---------------------------------------------------------------

    def normalize_to_final(self, local_id: int) -> Optional[int]:
        """Final id for one of this session's locals, or None if the range
        containing it has not been finalized yet."""
        assert local_id < 0, "locals are negative"
        index = -local_id - 1
        if index >= self._finalized_count.get(self.session_id, 0):
            return None
        return self._final_of(self.session_id, index)

    def decompress(self, final_id: int) -> Tuple[str, int]:
        """(session uuid, session-local index) of a final id."""
        for cl in self._clusters:
            if cl.base_final <= final_id < cl.base_final + cl.used:
                return (cl.session, cl.base_index + (final_id - cl.base_final))
        raise KeyError(final_id)

    def recompress(self, session: str, index: int) -> int:
        final = self._final_of(session, index)
        if final is None or index >= self._finalized_count.get(session, 0):
            raise KeyError((session, index))
        return final

    @property
    def finalized_total(self) -> int:
        return self._next_final - sum(
            cl.capacity - cl.used for cl in self._clusters
        )

    def _final_of(self, session: str, index: int) -> Optional[int]:
        for cl in self._session_clusters.get(session, ()):
            if cl.base_index <= index < cl.base_index + cl.capacity:
                return cl.base_final + (index - cl.base_index)
        return None

    # -- sequenced stream (finalization fold) ----------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        c = msg.contents
        self._finalize(c["uuid"], c["n"])

    def _finalize(self, session: str, n: int) -> None:
        """Allocate final ids for the session's next n local indexes:
        fill its newest cluster's spare capacity first, then reserve a new
        cluster of max(remaining, cluster_capacity) at the end of the
        final-id space (idCompressor.ts cluster expansion)."""
        chain = self._session_clusters.setdefault(session, [])
        self._finalized_count[session] = self._finalized_count.get(session, 0) + n
        while n > 0:
            if chain and chain[-1].used < chain[-1].capacity:
                take = min(n, chain[-1].capacity - chain[-1].used)
                chain[-1].used += take
                n -= take
                continue
            cap = max(n, self.cluster_capacity)
            next_index = (
                chain[-1].base_index + chain[-1].capacity if chain else 0
            )
            cl = _Cluster(
                session=session,
                base_final=self._next_final,
                base_index=next_index,
                capacity=cap,
            )
            self._next_final += cap
            self._clusters.append(cl)
            chain.append(cl)

    # -- resubmit / summary ----------------------------------------------------

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        self.submit_local_message(contents, local_metadata)

    def summarize_core(self) -> dict:
        return {
            "next_final": self._next_final,
            "clusters": [
                {
                    "session": cl.session,
                    "base_final": cl.base_final,
                    "base_index": cl.base_index,
                    "capacity": cl.capacity,
                    "used": cl.used,
                }
                for cl in self._clusters
            ],
            "finalized": dict(self._finalized_count),
        }

    def load_core(self, summary: dict) -> None:
        self._next_final = summary["next_final"]
        self._clusters = [_Cluster(**ent) for ent in summary["clusters"]]
        self._session_clusters = {}
        for cl in self._clusters:
            self._session_clusters.setdefault(cl.session, []).append(cl)
        self._finalized_count = dict(summary["finalized"])
