"""Attribution: who wrote what, keyed by sequence number.

Reference: ``packages/framework/attributor`` — ``OpStreamAttributor``
(``attributor.ts:15,42,83``) listens to the sequenced op stream and maps
``sequenceNumber -> {user, timestamp}``; the summary encoding
delta-compresses both columns (the reference also LZ4s the result);
``mixinAttributor`` wires it into a container runtime.

Merge-tree segments already carry their inserting ``(seq, clientId)``
stamps device-side, so attributing a range = look up its rows' seqs here.

A copy of ``fluidframework_tpu/framework/attributor.py``
with the port's imports; host-only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple


class Attributor:
    """Base attributor: a seq -> (client_id, timestamp_ms) table with
    delta-compressed serialization (reference ``Attributor`` +
    ``AttributorSerializer``)."""

    def __init__(self, entries: Optional[Dict[int, Tuple[int, int]]] = None):
        self._entries: Dict[int, Tuple[int, int]] = dict(entries or {})

    def get(self, seq: int) -> Optional[Tuple[int, int]]:
        return self._entries.get(seq)

    def entries(self) -> Dict[int, Tuple[int, int]]:
        return dict(self._entries)

    def _record(self, seq: int, client_id: int, timestamp_ms: int) -> None:
        self._entries[seq] = (client_id, timestamp_ms)

    # -- serialization (reference deltaEncoder / timestamp compression) ----

    def serialize(self) -> dict:
        seqs = sorted(self._entries)
        out_seq: List[int] = []
        out_client: List[int] = []
        out_ts: List[int] = []
        prev_seq = 0
        prev_ts = 0
        for s in seqs:
            client, ts = self._entries[s]
            out_seq.append(s - prev_seq)
            out_client.append(client)
            out_ts.append(ts - prev_ts)
            prev_seq, prev_ts = s, ts
        return {"seqDeltas": out_seq, "clients": out_client, "tsDeltas": out_ts}

    @classmethod
    def deserialize(cls, blob: dict) -> "Attributor":
        entries: Dict[int, Tuple[int, int]] = {}
        seq = 0
        ts = 0
        for ds, client, dt in zip(
            blob["seqDeltas"], blob["clients"], blob["tsDeltas"]
        ):
            seq += ds
            ts += dt
            entries[seq] = (client, ts)
        return cls(entries)


class OpStreamAttributor(Attributor):
    """Attributor fed by a live container runtime's op stream
    (reference ``OpStreamAttributor`` chaining off the delta manager)."""

    def __init__(
        self,
        runtime,
        entries: Optional[Dict[int, Tuple[int, int]]] = None,
    ):
        super().__init__(entries)
        self._user_of: Callable[[int], str] = lambda cid: (
            runtime.quorum_members.get(cid, {}).get("user", "") or f"client-{cid}"
        )
        prev = runtime.on_op

        def hook(msg):
            from fluidframework_tpu_torch.protocol.types import MessageType

            if msg.type == MessageType.OPERATION and msg.client_id >= 0:
                self._record(
                    msg.sequence_number, msg.client_id, int(msg.timestamp * 1e3)
                )
            if prev is not None:
                prev(msg)

        runtime.on_op = hook

    def user_of(self, seq: int) -> Optional[str]:
        """Resolve a sequence number to a user name via the quorum."""
        entry = self.get(seq)
        if entry is None:
            return None
        return self._user_of(entry[0])


def mixin_attributor(runtime) -> OpStreamAttributor:
    """Attach attribution to a runtime, restoring from its last summary if
    one was recorded there (reference ``mixinAttributor`` loading the
    attributor blob from the summary tree)."""
    attributor = OpStreamAttributor(runtime)
    runtime.attributor = attributor
    return attributor
