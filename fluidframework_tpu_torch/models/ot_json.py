"""SharedOTJson — an OT-merged JSON DDS (the experimental/dds/ot family).

Reference: ``experimental/dds/ot`` wraps sharejs/json-ot types: local ops
apply immediately and REMOTE concurrent ops are transformed against the
locally-pending ones (and vice versa on ack) — classic OT, a different
merge discipline from the CRDT/rebase DDSes, included for parity with the
reference's OT family.

Op forms (json0 subset), each addressed by a ``p`` path of object keys /
list indices:

- ``{"p": path, "oi": v}`` object insert/replace; ``{"od": 1}`` delete
- ``{"p": path, "li": v}`` list insert; ``{"ld": 1}`` list delete
- ``{"p": path, "na": n}`` number add (commutative)

Transform rules shift list indices for concurrent list edits and drop ops
whose subtree a concurrent op deleted; object replace conflicts resolve
server-order-wins (the sequenced-earlier op loses to the later one on
replay, since each replica applies sequenced order).
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Tuple

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject

Path = Tuple


def _get(doc, path):
    for k in path:
        doc = doc[k]
    return doc


def apply_op(doc: Any, op: dict) -> Any:
    """Apply one op to a plain JSON doc (mutates and returns it)."""
    p = tuple(op["p"])
    parent = _get(doc, p[:-1]) if p else doc
    key = p[-1] if p else None
    if "na" in op:
        parent[key] = (parent.get(key, 0) if isinstance(parent, dict) else parent[key]) + op["na"]
    elif "li" in op:
        parent.insert(key, copy.deepcopy(op["li"]))
    elif "ld" in op:
        del parent[key]
    elif "oi" in op:
        parent[key] = copy.deepcopy(op["oi"])
    elif "od" in op:
        parent.pop(key, None)
    return doc


def _is_prefix(a: Path, b: Path) -> bool:
    return len(a) <= len(b) and tuple(b[: len(a)]) == tuple(a)


def transform(op: dict, against: dict, op_is_later: bool = False) -> Optional[dict]:
    """Transform ``op`` so it applies AFTER ``against``. Returns None when
    the op's target no longer exists. ``op_is_later``: whether ``op`` holds
    the later position in the total order — it breaks same-point
    insert-insert ties (the later-sequenced insert stays at the index and
    lands in front, matching the kernel's breakTie ordering)."""
    op = {**op, "p": list(op["p"])}
    ap = tuple(against["p"])
    p = tuple(op["p"])

    # Object-key replace/delete in `against`.
    if "oi" in against or "od" in against:
        if len(p) > len(ap) and _is_prefix(ap, p):
            # Edits inside a replaced/deleted subtree die regardless of
            # order (json0 semantics: the subtree was swapped wholesale).
            return None
        if p == ap and ("oi" in op or "od" in op or "na" in op):
            # Same-key write conflict: strict LWW — the later op in the
            # total order survives, the earlier one drops.
            return op if op_is_later else None
    # A list-element delete kills edits inside that element; same-index
    # list ops resolve via the index rules below.
    if "ld" in against and len(p) > len(ap) and _is_prefix(ap, p):
        return None
    # List index shifting at the shared parent.
    if len(ap) and len(p) >= len(ap) and tuple(p[: len(ap) - 1]) == tuple(ap[:-1]):
        depth = len(ap) - 1
        if isinstance(ap[-1], int) and isinstance(p[depth], int):
            ai, pi = ap[-1], p[depth]
            if "li" in against:
                same_point_insert = "li" in op and len(p) == len(ap)
                if pi > ai or (
                    pi == ai and not (same_point_insert and op_is_later)
                ):
                    op["p"][depth] = pi + 1
            elif "ld" in against:
                if pi > ai:
                    op["p"][depth] = pi - 1
                elif pi == ai and len(p) == len(ap) and "ld" in op:
                    return None  # both deleted the same element
    return op


class SharedOTJson(SharedObject):
    """OT-merged JSON document."""

    def __init__(self, channel_id: str, initial=None):
        super().__init__(channel_id)
        self._doc = initial if initial is not None else {}
        # Outgoing batches: [0] is the single in-flight batch (Jupiter
        # constraint — one op in flight keeps every wire op's context equal
        # to its refSeq state, which is what makes client-side bridging
        # sound); the rest wait locally and submit on ack.
        self._pending: List[List[dict]] = []
        self._in_flight = False
        # Canonical history window: (seq, applied-form ops) for every
        # sequenced batch still above the MSN. An incoming op whose author
        # had not seen seqs (ref, seq) bridges over those canonical forms —
        # the client-side half of total-order OT (the reference's sharejs
        # server does this transformation server-side).
        self._history: List[Tuple[int, List[dict]]] = []

    # -- reads ----------------------------------------------------------------

    def get(self, *path):
        try:
            return copy.deepcopy(_get(self._doc, path))
        except (KeyError, IndexError, TypeError):
            return None

    def as_data(self):
        return copy.deepcopy(self._doc)

    # -- local edits -----------------------------------------------------------

    def submit_ops(self, ops: List[dict]) -> None:
        for op in ops:
            apply_op(self._doc, op)
        self._pending.append([copy.deepcopy(o) for o in ops])
        if not self._in_flight:
            self._send_head()

    def _send_head(self) -> None:
        self._in_flight = True
        self.submit_local_message(
            {"ops": [dict(o) for o in self._pending[0]]}
        )

    def set_key(self, path, value) -> None:
        self.submit_ops([{"p": list(path), "oi": value}])

    def delete_key(self, path) -> None:
        self.submit_ops([{"p": list(path), "od": 1}])

    def list_insert(self, path, index, value) -> None:
        self.submit_ops([{"p": list(path) + [index], "li": value}])

    def list_delete(self, path, index) -> None:
        self.submit_ops([{"p": list(path) + [index], "ld": 1}])

    def number_add(self, path, delta) -> None:
        self.submit_ops([{"p": list(path), "na": delta}])

    # -- sequenced stream ------------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        if local:
            # Our in-flight batch, kept transformed over everything
            # sequenced since submit, IS the canonical applied form —
            # record it, retire it, and release the next queued batch
            # (whose context is now exactly the current ref state).
            if self._pending:
                batch = self._pending.pop(0)
                self._history.append((msg.sequence_number, batch))
            self._in_flight = False
            if self._pending:
                self._send_head()
            self._prune_history(msg.minimum_sequence_number)
            return
        # 1) Bridge over the canonical forms the author had not seen.
        remote = [dict(o) for o in msg.contents["ops"]]
        for seq, hist in self._history:
            if seq <= msg.reference_sequence_number:
                continue
            surv = []
            for r in remote:
                for h in hist:
                    r = transform(r, h, op_is_later=True)  # r sequences later
                    if r is None:
                        break
                if r is not None:
                    surv.append(r)
            remote = surv
        self._history.append((msg.sequence_number, [dict(o) for o in remote]))
        self._prune_history(msg.minimum_sequence_number)
        # 2) The pairwise transformX sweep against pending local batches:
        # both sides progress op-by-op, so later ops always transform
        # against already-transformed counterparts.
        new_pending: List[List[dict]] = []
        for batch in self._pending:
            new_remote: List[dict] = []
            for r in remote:
                cur = r
                updated_batch: List[dict] = []
                for mine in batch:
                    if cur is None:
                        updated_batch.append(mine)
                        continue
                    nxt = transform(cur, mine, op_is_later=False)
                    mine2 = transform(mine, cur, op_is_later=True)
                    cur = nxt
                    if mine2 is not None:
                        updated_batch.append(mine2)
                batch = updated_batch
                if cur is not None:
                    new_remote.append(cur)
            remote = new_remote
            new_pending.append(batch)
        self._pending = new_pending
        for op in remote:
            try:
                apply_op(self._doc, op)
            except (KeyError, IndexError, TypeError):
                pass  # op's target vanished (transformed-away edge)

    def _prune_history(self, min_seq: int) -> None:
        self._history = [(s, ops) for s, ops in self._history if s > min_seq]

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        """Reconnect/nack: only the head batch was ever on the wire (one in
        flight); re-send its kept-transformed form — its context is the
        post-catch-up ref state, exactly what bridging assumes."""
        if self._pending:
            self._in_flight = True
            self.submit_local_message(
                {"ops": [dict(o) for o in self._pending[0]]}
            )
        else:
            self._in_flight = False

    # -- summary ---------------------------------------------------------------

    def summarize_core(self) -> dict:
        assert not self._pending
        return {"doc": copy.deepcopy(self._doc)}

    def load_core(self, summary: dict) -> None:
        self._doc = copy.deepcopy(summary["doc"])
        self._pending = []
