"""Interval collections + local references over the merge kernel.

Reference: ``packages/dds/sequence/src/intervalCollection.ts`` (``SequenceInterval``
:400) built on merge-tree local references (``localReference.ts:142``,
``referencePositions.ts:103``; slide rules ``mergeTree.ts:821,849,2033-2040``
— SURVEY.md A.9): named sets of ranges anchored to positions that survive
concurrent edits, with their own op stream and reconnect rebase.

TPU-native anchoring: the reference anchors a reference to a *segment object*
plus offset; here a :class:`LocalReference` anchors to a **character identity**
``(orig, k)`` — the content id the inserting client allocated plus the char's
offset within that original insert. Character identity is stable under every
split the kernel performs (splits only adjust ``off``/``length`` windows into
the same ``orig`` payload), so no pointer fixup is ever needed; resolution is
a scan over the struct-of-arrays mirror (prefix-sum of visible lengths — the
same math the device kernel uses for positions).

Slide-on-remove (reference ``SlideOnRemove``): when the anchor char's removal
is **acked**, the reference re-anchors eagerly — forward to the next visible
char, else backward to the nearest earlier one, else detached. Eager sliding
(same trigger point as the reference: after remote-remove application / local
remove ack) guarantees no reference anchors a row by the time zamboni-style
compaction reclaims it.

A copy of ``fluidframework_tpu/models/interval_collection.py`` with the
port's imports: it reads the string's host view (``SharedString._host_view``,
one copy of the packed state per read).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.ops.segment_state import removed_by_slot_host
from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)

DETACHED = -1  # resolved position of a reference with no surviving anchor

_END = (-1, -1)  # anchor sentinel: "end of document"


def _visible_len(h, i: int, *, ref_seq: Optional[int], client: int) -> int:
    """Visible length of row ``i`` (SURVEY.md A.2).

    ``ref_seq=None`` is the local perspective (anything applied and not
    removed in any way — the ``materialize`` view); otherwise the remote
    perspective ``(ref_seq, client)``.
    """
    if int(h.kind[i]) == KIND_FREE:
        return 0
    if ref_seq is None:
        return 0 if int(h.rseq[i]) != RSEQ_NONE else int(h.length[i])
    seq = int(h.seq[i])
    ins_ok = int(h.client[i]) == client or (seq != UNASSIGNED_SEQ and seq <= ref_seq)
    if not ins_ok:
        return 0
    rseq = int(h.rseq[i])
    by_client = client >= 0 and removed_by_slot_host(
        int(h.rbits[i]), int(h.rbits2[i]), int(h.rbits3[i]), client
    )
    removed = by_client or (
        rseq not in (RSEQ_NONE, UNASSIGNED_SEQ) and rseq <= ref_seq
    )
    return 0 if removed else int(h.length[i])


def anchor_from_pos(
    h, pos: int, *, ref_seq: Optional[int] = None, client: int = -1
) -> Tuple[int, int]:
    """Char anchor ``(orig, k)`` of the character at visible index ``pos``
    in the given perspective; the ``_END`` sentinel past the last char."""
    if pos < 0:
        pos = 0
    acc = 0
    for i in range(int(h.count)):
        v = _visible_len(h, i, ref_seq=ref_seq, client=client)
        if v and acc + v > pos:
            return (int(h.orig[i]), int(h.off[i]) + (pos - acc))
        acc += v
    return _END


def _anchor_row(h, anchor: Tuple[int, int]) -> Optional[int]:
    """Row currently covering the anchor char, or None (compacted away)."""
    o, k = anchor
    for i in range(int(h.count)):
        if int(h.kind[i]) == KIND_FREE or int(h.orig[i]) != o:
            continue
        off = int(h.off[i])
        if off <= k < off + int(h.length[i]):
            return i
    return None


@dataclass
class LocalReference:
    """A position anchored to a character; slides on acked remove.

    ``bias`` selects the slide direction preference: ``"fwd"`` (interval
    starts — reference ``_getSlideToSegment`` next-further-start first) or
    ``"bwd"`` (interval ends — nearest earlier char first).
    """

    anchor: Tuple[int, int]
    bias: str = "fwd"
    detached: bool = False

    def position(self, h) -> int:
        """Current local position (``DETACHED`` when no anchor survives)."""
        if self.detached:
            return DETACHED
        total = 0
        found: Optional[int] = None
        prefix = 0
        row = _anchor_row(h, self.anchor) if self.anchor != _END else None
        for i in range(int(h.count)):
            v = _visible_len(h, i, ref_seq=None, client=-1)
            if row is not None and i == row:
                prefix = total
                found = i
            total += v
        if self.anchor == _END:
            return total - 1 if self.bias == "bwd" and total else total
        if found is None:
            return DETACHED
        if _visible_len(h, found, ref_seq=None, client=-1):
            return prefix + (self.anchor[1] - int(h.off[found]))
        # Anchor char hidden by a not-yet-acked local remove: report the
        # would-be slide target without re-anchoring (the reference keeps
        # references in place until the remove is sequenced).
        if self.bias == "bwd":
            return prefix - 1 if prefix else (0 if total else DETACHED)
        return min(prefix, total - 1) if total else DETACHED

    def normalize(self, h) -> None:
        """Eager slide (A.9): if the anchor row's removal is acked, re-anchor
        to the nearest visible char (bias direction first), else detach."""
        if self.detached or self.anchor == _END:
            return
        row = _anchor_row(h, self.anchor)
        if row is None:
            self.detached = True
            return
        rseq = int(h.rseq[row])
        if rseq == RSEQ_NONE or rseq == UNASSIGNED_SEQ:
            return  # live, or only locally removed — not yet slid
        before: Optional[int] = None
        after: Optional[int] = None
        for i in range(int(h.count)):
            if not _visible_len(h, i, ref_seq=None, client=-1):
                continue
            if i < row:
                before = i
            elif i > row and after is None:
                after = i
        order = (after, before) if self.bias == "fwd" else (before, after)
        for tgt in order:
            if tgt is not None:
                # Nearest char in the target row: its first char when sliding
                # forward, its last char when sliding backward.
                k = int(h.off[tgt])
                if tgt == before:
                    k += int(h.length[tgt]) - 1
                self.anchor = (int(h.orig[tgt]), k)
                return
        self.detached = True


@dataclass
class Interval:
    """One named range: inclusive ``[start, end]`` char positions.

    The local-wins overlay is per field (reference intervalCollection
    pendingChange* maps): a pending local start move only shields *start*
    from remote changes — concurrent disjoint-field edits still merge.
    """

    id: str
    start: LocalReference
    end: LocalReference
    props: Dict[str, Any] = field(default_factory=dict)
    last_seq: int = 0  # seq of the last applied sequenced change (LWW)
    pending_start: int = 0  # unacked local start moves
    pending_end: int = 0  # unacked local end moves
    pending_props: Dict[str, int] = field(default_factory=dict)

    def ack_fields(self, body: dict) -> None:
        """Decrement the overlay for the fields one acked/dropped local op
        carried (an ``add`` carries all of them)."""
        whole = body["a"] == "add"
        if whole or body.get("s") is not None:
            self.pending_start = max(0, self.pending_start - 1)
        if whole or body.get("e") is not None:
            self.pending_end = max(0, self.pending_end - 1)
        for k in body.get("props") or {}:
            n = self.pending_props.get(k, 0) - 1
            if n > 0:
                self.pending_props[k] = n
            else:
                self.pending_props.pop(k, None)


class IntervalCollection:
    """A labelled set of intervals on one SharedString.

    Op stream (reference ``intervalCollection.ts`` add/delete/change):
    positions in remote ops are resolved at the sender's ``(refSeq, client)``
    perspective; conflicts on one interval resolve by the total order (the
    last-sequenced change wins, guarded by ``last_seq``) with a
    local-pending overlay — a pending local change wins over remote changes
    because the sequencer will stamp it later, the same argument as
    SharedMap's optimistic conflict rule.
    """

    def __init__(self, label: str, owner) -> None:
        self.label = label
        self._owner = owner  # the SharedString
        self._intervals: Dict[str, Interval] = {}
        self._tombstones: set = set()  # deleted ids (remote ops ignored)
        self._id_counter = itertools.count(1)

    # -- reads ---------------------------------------------------------------

    def get(self, interval_id: str) -> Optional[Interval]:
        return self._intervals.get(interval_id)

    def resolve(self, interval_id: str) -> Optional[Tuple[int, int]]:
        """Current (start, end) positions of one interval."""
        iv = self._intervals.get(interval_id)
        if iv is None:
            return None
        h = self._owner._host_view()
        return (iv.start.position(h), iv.end.position(h))

    def all(self) -> List[Tuple[str, int, int, Dict[str, Any]]]:
        h = self._owner._host_view()
        return sorted(
            (iv.id, iv.start.position(h), iv.end.position(h), dict(iv.props))
            for iv in self._intervals.values()
        )

    # -- searches (reference IntervalCollection.findOverlappingIntervals /
    # nextInterval / previousInterval; intervalCollection.ts) ---------------

    def find_overlapping(self, start: int, end: int) -> List[str]:
        """Ids of intervals whose [start, end] range intersects the query
        range (inclusive ends, like the reference's overlap search)."""
        out = []
        for iv_id, s, e, _props in self.all():
            if s <= end and e >= start and s >= 0 and e >= 0:
                out.append(iv_id)
        return out

    def next_interval(self, pos: int) -> Optional[str]:
        """The interval with the smallest start at or after ``pos``."""
        best = None
        for iv_id, s, _e, _props in self.all():
            if s >= max(pos, 0) and (best is None or s < best[0]):
                best = (s, iv_id)  # detached intervals (s < 0) never match
        return best[1] if best else None

    def previous_interval(self, pos: int) -> Optional[str]:
        """The interval with the largest start at or before ``pos``."""
        best = None
        for iv_id, s, _e, _props in self.all():
            if 0 <= s <= pos and (best is None or s > best[0]):
                best = (s, iv_id)
        return best[1] if best else None

    # -- local edits ---------------------------------------------------------

    def add(
        self,
        start: int,
        end: int,
        props: Optional[Dict[str, Any]] = None,
        interval_id: Optional[str] = None,
    ) -> str:
        assert 0 <= start <= end, "interval requires 0 <= start <= end"
        iid = interval_id or f"{self._owner.client_id}-{next(self._id_counter)}"
        h = self._owner._host_view()
        iv = Interval(
            id=iid,
            start=LocalReference(anchor_from_pos(h, start), bias="fwd"),
            end=LocalReference(anchor_from_pos(h, end), bias="bwd"),
            props=dict(props or {}),
            pending_start=1,
            pending_end=1,
            pending_props={k: 1 for k in (props or {})},
        )
        self._intervals[iid] = iv
        self._submit({"a": "add", "id": iid, "s": start, "e": end,
                      "props": iv.props})
        return iid

    def delete(self, interval_id: str) -> None:
        if self._intervals.pop(interval_id, None) is None:
            return
        self._tombstones.add(interval_id)
        self._submit({"a": "del", "id": interval_id})

    def change(
        self,
        interval_id: str,
        start: Optional[int] = None,
        end: Optional[int] = None,
        props: Optional[Dict[str, Any]] = None,
    ) -> None:
        iv = self._intervals.get(interval_id)
        if iv is None:
            raise KeyError(interval_id)
        h = self._owner._host_view()
        if start is not None:
            iv.start = LocalReference(anchor_from_pos(h, start), bias="fwd")
        if end is not None:
            iv.end = LocalReference(anchor_from_pos(h, end), bias="bwd")
        if props:
            iv.props.update(props)
            iv.props = {k: v for k, v in iv.props.items() if v is not None}
            for k in props:
                iv.pending_props[k] = iv.pending_props.get(k, 0) + 1
        if start is not None:
            iv.pending_start += 1
        if end is not None:
            iv.pending_end += 1
        self._submit({"a": "chg", "id": interval_id, "s": start, "e": end,
                      "props": props or {}})

    def _submit(self, body: dict) -> None:
        self._owner._submit_interval_op(self.label, body)

    # -- sequenced stream ----------------------------------------------------

    def process(self, body: dict, msg, local: bool) -> None:
        iid = body["id"]
        if local:
            iv = self._intervals.get(iid)
            if iv is not None:
                iv.ack_fields(body)
                iv.last_seq = msg.sequence_number
            return
        if iid in self._tombstones:
            return
        h = self._owner._host_view()
        per = dict(ref_seq=msg.reference_sequence_number, client=msg.client_id)
        if body["a"] == "add":
            if iid in self._intervals:
                return
            iv = Interval(
                id=iid,
                start=LocalReference(anchor_from_pos(h, body["s"], **per), bias="fwd"),
                end=LocalReference(anchor_from_pos(h, body["e"], **per), bias="bwd"),
                props=dict(body.get("props") or {}),
                last_seq=msg.sequence_number,
            )
            self._intervals[iid] = iv
            iv.start.normalize(h)
            iv.end.normalize(h)
        elif body["a"] == "del":
            self._intervals.pop(iid, None)
            self._tombstones.add(iid)
        elif body["a"] == "chg":
            iv = self._intervals.get(iid)
            if iv is None:
                return
            if msg.sequence_number <= iv.last_seq:
                return  # stale (defensive; the stream is totally ordered)
            # Per-field local-wins: a pending local move of one endpoint
            # shields only that endpoint; same per prop key.
            if body.get("s") is not None and iv.pending_start == 0:
                iv.start = LocalReference(
                    anchor_from_pos(h, body["s"], **per), bias="fwd"
                )
                iv.start.normalize(h)
            if body.get("e") is not None and iv.pending_end == 0:
                iv.end = LocalReference(
                    anchor_from_pos(h, body["e"], **per), bias="bwd"
                )
                iv.end.normalize(h)
            for k, v in (body.get("props") or {}).items():
                if iv.pending_props.get(k, 0) == 0:
                    if v is None:
                        iv.props.pop(k, None)
                    else:
                        iv.props[k] = v
            iv.last_seq = msg.sequence_number
        else:  # pragma: no cover
            raise ValueError(f"unknown interval op {body!r}")

    # -- maintenance ---------------------------------------------------------

    def normalize_all(self, h) -> None:
        for iv in self._intervals.values():
            iv.start.normalize(h)
            iv.end.normalize(h)

    # -- resubmit (reconnect) ------------------------------------------------

    def resubmit(self, body: dict) -> None:
        """Regenerate one pending op against current state (the reference
        recomputes endpoint positions from the still-live references)."""
        iid = body["id"]
        iv = self._intervals.get(iid)
        if body["a"] == "del" or iv is None:
            if body["a"] == "del":
                self._submit(body)
            return
        h = self._owner._host_view()
        s, e = iv.start.position(h), iv.end.position(h)
        if s == DETACHED or e == DETACHED:
            # The anchors died while offline: the op can never be expressed
            # against current state. Drop it and unwind the optimistic local
            # apply so this replica matches the others (no ghost interval,
            # no permanently-stuck pending overlay).
            iv.ack_fields(body)
            if body["a"] == "add":
                self._intervals.pop(iid, None)
            return
        out = {"a": body["a"], "id": iid, "s": s, "e": e,
               "props": body.get("props") or {}}
        if body["a"] == "chg":
            # Preserve which fields the original op carried so the ack
            # decrements exactly the overlay entries the submit incremented.
            out["s"] = s if body.get("s") is not None else None
            out["e"] = e if body.get("e") is not None else None
        self._submit(out)

    # -- summary -------------------------------------------------------------

    def summarize(self) -> list:
        h = self._owner._host_view()
        out = []
        for iv in sorted(self._intervals.values(), key=lambda v: v.id):
            s, e = iv.start.position(h), iv.end.position(h)
            if s == DETACHED or e == DETACHED:
                continue  # detached intervals never resolve again; don't
                # resurrect them at position 0 on load
            out.append({"id": iv.id, "s": s, "e": e,
                        "props": iv.props, "seq": iv.last_seq})
        return out

    def load(self, entries: list) -> None:
        h = self._owner._host_view()
        for ent in entries:
            self._intervals[ent["id"]] = Interval(
                id=ent["id"],
                start=LocalReference(anchor_from_pos(h, ent["s"]), bias="fwd"),
                end=LocalReference(anchor_from_pos(h, ent["e"]), bias="bwd"),
                props=dict(ent["props"]),
                last_seq=ent["seq"],
            )
