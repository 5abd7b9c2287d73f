"""Legacy SharedTree (0.1) — whole-tree DDS with an edit log and history.

Reference: ``experimental/dds/tree`` — the earlier SharedTree: every edit is
an atomic Edit (array of change primitives Insert/Detach/SetValue/Constraint
applied all-or-nothing), an ``EditLog`` retains sequenced edits with
``getEditAtIndex``/``getIndexOfId``, a ``LogViewer`` produces the
``RevisionView`` (immutable snapshot) after any edit index, and
``HistoryEditFactory`` derives inverse edits for undo.

Built over the identity forest (tree/hierarchy.py): change primitives lower
to identity ops; a constraint violation or malformed change makes the WHOLE
edit a no-op (the reference's transactional drop semantics), which is
deterministic on every replica because validation runs against the
sequenced prefix.

A copy of ``fluidframework_tpu/tree/legacy_tree.py``
with the port's imports; host-only.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.tree.hierarchy import ROOT_ID, Forest, _LOCAL_SEQ

_ID_STRIDE = 1 << 14


@dataclass
class Edit:
    """One atomic edit: an id plus its change primitives."""

    edit_id: int
    changes: List[dict]


class EditLog:
    """Sequenced edit history (reference EditLog): index and id access."""

    def __init__(self) -> None:
        self._edits: List[Edit] = []
        self._by_id: Dict[int, int] = {}

    def append(self, edit: Edit) -> None:
        self._by_id[edit.edit_id] = len(self._edits)
        self._edits.append(edit)

    def __len__(self) -> int:
        return len(self._edits)

    def get_edit_at_index(self, i: int) -> Edit:
        return self._edits[i]

    def get_index_of_id(self, edit_id: int) -> int:
        return self._by_id[edit_id]


def _apply_changes(
    forest: Forest, changes: List[dict], seq: int
) -> Optional[Forest]:
    """Validate-and-apply one edit atomically. Each change validates
    against the state its PREDECESSORS produced (the reference applies
    edit changes sequentially), on a clone — returns the new forest, or
    None (caller keeps the original untouched) on any violation."""
    work = forest.clone()
    for ch in changes:
        k = ch["k"]
        if k == "constraint":
            ids = work.children(ch["parent"], ch["field"])
            if "length" in ch and len(ids) != ch["length"]:
                return None
            if "contains" in ch and ch["contains"] not in ids:
                return None
            continue
        if k == "ins":
            if not work.exists(ch["parent"]):
                return None
        elif k in ("del", "val"):
            if not work.exists(ch["id"]) or (
                k == "del" and ch["id"] == ROOT_ID
            ):
                return None
        elif k == "move":
            if (
                not work.exists(ch["id"])
                or not work.exists(ch["parent"])
                or work.is_ancestor(ch["id"], ch["parent"])
                or ch["id"] == ch["parent"]
            ):
                return None
        else:
            return None
        work.apply(ch, seq)
    return work


class LogViewer:
    """RevisionView access: the forest state after edit index i (reference
    LogViewer.getRevisionViewInSession). Views are recomputed by folding the
    log prefix — edits are small and history is bounded by the log."""

    def __init__(self, log: EditLog):
        self._log = log

    def revision_at(self, index: int) -> Forest:
        f = Forest()
        for i in range(index):
            edit = self._log.get_edit_at_index(i)
            applied = _apply_changes(f, edit.changes, seq=i + 1)
            if applied is not None:
                f = applied
        return f


def invert_changes(forest_before: Forest, changes: List[dict]) -> List[dict]:
    """HistoryEditFactory: the inverse edit. Changes apply sequentially, so
    each change's inverse derives against the INTERMEDIATE state its
    predecessors produced (an edit may set a value on the node it just
    inserted); the inverses then compose in reverse. An edit the forest
    dropped (constraint/validation) inverts to nothing."""
    if _apply_changes(forest_before, changes, seq=1) is None:
        return []  # the edit was a no-op everywhere; so is its undo
    work = forest_before.clone()
    inv_rev: List[dict] = []
    for ch in changes:
        k = ch["k"]
        if k == "ins":
            inv_rev.extend(
                {"k": "del", "id": n["id"]} for n in reversed(ch["nodes"])
            )
        elif k == "del":
            n = work.node(ch["id"])
            pid, fname = n.parent
            kids = work.children(pid, fname)
            at = kids.index(ch["id"])
            inv_rev.append(
                {
                    "k": "ins",
                    "parent": pid,
                    "field": fname,
                    "anchor": kids[at - 1] if at > 0 else None,
                    "nodes": [work.subtree(ch["id"])],
                }
            )
        elif k == "val":
            inv_rev.append(
                {"k": "val", "id": ch["id"], "value": work.node(ch["id"]).value}
            )
        elif k == "move":
            n = work.node(ch["id"])
            pid, fname = n.parent
            kids = work.children(pid, fname)
            at = kids.index(ch["id"])
            inv_rev.append(
                {
                    "k": "move",
                    "id": ch["id"],
                    "parent": pid,
                    "field": fname,
                    "anchor": kids[at - 1] if at > 0 else None,
                }
            )
        if k != "constraint":
            work.apply(ch, 1)
    return list(reversed(inv_rev))


class LegacySharedTree(SharedObject):
    """The 0.1 SharedTree surface: atomic edits, history, undo."""

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._forest = Forest()
        self._log = EditLog()
        self._counter = 0
        self._pending: List[Edit] = []

    def on_reconnect(self, new_client_id: int) -> None:
        self._counter = 0

    # -- ids / reads ----------------------------------------------------------

    def _fresh(self) -> int:
        self._counter += 1
        assert self._counter < _ID_STRIDE
        return self.conn_no * _ID_STRIDE + self._counter

    @property
    def edit_log(self) -> EditLog:
        return self._log

    @property
    def log_viewer(self) -> LogViewer:
        return LogViewer(self._log)

    def current_view(self) -> dict:
        return self._forest.subtree(ROOT_ID)

    def children(self, parent: int, field_name: str) -> List[int]:
        return self._forest.children(parent, field_name)

    # -- authoring ------------------------------------------------------------

    def _assign_ids(self, spec: dict) -> dict:
        out = {"id": self._fresh(), "type": spec.get("type", "node")}
        if "value" in spec:
            out["value"] = spec["value"]
        for fname, kids in spec.get("fields", {}).items():
            out.setdefault("fields", {})[fname] = [
                self._assign_ids(k) for k in kids
            ]
        return out

    def apply_edit(self, *changes: dict) -> int:
        """Author one atomic edit; returns its edit id."""
        resolved = []
        for ch in changes:
            if ch["k"] == "ins" and "nodes" in ch and any(
                "id" not in n for n in ch["nodes"]
            ):
                ch = {**ch, "nodes": [self._assign_ids(n) for n in ch["nodes"]]}
            resolved.append(ch)
        edit = Edit(edit_id=self._fresh(), changes=resolved)
        self._pending.append(edit)
        self.submit_local_message(
            {"edit_id": edit.edit_id, "changes": resolved}
        )
        return edit.edit_id

    def insert_node(self, parent: int, field_name: str, spec: dict,
                    anchor: Optional[int] = None) -> int:
        node = self._assign_ids(spec)
        self.apply_edit(
            {
                "k": "ins",
                "parent": parent,
                "field": field_name,
                "anchor": anchor,
                "nodes": [node],
            }
        )
        return node["id"]

    def undo(self, edit_id: int) -> Optional[int]:
        """Author the inverse of a sequenced edit (HistoryEditFactory)."""
        idx = self._log.get_index_of_id(edit_id)
        before = LogViewer(self._log).revision_at(idx)
        inv = invert_changes(before, self._log.get_edit_at_index(idx).changes)
        if not inv:
            return None
        return self.apply_edit(*inv)

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        if local and self._pending:
            self._pending.pop(0)
        edit = Edit(
            edit_id=msg.contents["edit_id"],
            changes=msg.contents["changes"],
        )
        # Atomic apply: a failed edit still logs (the reference keeps
        # dropped edits in the log flagged as no-ops).
        applied = _apply_changes(self._forest, edit.changes, msg.sequence_number)
        if applied is not None:
            self._forest = applied
        self._log.append(edit)
        self._forest.prune(msg.minimum_sequence_number)

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        self.submit_local_message(contents, local_metadata)

    # -- summary --------------------------------------------------------------

    def summarize_core(self) -> dict:
        assert not self._pending
        return {
            "forest": self._forest.serialize(),
            "log": [[e.edit_id, e.changes] for e in self._log._edits],
        }

    def load_core(self, summary: dict) -> None:
        self._forest = Forest.deserialize(summary["forest"])
        self._log = EditLog()
        for eid, changes in summary["log"]:
            self._log.append(Edit(edit_id=eid, changes=changes))
        self._pending = []
