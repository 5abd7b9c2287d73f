"""Hierarchical SharedTree — identity-anchored tree CRDT.

Reference: ``packages/dds/tree`` — the full SharedTree merges hierarchical
edits through per-field rebasers (``modular-schema/fieldChangeHandler.ts``)
over an EditManager trunk. That design transforms *positional* changesets;
this build keeps the flat sequence-field kernel for positional merge
(``tree/marks.py`` + ``tree/edit_manager.py``) and makes the hierarchical
layer **identity-anchored** instead (SURVEY.md Appendix B): every node has
a globally-unique id, sequence fields are RGA lists (insert-after-anchor,
with tombstones, later-sequenced-first tie order to match the merge-tree
kernel), values are LWW-by-sequence with a local-pending overlay, and
moves are identity reattaches with a deterministic cycle guard. Ops commute
into any replica's state given the total order, so there is no positional
rebase anywhere on the ingest path — reconnect resubmission re-sends the
same identity-anchored ops verbatim.

State model: ``base`` = the pure fold of the sequenced stream (identical on
every replica); the local ``view`` = base + pending local ops replayed. The
collab window prunes tombstones (delete seq <= minSeq) exactly like zamboni.

A copy of ``fluidframework_tpu/tree/hierarchy.py``
with the port's imports; host-only.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

ROOT_ID = 0


class SchemaError(ValueError):
    pass


@dataclass
class FieldSchema:
    """One field of a node type: an ordered 'sequence' of children or a
    'value' leaf; sequence fields may constrain child types."""

    kind: str  # "sequence" | "value"
    child_types: Optional[List[str]] = None  # sequence: allowed types


@dataclass
class NodeSchema:
    fields: Dict[str, FieldSchema] = field(default_factory=dict)


class StoredSchema:
    """Document schema (reference ``core/schema-stored``): a type registry
    agreed through the sequenced stream (LWW by sequence number)."""

    def __init__(self) -> None:
        self.types: Dict[str, NodeSchema] = {}
        self._seq = -1

    def set_types(self, spec: dict, seq: int) -> None:
        if seq <= self._seq:
            return
        self._seq = seq
        self.types = {
            tname: NodeSchema(
                fields={
                    fname: FieldSchema(**fspec)
                    for fname, fspec in tdef.get("fields", {}).items()
                }
            )
            for tname, tdef in spec.items()
        }

    def validate_insert(self, parent_type: Optional[str], field_name: str,
                        node_type: str) -> None:
        if not self.types:
            return  # schemaless documents accept anything
        if parent_type is not None:
            pdef = self.types.get(parent_type)
            if pdef is None:
                raise SchemaError(f"unknown parent type {parent_type!r}")
            fdef = pdef.fields.get(field_name)
            if fdef is None:
                raise SchemaError(
                    f"type {parent_type!r} has no field {field_name!r}"
                )
            if fdef.kind != "sequence":
                raise SchemaError(f"field {field_name!r} is not a sequence")
            if fdef.child_types is not None and node_type not in fdef.child_types:
                raise SchemaError(
                    f"field {field_name!r} does not allow {node_type!r}"
                )
        if node_type not in self.types:
            raise SchemaError(f"unknown node type {node_type!r}")

    def to_spec(self) -> dict:
        return {
            t: {
                "fields": {
                    f: {"kind": fs.kind, "child_types": fs.child_types}
                    for f, fs in ns.fields.items()
                }
            }
            for t, ns in self.types.items()
        }


@dataclass
class _Entry:
    """One child slot in a sequence field (RGA element)."""

    node_id: int
    seq: int  # insertion sequence stamp (local pending: very large)
    deleted_seq: Optional[int] = None  # tombstone stamp


@dataclass
class _Node:
    id: int
    type: str
    value: Any = None
    value_seq: int = -1  # LWW stamp for value
    parent: Optional[Tuple[int, str]] = None  # (parent id, field name)
    fields: Dict[str, List[_Entry]] = field(default_factory=dict)


_LOCAL_SEQ = 1 << 60  # pending local entries sort after everything acked


class Forest:
    """Object forest (reference ``object-forest``): id -> node maps with
    RGA sequence fields. One Forest instance is a pure fold of a stream; a
    replica holds two (base + view)."""

    def __init__(self) -> None:
        root = _Node(id=ROOT_ID, type="", parent=None)
        self.nodes: Dict[int, _Node] = {ROOT_ID: root}

    # -- queries -------------------------------------------------------------

    def node(self, node_id: int) -> _Node:
        return self.nodes[node_id]

    def exists(self, node_id: int) -> bool:
        return node_id in self.nodes

    def children(self, node_id: int, field_name: str) -> List[int]:
        """Visible child ids, in field order."""
        n = self.nodes.get(node_id)
        if n is None:
            return []
        return [
            e.node_id
            for e in n.fields.get(field_name, [])
            if e.deleted_seq is None
        ]

    def is_ancestor(self, maybe_ancestor: int, node_id: int) -> bool:
        cur = self.nodes.get(node_id)
        while cur is not None and cur.parent is not None:
            pid = cur.parent[0]
            if pid == maybe_ancestor:
                return True
            cur = self.nodes.get(pid)
        return False

    def subtree(self, node_id: int) -> dict:
        """Materialize a node and its visible descendants as plain data."""
        n = self.nodes[node_id]
        out = {"id": n.id, "type": n.type}
        if n.value is not None:
            out["value"] = n.value
        for fname, entries in n.fields.items():
            kids = [
                self.subtree(e.node_id)
                for e in entries
                if e.deleted_seq is None
            ]
            if kids:
                out.setdefault("fields", {})[fname] = kids
        return out

    # -- mutation (deterministic fold of one op) -----------------------------

    def apply(self, op: dict, seq: int) -> None:
        """Fold one sequenced (or pending, with seq=_LOCAL_SEQ+k) op."""
        k = op["k"]
        if k == "ins":
            self._insert(op, seq)
        elif k == "del":
            self._delete(op["id"], seq)
        elif k == "val":
            self._set_value(op["id"], op["value"], seq)
        elif k == "move":
            self._move(op, seq)
        else:  # pragma: no cover
            raise ValueError(f"unknown tree op {k!r}")

    def _materialize_subtree(self, spec: dict, seq: int) -> int:
        nid = spec["id"]
        node = _Node(
            id=nid, type=spec["type"], value=spec.get("value"), value_seq=seq
        )
        self.nodes[nid] = node
        for fname, kids in spec.get("fields", {}).items():
            for kid in kids:
                cid = self._materialize_subtree(kid, seq)
                node.fields.setdefault(fname, []).append(
                    _Entry(node_id=cid, seq=seq)
                )
                self.nodes[cid].parent = (nid, fname)
        return nid

    def _place(self, entries: List[_Entry], anchor: Optional[int],
               entry: _Entry) -> None:
        """RGA placement: directly after the anchor (tombstones included),
        skipping later-or-equal-sequenced runs already anchored there —
        later-sequenced inserts end up closer to the anchor, matching the
        merge-tree breakTie order. anchor None = front."""
        start = 0
        if anchor is not None:
            for i, e in enumerate(entries):
                if e.node_id == anchor:
                    start = i + 1
                    break
            else:
                start = len(entries)  # anchor pruned: append at end
        while start < len(entries) and entries[start].seq > entry.seq:
            start += 1
        entries.insert(start, entry)

    def _insert(self, op: dict, seq: int) -> None:
        parent = self.nodes.get(op["parent"])
        if parent is None:
            return  # parent's subtree was deleted concurrently: orphan drop
        fname = op["field"]
        entries = parent.fields.setdefault(fname, [])
        anchor = op.get("anchor")
        for spec in op["nodes"]:
            if spec["id"] in self.nodes:
                continue  # duplicate delivery / echo of pending
            nid = self._materialize_subtree(spec, seq)
            self.nodes[nid].parent = (parent.id, fname)
            entry = _Entry(node_id=nid, seq=seq)
            self._place(entries, anchor, entry)
            anchor = nid  # chain: subsequent nodes follow their sibling

    def _delete(self, node_id: int, seq: int) -> None:
        n = self.nodes.get(node_id)
        if n is None or n.parent is None:
            return
        pid, fname = n.parent
        parent = self.nodes.get(pid)
        if parent is None:
            return
        for e in parent.fields.get(fname, []):
            if e.node_id == node_id and e.deleted_seq is None:
                e.deleted_seq = seq
                break

    def _set_value(self, node_id: int, value: Any, seq: int) -> None:
        n = self.nodes.get(node_id)
        if n is None:
            return
        if seq >= n.value_seq:
            n.value = value
            n.value_seq = seq

    def _move(self, op: dict, seq: int) -> None:
        nid = op["id"]
        n = self.nodes.get(nid)
        new_parent = self.nodes.get(op["parent"])
        if n is None or new_parent is None or n.parent is None:
            return
        # Cycle guard: a move under one's own descendant is skipped
        # (deterministic — every replica sees the same sequenced prefix).
        if nid == op["parent"] or self.is_ancestor(nid, op["parent"]):
            return
        old_pid, old_fname = n.parent
        old_parent = self.nodes.get(old_pid)
        if old_parent is not None:
            entry = next(
                (
                    e
                    for e in old_parent.fields.get(old_fname, [])
                    if e.node_id == nid
                ),
                None,
            )
            if entry is None or entry.deleted_seq is not None:
                # A concurrent delete sequenced first: delete wins — moving
                # the tombstone would resurrect the node.
                return
            # Tombstone the old slot (anchors to this id in the old field
            # stay resolvable; prune reclaims it at the window floor).
            entry.deleted_seq = seq
        entries = new_parent.fields.setdefault(op["field"], [])
        self._place(entries, op.get("anchor"), _Entry(node_id=nid, seq=seq))
        n.parent = (new_parent.id, op["field"])

    # -- collab-window pruning (zamboni) -------------------------------------

    def prune(self, min_seq: int) -> None:
        """Drop tombstones (and their subtrees) deleted at or below the
        window floor: no future op can reference them. A tombstone left by
        a MOVE reclaims only the entry — the node lives on at its current
        location, so cascade deletion applies only when the node's parent
        pointer still names the pruned slot."""
        dead: List[int] = []
        for n in self.nodes.values():
            for fname, entries in n.fields.items():
                # A move within one field leaves a tombstone AND a live
                # entry for the same node: the live one owns the node.
                live_ids = {
                    e.node_id for e in entries if e.deleted_seq is None
                }
                for e in list(entries):
                    if e.deleted_seq is not None and e.deleted_seq <= min_seq:
                        entries.remove(e)
                        child = self.nodes.get(e.node_id)
                        if (
                            child is not None
                            and child.parent == (n.id, fname)
                            and e.node_id not in live_ids
                        ):
                            dead.append(e.node_id)
        while dead:
            nid = dead.pop()
            n = self.nodes.pop(nid, None)
            if n is None:
                continue
            for fname, entries in n.fields.items():
                for e in entries:
                    # Only descend into children that still LIVE here — a
                    # child moved away leaves a tombstoned entry behind but
                    # belongs to its new parent now.
                    child = self.nodes.get(e.node_id)
                    if child is not None and child.parent == (nid, fname):
                        dead.append(e.node_id)

    # -- serialization -------------------------------------------------------

    def serialize(self) -> dict:
        return {
            "nodes": [
                {
                    "id": n.id,
                    "type": n.type,
                    "value": n.value,
                    "value_seq": n.value_seq,
                    "parent": list(n.parent) if n.parent else None,
                    "fields": {
                        f: [
                            [e.node_id, e.seq, e.deleted_seq]
                            for e in entries
                        ]
                        for f, entries in n.fields.items()
                    },
                }
                for n in self.nodes.values()
            ]
        }

    @classmethod
    def deserialize(cls, data: dict) -> "Forest":
        f = cls()
        f.nodes = {}
        for nd in data["nodes"]:
            node = _Node(
                id=nd["id"], type=nd["type"], value=nd["value"],
                value_seq=nd["value_seq"],
                parent=tuple(nd["parent"]) if nd["parent"] else None,
            )
            node.fields = {
                fname: [
                    _Entry(node_id=e[0], seq=e[1], deleted_seq=e[2])
                    for e in entries
                ]
                for fname, entries in nd["fields"].items()
            }
            f.nodes[node.id] = node
        if ROOT_ID not in f.nodes:
            f.nodes[ROOT_ID] = _Node(id=ROOT_ID, type="")
        return f

    def clone(self) -> "Forest":
        return Forest.deserialize(self.serialize())
