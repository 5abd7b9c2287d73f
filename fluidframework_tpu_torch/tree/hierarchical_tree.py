"""HierarchicalTree DDS — the full SharedTree surface over the identity
forest.

Reference surface being reproduced (``packages/dds/tree``):
- ``SharedTreeCore`` wiring of merge state into a SharedObject
  (``shared-tree-core/sharedTreeCore.ts``),
- editable-tree proxies (``feature-libraries/editable-tree``),
- Checkout/Transaction with rollback (``core/transaction``),
- AnchorSet (``core/tree/anchorSet.ts``) — here anchors are node ids plus
  place anchors (parent, field, after-id), both stable under identity merge,
- stored schema ops (``core/schema-stored``).

Merge state is two forests: ``base`` folds the sequenced stream (identical
everywhere); the visible ``view`` is base + pending local ops replayed, so
optimistic edits and acks never transform anything — the total order does
all the merging (see tree/hierarchy.py docstring).

A copy of ``fluidframework_tpu/tree/hierarchical_tree.py``
with the port's imports; host-only.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.tree.hierarchy import (
    ROOT_ID,
    Forest,
    SchemaError,
    StoredSchema,
    _LOCAL_SEQ,
)

_ID_STRIDE = 1 << 14


class NodeProxy:
    """Editable-tree node handle: reads go through the live view; writes
    author ops. Stable across edits (identity-addressed)."""

    def __init__(self, tree: "HierarchicalTree", node_id: int):
        self._tree = tree
        self._id = node_id

    @property
    def node_id(self) -> int:
        return self._id

    @property
    def exists(self) -> bool:
        return self._tree._view.exists(self._id)

    @property
    def type(self) -> str:
        return self._tree._view.node(self._id).type

    @property
    def value(self):
        return self._tree._view.node(self._id).value

    @value.setter
    def value(self, v) -> None:
        self._tree.set_value(self._id, v)

    @property
    def insert_seq(self) -> int:
        """Sequence number that inserted this node (0 while pending) — join
        with an OpStreamAttributor for who/when (the attributor story for
        tree content; reference attributor.ts keys attribution by seq)."""
        v = self._tree._view
        n = v.node(self._id)
        if n.parent is None:
            return 0
        pid, fname = n.parent
        for e in v.node(pid).fields.get(fname, []):
            if e.node_id == self._id and e.deleted_seq is None:
                return 0 if e.seq >= (1 << 59) else e.seq
        return 0

    @property
    def value_seq(self) -> int:
        """Sequence number of the last value write (0 while pending)."""
        s = self._tree._view.node(self._id).value_seq
        return 0 if s < 0 or s >= (1 << 59) else s

    def field(self, name: str) -> "FieldProxy":
        return FieldProxy(self._tree, self._id, name)

    def __getitem__(self, name: str) -> "FieldProxy":
        return self.field(name)

    def as_data(self) -> dict:
        return self._tree._view.subtree(self._id)


class FieldProxy:
    """One sequence field of a node: list-like reads, op-authoring writes."""

    def __init__(self, tree: "HierarchicalTree", node_id: int, name: str):
        self._tree = tree
        self._id = node_id
        self._name = name

    def _ids(self) -> List[int]:
        return self._tree._view.children(self._id, self._name)

    def __len__(self) -> int:
        return len(self._ids())

    def __getitem__(self, i: int) -> NodeProxy:
        return NodeProxy(self._tree, self._ids()[i])

    def __iter__(self):
        return (NodeProxy(self._tree, nid) for nid in self._ids())

    def insert(self, index: int, *specs) -> List[NodeProxy]:
        return self._tree.insert_nodes(self._id, self._name, index, list(specs))

    def append(self, *specs) -> List[NodeProxy]:
        return self.insert(len(self), *specs)

    def delete(self, index: int) -> None:
        self._tree.delete_node(self._ids()[index])


class Anchor:
    """Node anchor: survives every edit except deletion of its node."""

    def __init__(self, tree: "HierarchicalTree", node_id: int):
        self._tree = tree
        self.node_id = node_id

    @property
    def valid(self) -> bool:
        return self._resolvable()

    def _resolvable(self) -> bool:
        v = self._tree._view
        if not v.exists(self.node_id):
            return False
        n = v.node(self.node_id)
        if n.parent is None:
            return self.node_id == ROOT_ID
        return self.node_id in v.children(*n.parent)

    def resolve(self) -> Optional[NodeProxy]:
        return NodeProxy(self._tree, self.node_id) if self._resolvable() else None


class HierarchicalTree(SharedObject):
    """The hierarchical SharedTree DDS."""

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._base = Forest()
        self._view = Forest()
        self._schema = StoredSchema()
        self._pending: List[dict] = []  # local ops not yet sequenced
        self._counter = 0
        self._tx_depth = 0
        self._tx_marks: List[int] = []
        self._tx_buffer: List[dict] = []  # ops authored inside transactions
        self._view_is_base = True  # view is a stamp-identical copy of base
        self._pruned_min_seq = 0

    # -- ids ------------------------------------------------------------------

    def _fresh_id(self) -> int:
        self._counter += 1
        assert self._counter < _ID_STRIDE, (
            "per-connection node-id space exhausted; reconnect to refresh"
        )
        return self.conn_no * _ID_STRIDE + self._counter

    def on_reconnect(self, new_client_id: int) -> None:
        self._counter = 0

    # -- reads ----------------------------------------------------------------

    @property
    def root(self) -> NodeProxy:
        return NodeProxy(self, ROOT_ID)

    def anchor(self, node: NodeProxy) -> Anchor:
        return Anchor(self, node.node_id)

    @property
    def schema(self) -> StoredSchema:
        return self._schema

    # -- local edits -----------------------------------------------------------

    def _author(self, op: dict) -> None:
        self._pending.append(op)
        if op["k"] == "schema":
            # Provisional local application so subsequent edits validate
            # against the proposed schema; the sequenced LWW supersedes.
            self._schema.set_types(op["spec"], self._schema._seq + 1)
        else:
            self._view.apply(op, _LOCAL_SEQ + len(self._pending))
        self._view_is_base = False
        if self._tx_depth > 0:
            self._tx_buffer.append(op)  # submission deferred to commit
        else:
            self.submit_local_message(op)

    def _node_spec(self, spec: dict, parent_type: Optional[str],
                   field_name: str) -> dict:
        """Assign fresh ids through a user-supplied subtree spec
        ({type, value?, fields?}) and validate against the schema."""
        self._schema.validate_insert(parent_type, field_name, spec["type"])
        out = {"id": self._fresh_id(), "type": spec["type"]}
        if "value" in spec:
            out["value"] = spec["value"]
        for fname, kids in spec.get("fields", {}).items():
            out.setdefault("fields", {})[fname] = [
                self._node_spec(k, spec["type"], fname) for k in kids
            ]
        return out

    def insert_nodes(self, parent_id: int, field_name: str, index: int,
                     specs: List[dict]) -> List[NodeProxy]:
        parent = self._view.node(parent_id)
        kids = self._view.children(parent_id, field_name)
        assert 0 <= index <= len(kids), f"index {index} out of range"
        anchor = kids[index - 1] if index > 0 else None
        ptype = parent.type if parent_id != ROOT_ID else None
        nodes = [self._node_spec(s, ptype, field_name) for s in specs]
        self._author(
            {
                "k": "ins",
                "parent": parent_id,
                "field": field_name,
                "anchor": anchor,
                "nodes": nodes,
            }
        )
        return [NodeProxy(self, n["id"]) for n in nodes]

    def delete_node(self, node_id: int) -> None:
        assert self._view.exists(node_id) and node_id != ROOT_ID
        self._author({"k": "del", "id": node_id})

    def set_value(self, node_id: int, value: Any) -> None:
        assert self._view.exists(node_id)
        self._author({"k": "val", "id": node_id, "value": value})

    def move_node(self, node_id: int, new_parent: int, field_name: str,
                  index: int) -> None:
        assert self._view.exists(node_id) and self._view.exists(new_parent)
        assert not self._view.is_ancestor(node_id, new_parent), (
            "cannot move a node under its own descendant"
        )
        kids = [
            k
            for k in self._view.children(new_parent, field_name)
            if k != node_id
        ]
        anchor = kids[index - 1] if index > 0 else None
        self._author(
            {
                "k": "move",
                "id": node_id,
                "parent": new_parent,
                "field": field_name,
                "anchor": anchor,
            }
        )

    def set_schema(self, spec: dict) -> None:
        """Propose the stored schema (LWW by sequence on the op stream)."""
        self._author({"k": "schema", "spec": spec})

    # -- transactions ----------------------------------------------------------

    @contextlib.contextmanager
    def transaction(self):
        """Batch local edits; on exception every edit in the transaction
        rolls back (reference Checkout/Transaction abort). Submission is
        deferred to the outermost commit, so an abort never has to unsend
        anything — the ops simply drop from the pending overlay."""
        self._tx_marks.append(
            (len(self._pending), self._schema.to_spec(), self._schema._seq)
        )
        self._tx_depth += 1
        try:
            yield self
        except BaseException:
            mark, schema_spec, schema_seq = self._tx_marks[-1]
            dropped = self._pending[mark:]
            del self._pending[mark:]
            # Identity filter: equal-valued dicts from different edits must
            # not alias each other out of the submit buffer.
            # graftlint: nondet(identity membership only; surviving order comes from _tx_buffer — the set is never iterated)
            dropped_ids = {id(op) for op in dropped}
            self._tx_buffer = [
                op for op in self._tx_buffer if id(op) not in dropped_ids
            ]
            # Provisional schema applications roll back with the tx.
            self._schema = StoredSchema()
            self._schema.set_types(schema_spec, schema_seq)
            self._rebuild_view()
            raise
        finally:
            self._tx_depth -= 1
            self._tx_marks.pop()
            if self._tx_depth == 0:
                buffered, self._tx_buffer = self._tx_buffer, []
                for op in buffered:
                    self.submit_local_message(op)

    # -- sequenced stream ------------------------------------------------------

    def _fold(self, forest: Forest, op: dict, seq: int) -> None:
        if op["k"] == "schema":
            if forest is self._base:
                self._schema.set_types(op["spec"], seq)
        else:
            forest.apply(op, seq)

    def _rebuild_view(self) -> None:
        self._view = self._base.clone()
        for i, op in enumerate(self._pending):
            if op["k"] != "schema":
                self._view.apply(op, _LOCAL_SEQ + i + 1)
        self._view_is_base = not self._pending

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        op = msg.contents
        self._fold(self._base, op, msg.sequence_number)
        if local:
            # Our own echo: it is (or matches) pending[0] — the base now
            # carries it, so drop it from the overlay.
            if self._pending:
                self._pending.pop(0)
        pruned = False
        if msg.minimum_sequence_number > self._pruned_min_seq:
            self._pruned_min_seq = msg.minimum_sequence_number
            self._base.prune(msg.minimum_sequence_number)
            pruned = True
        # Ingest is O(op) when there is no pending overlay: a synced view
        # folds the same op (and prune) instead of recloning the forest.
        if self._pending:
            self._rebuild_view()
        elif local or not self._view_is_base:
            self._view = self._base.clone()
            self._view_is_base = True
        else:
            if op["k"] != "schema":
                self._view.apply(op, msg.sequence_number)
            if pruned:
                self._view.prune(msg.minimum_sequence_number)

    # -- resubmit: identity ops are stable; re-send verbatim -------------------

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        self.submit_local_message(contents, local_metadata)

    # -- summary / load --------------------------------------------------------

    def summarize_core(self) -> dict:
        assert not self._pending, "summarize with pending local edits"
        return {
            "forest": self._base.serialize(),
            "schema": self._schema.to_spec(),
            "schema_seq": self._schema._seq,
        }

    def load_core(self, summary: dict) -> None:
        self._base = Forest.deserialize(summary["forest"])
        self._schema = StoredSchema()
        self._schema.set_types(summary["schema"], summary["schema_seq"])
        self._pending = []
        self._rebuild_view()
