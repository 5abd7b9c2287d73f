"""SharedPropertyTree — typed property-tree DDS with changeset algebra.

Reference: ``experimental/PropertyDDS`` (Autodesk) — a typed property tree
(`property-properties`) whose edits are **changesets** with a full algebra
(`property-changeset`): apply, squash (compose), and rebase. Properties are
typed primitives (Int32/Float64/String/Bool) or containers (NodeProperty
maps); paths address nested properties.

This build's subset keeps the shape of that algebra:

- ``Changeset`` = {insert: {path: (typeid, value)}, modify: {path: value},
  remove: [path]} with ``squash`` composing two changesets and ``rebase``
  transforming one over a concurrent one (modify/modify resolves by the
  sequenced order — the later writer wins; edits inside a removed subtree
  drop).
- Local edits accumulate in a pending changeset; ``commit()`` ships it as
  one op (the PropertyDDS commit model), remote changesets rebase pending.
- Typed set enforces the property's declared typeid.
- ArrayProperty: positional ``{"i", "ins"|"rm"}`` ops inside the changeset
  (``cs["arrays"][path]``), applied sequentially; rebase transforms their
  indices OT-style (concurrent removes of the same element annihilate; the
  later writer's same-point insert lands first, matching the kernel's
  breakTie order).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject

_PRIMS = {"Int32", "Float64", "String", "Bool"}


def _check_type(typeid: str, value: Any) -> None:
    ok = {
        "Int32": lambda v: isinstance(v, int) and not isinstance(v, bool),
        "Float64": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
        "String": lambda v: isinstance(v, str),
        "Bool": lambda v: isinstance(v, bool),
        "NodeProperty": lambda v: v is None,
        "Array": lambda v: isinstance(v, list),
    }.get(typeid)
    if ok is None:
        raise TypeError(f"unknown typeid {typeid!r}")
    if not ok(value):
        raise TypeError(f"{value!r} is not a {typeid}")


def empty_changeset() -> dict:
    return {"insert": {}, "modify": {}, "remove": [], "arrays": {}}


def is_empty(cs: dict) -> bool:
    return not (
        cs["insert"] or cs["modify"] or cs["remove"] or cs.get("arrays")
    )


def _transform_aop(op: dict, against: dict, op_is_later: bool) -> Optional[dict]:
    """OT index transform for one array op over a concurrent one."""
    op = dict(op)
    ai, pi = against["i"], op["i"]
    if "ins" in against:
        n = len(against["ins"])
        same_point = "ins" in op and pi == ai
        if pi > ai or (pi == ai and not (same_point and op_is_later)):
            op["i"] = pi + n
    else:
        n = against["rm"]
        if pi >= ai + n:
            op["i"] = pi - n
        elif pi >= ai:
            if "ins" in op:
                op["i"] = ai  # insert inside the removed span lands at it
            else:
                # Removes are single-element on the wire (array_remove
                # splits ranges), so an overlap means the element is
                # already gone: annihilate.
                return None
    return op


def _under(prefix: str, path: str) -> bool:
    return path == prefix or path.startswith(prefix + ".")


def squash(first: dict, second: dict) -> dict:
    """Compose: apply(doc, squash(a, b)) == apply(apply(doc, a), b)."""
    out = copy.deepcopy(first)
    out.setdefault("arrays", {})
    # Mirror apply_changeset's remove→insert→modify→arrays order: second's
    # removes must strip state BEFORE its own array ops merge in, or a
    # remove+reinsert+array-edit of the same path drops its own array ops.
    for path in second["remove"]:
        # The remove cancels only when the removed path ITSELF was created
        # by the first changeset (insert+remove = net nothing). Descendant
        # inserts under a pre-existing path clean out, but the remove still
        # ships — the pre-existing property must go on every replica.
        created_here = path in out["insert"]
        out["insert"] = {
            p: v for p, v in out["insert"].items() if not _under(path, p)
        }
        out["modify"] = {
            p: v for p, v in out["modify"].items() if not _under(path, p)
        }
        out["arrays"] = {
            p: v for p, v in out["arrays"].items() if not _under(path, p)
        }
        if path not in out["remove"] and not created_here:
            out["remove"].append(path)
    for path, tv in second["insert"].items():
        out["insert"][path] = copy.deepcopy(tv)
        if path in out["remove"]:
            out["remove"].remove(path)
    for path, v in second["modify"].items():
        if path in out["insert"]:
            out["insert"][path] = (out["insert"][path][0], copy.deepcopy(v))
        else:
            out["modify"][path] = copy.deepcopy(v)
    for path, aops in second.get("arrays", {}).items():
        out["arrays"].setdefault(path, []).extend(copy.deepcopy(aops))
    return out


def rebase(cs: dict, over: dict) -> dict:
    """Transform ``cs`` to apply after ``over`` (concurrent, sequenced
    first): edits under subtrees ``over`` removed are dropped; conflicting
    modifies keep ``cs`` (it sequences later, so it wins LWW)."""
    out = empty_changeset()
    removed = over["remove"]

    def survives(path: str) -> bool:
        return not any(_under(r, path) for r in removed)

    for path, tv in cs["insert"].items():
        if survives(path) or path in removed:
            out["insert"][path] = copy.deepcopy(tv)
    for path, v in cs["modify"].items():
        if survives(path):
            out["modify"][path] = copy.deepcopy(v)
    for path in cs["remove"]:
        if survives(path):
            out["remove"].append(path)
    for path, aops in cs.get("arrays", {}).items():
        if not survives(path):
            continue
        # Transform each of our array ops over the concurrent (earlier)
        # ones at the same path, pairwise with progression.
        theirs = [dict(o) for o in over.get("arrays", {}).get(path, [])]
        mine_out = []
        for mine in aops:
            cur = dict(mine)
            new_theirs = []
            for t in theirs:
                if cur is None:
                    new_theirs.append(t)
                    continue
                nxt = _transform_aop(cur, t, op_is_later=True)
                t2 = _transform_aop(t, cur, op_is_later=False)
                cur = nxt
                if t2 is not None:
                    new_theirs.append(t2)
            theirs = new_theirs
            if cur is not None:
                mine_out.append(cur)
        if mine_out:
            out["arrays"][path] = mine_out
    return out


def apply_changeset(props: dict, cs: dict) -> None:
    """props: path -> (typeid, value) flat map (nested paths dotted)."""
    for path in cs["remove"]:
        for p in [p for p in props if _under(path, p)]:
            del props[p]
    for path, (typeid, value) in cs["insert"].items():
        props[path] = (typeid, copy.deepcopy(value))
    for path, value in cs["modify"].items():
        if path in props:
            props[path] = (props[path][0], copy.deepcopy(value))
    for path, aops in cs.get("arrays", {}).items():
        if path not in props or props[path][0] != "Array":
            continue
        arr = list(props[path][1])
        for op in aops:
            i = min(max(op["i"], 0), len(arr))
            if "ins" in op:
                arr[i:i] = copy.deepcopy(op["ins"])
            else:
                del arr[i : i + op["rm"]]
        props[path] = ("Array", arr)


class SharedPropertyTree(SharedObject):
    """PropertyDDS subset: typed properties, changeset commits."""

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._props: Dict[str, Tuple[str, Any]] = {}
        self._staged = empty_changeset()  # uncommitted local edits
        # Committed changesets: [0] is the single in-flight one (Jupiter
        # rule — see ot_json.py: one op in flight keeps each wire
        # changeset's context equal to its refSeq state); the rest queue
        # locally and submit on ack.
        self._pending: List[dict] = []
        self._in_flight = False
        # Canonical history window for total-order bridging of positional
        # array ops: (seq, applied-form changeset) above the MSN.
        self._history: List[Tuple[int, dict]] = []

    # -- reads ----------------------------------------------------------------

    def get(self, path: str, default: Any = None) -> Any:
        view = dict(self._props)
        for cs in self._pending + ([self._staged] if not is_empty(self._staged) else []):
            apply_changeset(view, cs)
        tv = view.get(path)
        return tv[1] if tv is not None else default

    def typeid_of(self, path: str) -> Optional[str]:
        view = dict(self._props)
        for cs in self._pending + [self._staged]:
            apply_changeset(view, cs)
        tv = view.get(path)
        return tv[0] if tv is not None else None

    def keys(self, prefix: str = "") -> List[str]:
        view = dict(self._props)
        for cs in self._pending + [self._staged]:
            apply_changeset(view, cs)
        return sorted(
            p for p in view if not prefix or _under(prefix, p)
        )

    # -- edits (staged until commit, the PropertyDDS model) --------------------

    def insert_property(self, path: str, typeid: str, value: Any = None) -> None:
        _check_type(typeid, value)
        self._staged = squash(
            self._staged, {"insert": {path: (typeid, value)}, "modify": {},
                           "remove": [], "arrays": {}}
        )

    def set_value(self, path: str, value: Any) -> None:
        tid = self.typeid_of(path)
        if tid is None:
            raise KeyError(path)
        _check_type(tid, value)
        self._staged = squash(
            self._staged, {"insert": {}, "modify": {path: value}, "remove": [],
                           "arrays": {}}
        )

    def remove_property(self, path: str) -> None:
        self._staged = squash(
            self._staged,
            {"insert": {}, "modify": {}, "remove": [path], "arrays": {}},
        )

    # -- ArrayProperty (positional OT inside the changeset) ------------------

    def insert_array_property(self, path: str, values: Optional[list] = None):
        self.insert_property(path, "Array", list(values or []))

    def _stage_aops(self, path: str, aops: List[dict]) -> None:
        if self.typeid_of(path) != "Array":
            raise TypeError(f"{path!r} is not an Array property")
        self._staged = squash(
            self._staged,
            {"insert": {}, "modify": {}, "remove": [],
             "arrays": {path: aops}},
        )

    def array_insert(self, path: str, index: int, values: list) -> None:
        self._stage_aops(path, [{"i": index, "ins": list(values)}])

    def array_remove(self, path: str, index: int, count: int = 1) -> None:
        # Single-element wire ops keep the OT transform total (no range
        # splitting); removing k elements at index = k ops at the same i.
        self._stage_aops(path, [{"i": index, "rm": 1} for _ in range(count)])

    def commit(self) -> None:
        """Ship the staged changeset as one sequenced op (queued behind any
        in-flight commit; see the Jupiter rule on _pending)."""
        if is_empty(self._staged):
            return
        cs, self._staged = self._staged, empty_changeset()
        self._pending.append(cs)
        if not self._in_flight:
            self._send_head()

    def _send_head(self) -> None:
        self._in_flight = True
        self.submit_local_message({"cs": copy.deepcopy(self._pending[0])})

    # -- sequenced stream ------------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        if local:
            # Our in-flight changeset, kept rebased over everything
            # sequenced since submit, IS the canonical applied form.
            if self._pending:
                head = self._pending.pop(0)
                apply_changeset(self._props, head)
                self._history.append((msg.sequence_number, head))
            self._in_flight = False
            if self._pending:
                self._send_head()
            self._prune_history(msg.minimum_sequence_number)
            return
        # Bridge the incoming changeset over canonical forms its author had
        # not seen (positional array indices shift; path ops are stable).
        cs = copy.deepcopy(msg.contents["cs"])
        for seq, hist in self._history:
            if seq > msg.reference_sequence_number:
                cs = rebase(cs, hist)
        self._history.append((msg.sequence_number, copy.deepcopy(cs)))
        self._prune_history(msg.minimum_sequence_number)
        apply_changeset(self._props, cs)
        # Rebase our pending + staged over the canonical incoming form.
        self._pending = [rebase(p, cs) for p in self._pending]
        self._staged = rebase(self._staged, cs)

    def _prune_history(self, min_seq: int) -> None:
        self._history = [(s, c) for s, c in self._history if s > min_seq]

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        """Only the head changeset was on the wire; re-send its kept-
        rebased form (context = post-catch-up ref state)."""
        if self._pending:
            self._in_flight = True
            self.submit_local_message({"cs": copy.deepcopy(self._pending[0])})
        else:
            self._in_flight = False

    # -- summary ---------------------------------------------------------------

    def summarize_core(self) -> dict:
        assert not self._pending and is_empty(self._staged)
        return {"props": {p: [t, v] for p, (t, v) in self._props.items()}}

    def load_core(self, summary: dict) -> None:
        self._props = {
            p: (t, v) for p, (t, v) in (
                (p, tuple(tv)) for p, tv in summary["props"].items()
            )
        }
        self._pending = []
        self._staged = empty_changeset()
