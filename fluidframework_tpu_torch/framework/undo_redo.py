"""Op-based undo/redo for map and sequence DDSes.

Reference: ``packages/framework/undo-redo`` — ``UndoRedoStackManager``
groups revertibles into operations (everything between two
``closeCurrentOperation`` calls undoes as a unit), and per-DDS handlers
(``SharedMapUndoRedoHandler``, ``SharedSegmentSequenceUndoRedoHandler``)
subscribe to local change events and push revertibles. Undo emits ordinary
ops (there is no history rewind): reverting an insert removes the range,
reverting a remove re-inserts the text, so undos merge with concurrent
remote edits exactly like any other edit.

Changes generated *while undoing* land on the redo stack and vice versa
(the stack manager tracks its mode), which is how redo falls out for free.
A copy of ``fluidframework_tpu/framework/undo_redo.py`` with the port's
imports; it reads the string's state through ``_host_view`` (one copy).
"""

from __future__ import annotations

import enum
from typing import List, Optional, Protocol

from fluidframework_tpu_torch.models.shared_map import SharedMap
from fluidframework_tpu_torch.models.shared_string import SharedString


class Revertible(Protocol):
    def revert(self) -> None: ...


class _Mode(enum.Enum):
    NORMAL = 0
    UNDOING = 1
    REDOING = 2


class UndoRedoStackManager:
    """Operation-grouped undo/redo stacks (reference
    ``undoRedoStackManager.ts``)."""

    def __init__(self) -> None:
        self._undo: List[List[Revertible]] = []
        self._redo: List[List[Revertible]] = []
        self._open = False  # current operation group accepting revertibles
        self._mode = _Mode.NORMAL

    # -- capture ----------------------------------------------------------

    def push(self, revertible: Revertible) -> None:
        """Route a revertible by mode: normal edits feed the undo stack,
        edits generated by an undo feed the redo stack."""
        if self._mode == _Mode.UNDOING:
            stack = self._redo
        else:
            if self._mode == _Mode.NORMAL and self._redo:
                # A fresh user edit invalidates the redo branch.
                self._redo.clear()
            stack = self._undo
        if not self._open or not stack:
            stack.append([])
            self._open = True
        stack[-1].append(revertible)

    def close_current_operation(self) -> None:
        """End the open group: the next captured revertible starts a new
        undoable operation."""
        self._open = False

    # -- replay -----------------------------------------------------------

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)

    def undo_operation(self) -> bool:
        if not self._undo:
            return False
        group = self._undo.pop()
        self._mode = _Mode.UNDOING
        self._open = False
        try:
            for revertible in reversed(group):
                revertible.revert()
        finally:
            self._mode = _Mode.NORMAL
            self._open = False
        return True

    def redo_operation(self) -> bool:
        if not self._redo:
            return False
        group = self._redo.pop()
        self._mode = _Mode.REDOING
        self._open = False
        try:
            for revertible in reversed(group):
                revertible.revert()
        finally:
            self._mode = _Mode.NORMAL
            self._open = False
        return True


# ---------------------------------------------------------------------------
# SharedMap handler


class _MapRevertible:
    def __init__(self, m: SharedMap, key: str, previous):
        self._map = m
        self._key = key
        self._previous = previous

    def revert(self) -> None:
        if self._previous is None:
            self._map.delete(self._key)
        else:
            self._map.set(self._key, self._previous)


class SharedMapUndoRedoHandler:
    """Captures local valueChanged events into the stack manager
    (reference ``sharedMapUndoRedoHandler.ts``). ``previousValue: None``
    is treated as key-absent, matching the map's delete semantics."""

    def __init__(self, stack_manager: UndoRedoStackManager):
        self._stacks = stack_manager

    def attach(self, m: SharedMap) -> None:
        m.on("valueChanged", lambda changed, local, _m=m: self._on_change(_m, changed, local))

    def _on_change(self, m: SharedMap, changed: dict, local: bool) -> None:
        if not local:
            return
        self._stacks.push(
            _MapRevertible(m, changed["key"], changed["previousValue"])
        )


# ---------------------------------------------------------------------------
# SharedString handler


class _InsertRevertible:
    """Undo an insert by removing what remains of the inserted content.

    Tracks the content id (``orig``) instead of positions: live rows with
    that id are found at revert time, so concurrent splits and moves are
    handled without position bookkeeping (the reference tracks segments via
    TrackingGroups; ``orig`` is this design's stable segment identity)."""

    def __init__(self, s: SharedString, orig: int):
        self._string = s
        self._orig = orig

    def revert(self) -> None:
        from fluidframework_tpu_torch.protocol.constants import KIND_FREE, RSEQ_NONE

        h = self._string._host_view()
        # Collect live [start, end) spans of rows carrying our content id.
        spans = []
        pos = 0
        for i in range(int(h.count)):
            if int(h.kind[i]) == KIND_FREE:
                continue
            if int(h.rseq[i]) != RSEQ_NONE:
                continue  # tombstone: contributes no length
            n = int(h.length[i])
            if int(h.orig[i]) == self._orig:
                if spans and spans[-1][1] == pos:
                    spans[-1] = (spans[-1][0], pos + n)
                else:
                    spans.append((pos, pos + n))
            pos += n
        # Remove right-to-left so earlier spans keep their positions.
        for start, end in reversed(spans):
            self._string.remove_range(start, end)


class _RemoveRevertible:
    def __init__(self, s: SharedString, ref, text: str):
        self._string = s
        self._ref = ref
        self._text = text

    def revert(self) -> None:
        if not self._text:
            return
        pos = self._string.ref_position(self._ref) if self._ref else len(self._string)
        if pos < 0:  # reference detached (everything after it removed)
            pos = len(self._string)
        self._string.insert_text(pos, self._text)
        self._string.remove_local_reference(self._ref)


class _AnnotateRevertible:
    def __init__(self, s: SharedString, previous: list):
        self._string = s
        self._previous = previous

    def revert(self) -> None:
        for start, end, value in self._previous:
            self._string.annotate(start, end, value)


class SharedStringUndoRedoHandler:
    """Captures local sequenceDelta events
    (reference ``sharedSegmentSequenceUndoRedoHandler.ts``)."""

    def __init__(self, stack_manager: UndoRedoStackManager):
        self._stacks = stack_manager

    def attach(self, s: SharedString) -> None:
        s.on("sequenceDelta", lambda delta, local, _s=s: self._on_delta(_s, delta, local))

    def _on_delta(self, s: SharedString, delta: dict, local: bool) -> None:
        if not local:
            return
        kind = delta["kind"]
        if kind == "insert":
            self._stacks.push(_InsertRevertible(s, delta["orig"]))
        elif kind == "remove":
            # Anchor the re-insert point at the removal site; it slides
            # with concurrent edits like any local reference (A.9).
            ref = (
                s.create_local_reference(min(delta["start"], len(s)))
                if len(s)
                else None
            )
            self._stacks.push(_RemoveRevertible(s, ref, delta["removed"] or ""))
        elif kind == "annotate" and delta.get("previous") is not None:
            self._stacks.push(_AnnotateRevertible(s, delta["previous"]))
