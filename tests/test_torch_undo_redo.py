"""The port's undo-redo and SharedMap against the reference.

Both packages run the same script (``tests/test_torch_shared_string.py``'s
:class:`Side`): runtimes with a ``SharedString`` and a ``SharedMap``, an
``UndoRedoStackManager`` on runtime 0 capturing both through their
handlers, concurrent remote edits, grouped operations, undos and redos.
After every step the texts, annotations, lanes, maps and summary bytes
equal the reference's, and the replicas converge.
"""

import numpy as np
import pytest

from tests.test_torch_shared_string import both, same_strings, summary_bytes


def make(ns):
    return (ns.SharedString("text", capacity=32), ns.SharedMap("map"))


def undo_script(sides, rng, steps):
    ref = sides[0]
    for side in sides:
        side.stack = side.ns.undo.UndoRedoStackManager()
        side.ns.undo.SharedStringUndoRedoHandler(side.stack).attach(
            side.ch(0, "text"))
        side.ns.undo.SharedMapUndoRedoHandler(side.stack).attach(
            side.ch(0, "map"))
    for step in range(steps):
        i = 0 if rng.random() < 0.7 else int(rng.integers(1, len(ref.rts)))
        n = len(ref.ch(i, "text").get_text())
        r = rng.random()
        if i == 0 and r < 0.15:
            op = ("undo",)
        elif i == 0 and r < 0.25:
            op = ("redo",)
        elif r < 0.35:
            op = ("map", "set", f"k{int(rng.integers(0, 4))}",
                  int(rng.integers(0, 50)))
        elif r < 0.4:
            op = ("map", "delete", f"k{int(rng.integers(0, 4))}")
        elif n > 4 and r < 0.6:
            a = int(rng.integers(0, n - 1))
            op = ("text", "remove_range", a, min(n, a + int(rng.integers(
                1, 4))))
        elif n > 4 and r < 0.7:
            a = int(rng.integers(0, n - 1))
            op = ("text", "annotate", a, min(n, a + 3),
                  int(rng.integers(1, 5)))
        else:
            op = ("text", "insert_text", int(rng.integers(0, n + 1)),
                  "".join(chr(97 + int(x)) for x in rng.integers(0, 26, 3)))
        close = rng.random() < 0.6
        for side in sides:
            if op[0] == "undo":
                side.stack.undo_operation()
            elif op[0] == "redo":
                side.stack.redo_operation()
            else:
                getattr(side.ch(i, op[0]), op[1])(*op[2:])
            if close:
                side.stack.close_current_operation()
        if rng.random() < 0.4:
            for side in sides:
                side.rts[i].flush()
        if rng.random() < 0.4:
            k = int(rng.integers(0, len(ref.rts)))
            for side in sides:
                side.rts[k].process_incoming(3)
        same_strings(*sides, what=f"step {step}")
        for a, b in zip(ref.rts, sides[1].rts):
            assert dict(b.get_channel("map").items()) == \
                dict(a.get_channel("map").items())
        assert (sides[1].stack.can_undo, sides[1].stack.can_redo) == \
            (ref.stack.can_undo, ref.stack.can_redo)
    for side in sides:
        side.drain()
    same_strings(*sides, what="drained")
    for side in sides:
        texts = {side.ch(i, "text").get_text() for i in range(len(side.rts))}
        maps = {repr(sorted(side.ch(i, "map").items()))
                for i in range(len(side.rts))}
        assert len(texts) == 1 and len(maps) == 1
    for a, b in zip(ref.rts, sides[1].rts):
        assert summary_bytes(b.get_channel("map")) == \
            summary_bytes(a.get_channel("map"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_undo_redo_in_lockstep(seed):
    sides = both(2, make)
    undo_script(sides, np.random.default_rng(seed), 80)


def test_undo_restores_text_map_and_annotations():
    """A grouped operation (insert, annotate, remove, map set) undoes as a
    unit and redoes, on both packages alike."""
    sides = both(2, make)
    for side in sides:
        stack = side.ns.undo.UndoRedoStackManager()
        s, m = side.ch(0, "text"), side.ch(0, "map")
        side.ns.undo.SharedStringUndoRedoHandler(stack).attach(s)
        side.ns.undo.SharedMapUndoRedoHandler(stack).attach(m)
        s.insert_text(0, "hello world")
        stack.close_current_operation()
        s.annotate(0, 5, 3)
        s.remove_range(5, 6)
        m.set("title", "t1")
        stack.close_current_operation()
        side.drain()
        side.seen = [s.get_text(), s.annotations(), m.get("title")]
        assert stack.undo_operation()
        side.drain()
        side.seen += [s.get_text(), s.annotations(), m.get("title")]
        assert stack.redo_operation()
        side.drain()
        side.seen += [s.get_text(), s.annotations(), m.get("title"),
                      side.ch(1, "text").get_text()]
    assert sides[1].seen == sides[0].seen
    assert sides[1].seen[3] == "hello world"
    same_strings(*sides, what="after redo")
