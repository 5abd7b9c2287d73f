"""The port's interval collections and local references against the
reference.

Both packages run the same script (``tests/test_torch_shared_string.py``'s
:class:`Side`): three runtimes with a ``SharedString`` carrying two interval
collections, concurrent text edits (removes that take interval endpoints
with them, so references slide or detach), interval adds, changes and
deletes, and a runtime going offline with pending interval ops. After
every step every replica's interval positions, props, lanes and summary
bytes equal the reference's.
"""

import numpy as np
import pytest

from fluidframework_tpu_torch.models.interval_collection import (
    DETACHED,
    LocalReference,
    anchor_from_pos,
)
from fluidframework_tpu.models import interval_collection as ref_ic
from tests.test_torch_shared_string import both, same_strings

LABELS = ("comments", "marks")


def same_intervals(ref, port, what=""):
    same_strings(ref, port, what=what)
    for i in range(len(ref.rts)):
        for label in LABELS:
            want = ref.ch(i, "text").get_interval_collection(label).all()
            got = port.ch(i, "text").get_interval_collection(label).all()
            assert got == want, f"{what}: rt {i} {label}"


def interval_script(sides, rng, steps: int, offline_at=()):
    ref = sides[0]
    for step in range(steps):
        i = int(rng.integers(0, len(ref.rts)))
        s = ref.ch(i, "text")
        n = len(s.get_text())
        label = LABELS[int(rng.integers(0, 2))]
        # Collections are made on first use: touch it on both sides.
        ids = [[iv[0] for iv in side.ch(i, "text").get_interval_collection(
            label).all()] for side in sides][0]
        r = rng.random()
        if n < 6 or r < 0.3:
            op = ("text", "insert_text", int(rng.integers(0, n + 1)),
                  "".join(chr(97 + int(x)) for x in rng.integers(0, 26, 4)))
        elif r < 0.5:
            a = int(rng.integers(0, n - 1))
            op = ("text", "remove_range", a,
                  min(n, a + int(rng.integers(1, 6))))
        elif r < 0.7 or not ids:
            a = int(rng.integers(0, n - 1))
            op = ("ic", label, "add", a, min(n - 1, a + int(rng.integers(
                0, 5))), {"k": int(rng.integers(0, 9))})
        elif r < 0.9:
            iid = ids[int(rng.integers(0, len(ids)))]
            a = int(rng.integers(0, n - 1))
            op = ("ic", label, "change", iid, a,
                  min(n - 1, a + 2) if rng.random() < 0.5 else None,
                  {"k": int(rng.integers(0, 9))})
        else:
            op = ("ic", label, "delete", ids[int(rng.integers(0, len(ids)))])
        for side in sides:
            s = side.ch(i, "text")
            if op[0] == "text":
                getattr(s, op[1])(*op[2:])
            else:
                col = s.get_interval_collection(op[1])
                if op[2] == "add":
                    col.add(op[3], op[4], props=op[5])
                elif op[2] == "change":
                    col.change(op[3], start=op[4], end=op[5], props=op[6])
                else:
                    col.delete(op[3])
        if step in offline_at:
            for side in sides:
                side.rts[0].disconnect()
        if step - 3 in offline_at:
            for side in sides:
                side.rts[0].reconnect()
        if rng.random() < 0.35:
            for side in sides:
                side.rts[i].flush()
        if rng.random() < 0.35:
            k = int(rng.integers(0, len(ref.rts)))
            n = int(rng.integers(1, 4))
            for side in sides:
                if side.rts[k].connected:
                    side.rts[k].process_incoming(n)
        if len(sides) == 2:
            same_intervals(*sides, what=f"step {step}")
    for side in sides:
        side.drain()
    if len(sides) == 2:
        same_intervals(*sides, what="drained")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_collections_in_lockstep(seed):
    """Each replica's intervals equal its reference twin's after every step.
    (Replicas of one package need not agree on interval positions under
    this script: the reference's do not either.)"""
    sides = both(3, lambda ns: (ns.SharedString("text", capacity=32),))
    interval_script(sides, np.random.default_rng(seed), 70,
                    offline_at=(30,))


def test_endpoints_after_removes_slide_and_detach():
    """An interval over text that concurrent removes take away slides to
    the nearest surviving chars, then detaches when the document empties;
    the searches see the same intervals in both packages."""
    sides = both(2, lambda ns: (ns.SharedString("text"),))
    for side in sides:
        a, b = (side.ch(k, "text") for k in (0, 1))
        a.insert_text(0, "0123456789")
        side.drain()
        col = a.get_interval_collection("comments")
        iid = col.add(3, 6, props={"who": "a"})
        col.add(8, 9)
        side.drain()
        b.remove_range(2, 5)
        a.remove_range(5, 7)
        side.drain()
        assert col.find_overlapping(0, 9) == \
            side.ch(1, "text").get_interval_collection(
                "comments").find_overlapping(0, 9)
        side.results = [col.resolve(iid), col.next_interval(0),
                        col.previous_interval(9)]
        a.remove_range(0, len(a.get_text()))
        side.drain()
        side.results.append(col.resolve(iid))
    same_intervals(*sides, what="after removes")
    assert sides[1].results == sides[0].results
    assert sides[1].results[-1] == (DETACHED, DETACHED)


def test_local_reference_rules_match_reference():
    """``anchor_from_pos``, ``position`` and ``normalize`` on the same host
    views in both packages, at every position and both biases."""
    sides = both(2, lambda ns: (ns.SharedString("text"),))
    for side in sides:
        a, b = (side.ch(k, "text") for k in (0, 1))
        a.insert_text(0, "abcdefghij")
        side.drain()
        a.remove_range(2, 4)  # pending local remove
        b.remove_range(6, 8)
        side.rts[1].flush()
        side.rts[0].process_incoming()
    ha = sides[0].ch(0, "text")._host_view()
    hp = sides[1].ch(0, "text")._host_view()
    for pos in range(-1, 12):
        for bias in ("fwd", "bwd"):
            r = ref_ic.LocalReference(ref_ic.anchor_from_pos(ha, pos),
                                      bias=bias)
            p = LocalReference(anchor_from_pos(hp, pos), bias=bias)
            assert p.anchor == r.anchor
            assert p.position(hp) == r.position(ha)
            r.normalize(ha)
            p.normalize(hp)
            assert (p.anchor, p.detached) == (r.anchor, r.detached)
        for client in (0, 1):
            assert anchor_from_pos(hp, pos, ref_seq=2, client=client) == \
                ref_ic.anchor_from_pos(ha, pos, ref_seq=2, client=client)
