"""Sequence changesets as flat run-length mark lists.

Reference: SharedTree's sequence-field kernel
(``packages/dds/tree/src/feature-libraries/sequence-field/{format,rebase,
compose,invert}.ts`` — SURVEY.md Appendix B.3): a changeset over a sequence
is a run-length list of marks co-iterated against another list with marks
split to equal lengths. This flat form is the vectorizable IR (run arrays,
prefix-sum alignment); the host implementation here is the semantic core
the device kernel mirrors.

Mark forms (tuples):
- ``("skip", n)`` — keep n input items.
- ``("del", [values])`` — remove these input items (values carried so
  inversion can revive them, the reference's detached-content analog;
  re-inserting carried values IS this IR's Revive).
- ``("ins", [values])`` — insert items at this point.
- ``("mout", (mid, start, [values]))`` — detach these input items under
  move id ``mid`` as units ``[start, start+len)`` of the move's stream
  (the reference's MoveOut, ``format.ts:14-220``).
- ``("min", (mid, start, n))`` — attach units ``[start, start+n)`` of
  move ``mid``'s stream at this point (MoveIn).

A move's stream offsets are POSITIONLESS identity: rebasing may split,
relocate, or reorder the pieces freely — ``apply`` reunites values with
attach sites by ``(mid, offset)``, never by mark order. Within one
changeset every stream offset must be detached exactly once and attached
exactly once (checked by ``apply``).

A changeset's *input length* is the sum of its skip/del/mout runs; it
applies to any sequence of at least that length (a trailing implicit skip
covers the rest). ``compose``/``invert``/``rebase`` form the group-like
algebra of the reference's ChangeRebaser contract
(``core/rebase/rebaser.ts:105-121``), property-checked in
``tests/test_tree_marks.py`` — with moves, the capture/splice semantics
mirror the reference's move-effect resolution
(``sequence-field/moveEffectTable.ts``): marks FOLLOW content that a
concurrent change moved, deletion wins over movement in either order,
and when both sides move the same content the later-sequenced move wins.

Attach tie policy (ins and min alike): when two changesets attach at the
same position, the *later-sequenced* attach ends up closer to the
position (before the earlier one) — consistent with the merge-tree
kernel's breakTie ordering. Attaches anchor to their SOURCE position
when surrounding content is concurrently moved or deleted (they slide to
the collapse boundary, they do not follow the move).

Implementation note: move-free changesets ride the original run-based
``compose``/``rebase`` co-iterations (the hot host path). Move-bearing
inputs take a unit-level canonical form — per-input-unit actions plus
per-gap attach atoms — where capture/splice is a table lookup instead of
a mark-queue dance; the two implementations are fuzz-checked equal on
move-free inputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

Mark = Tuple[str, Any]
Changeset = List[Mark]

# The complete mark vocabulary of this IR.
MARK_KINDS = ("skip", "del", "ins", "mout", "min")

# The vocabulary the dense device lowering accepts (ops/tree_kernel
# .from_marks and the EditManager device-prefix gate). This is
# the FULL mark vocabulary: mout/min lower into the dense move lanes
# (per-slot move-id/offset + tagged attach-pool atoms, resolved on device
# by a two-phase capture/splice kernel), so move-bearing commits ride the
# EM kernel instead of forcing the per-commit host fold. Foreign kinds
# are still refused loudly by both engines.
DEVICE_MARK_KINDS = MARK_KINDS


def _check_kind(t: str) -> None:
    if t not in MARK_KINDS:
        raise ValueError(
            f"mark kind {t!r} is outside the sequence-field IR "
            "({skip, del, ins, mout, min})"
        )


def skip(n: int) -> Mark:
    return ("skip", n)


def delete(values: list) -> Mark:
    return ("del", list(values))


def insert(values: list) -> Mark:
    return ("ins", list(values))


def move_out(mid: int, values: list, start: int = 0) -> Mark:
    return ("mout", (mid, start, list(values)))


def move_in(mid: int, n: int, start: int = 0) -> Mark:
    return ("min", (mid, start, n))


def has_moves(c: Changeset) -> bool:
    return any(t in ("mout", "min") for t, _v in c)


def mark_len(m: Mark) -> int:
    """Input-length of a mark (attaches consume no input)."""
    t, v = m
    if t == "skip":
        return v
    if t == "del":
        return len(v)
    if t == "mout":
        return len(v[2])
    return 0


def input_len(c: Changeset) -> int:
    return sum(mark_len(m) for m in c)


def output_len_delta(c: Changeset) -> int:
    d = 0
    for t, v in c:
        if t == "ins":
            d += len(v)
        elif t == "del":
            d -= len(v)
        elif t == "mout":
            d -= len(v[2])
        elif t == "min":
            d += v[2]
    return d


def normalize(c: Changeset) -> Changeset:
    """Merge adjacent same-type runs (mout/min only when their move
    stream is contiguous), drop empties and trailing skips."""
    out: Changeset = []
    for t, v in c:
        _check_kind(t)
        if t == "skip" and v == 0:
            continue
        if t in ("del", "ins") and not v:
            continue
        if t == "mout" and not v[2]:
            continue
        if t == "min" and v[2] == 0:
            continue
        if out and out[-1][0] == t:
            if t == "skip":
                out[-1] = ("skip", out[-1][1] + v)
                continue
            if t in ("del", "ins"):
                out[-1] = (t, out[-1][1] + list(v))
                continue
            if t == "mout":
                pm, ps, pv = out[-1][1]
                mm, ms, mv = v
                if pm == mm and ms == ps + len(pv):
                    out[-1] = ("mout", (pm, ps, pv + list(mv)))
                    continue
            if t == "min":
                pm, ps, pn = out[-1][1]
                mm, ms, mn = v
                if pm == mm and ms == ps + pn:
                    out[-1] = ("min", (pm, ps, pn + mn))
                    continue
        if t == "skip":
            out.append(("skip", v))
        elif t in ("del", "ins"):
            out.append((t, list(v)))
        elif t == "mout":
            out.append(("mout", (v[0], v[1], list(v[2]))))
        else:
            out.append(("min", (v[0], v[1], v[2])))
    while out and out[-1][0] == "skip":
        out.pop()
    return out


def apply(state: list, c: Changeset) -> list:
    """Apply a changeset to a concrete sequence."""
    detached: Dict[Tuple[Any, int], Any] = {}
    i = 0
    for t, v in c:
        _check_kind(t)
        if t == "skip":
            i += v
        elif t == "del":
            assert state[i : i + len(v)] == list(v), (
                f"delete mismatch at {i}: {state[i:i+len(v)]} != {v}"
            )
            i += len(v)
        elif t == "mout":
            mid, start, vals = v
            assert state[i : i + len(vals)] == list(vals), (
                f"move-out mismatch at {i}: {state[i:i+len(vals)]} != {vals}"
            )
            for j, val in enumerate(vals):
                key = (mid, start + j)
                assert key not in detached, f"unit {key} detached twice"
                detached[key] = val
            i += len(vals)
    out: list = []
    i = 0
    for t, v in c:
        if t == "skip":
            out.extend(state[i : i + v])
            i += v
        elif t == "del":
            i += len(v)
        elif t == "ins":
            out.extend(v)
        elif t == "mout":
            i += len(v[2])
        else:  # min
            mid, start, n = v
            for j in range(n):
                key = (mid, start + j)
                assert key in detached, f"attach of undetached unit {key}"
                out.append(detached.pop(key))
    out.extend(state[i:])
    assert not detached, f"unattached moved content: {sorted(detached)}"
    return out


def invert(c: Changeset) -> Changeset:
    """Inverse changeset (over c's output document). Moves invert to the
    return move; deletes invert to value-carrying re-inserts (Revive)."""
    vals_of: Dict[Tuple[Any, int], Any] = {}
    for t, v in c:
        if t == "mout":
            mid, start, vals = v
            for j, val in enumerate(vals):
                vals_of[(mid, start + j)] = val
    out: Changeset = []
    for t, v in c:
        _check_kind(t)
        if t == "skip":
            out.append(("skip", v))
        elif t == "del":
            out.append(("ins", list(v)))
        elif t == "ins":
            out.append(("del", list(v)))
        elif t == "mout":
            mid, start, vals = v
            out.append(("min", (mid, start, len(vals))))
        else:  # min
            mid, start, n = v
            out.append(
                ("mout", (mid, start,
                          [vals_of[(mid, start + j)] for j in range(n)]))
            )
    return normalize(out)


def lower_moves(c: Changeset) -> Changeset:
    """Move-free changeset with the same apply() result: mout lowers to a
    value-carrying delete, min to an insert of the moved values. Identity
    is preserved when values carry ids (the EditManager's id-anchor
    transport consumes this: a move becomes detach + re-attach of the
    SAME cell ids, so id-anchored concurrent edits still converge)."""
    if not has_moves(c):
        return c
    vals_of: Dict[Tuple[Any, int], Any] = {}
    for t, v in c:
        if t == "mout":
            mid, start, vals = v
            for j, val in enumerate(vals):
                vals_of[(mid, start + j)] = val
    out: Changeset = []
    for t, v in c:
        if t == "mout":
            out.append(("del", list(v[2])))
        elif t == "min":
            mid, start, n = v
            out.append(
                ("ins", [vals_of[(mid, start + j)] for j in range(n)])
            )
        else:
            out.append((t, v))
    return normalize(out)


def lift_dense(
    del_mask, ins_cnt, ins_ids, mov_id, mov_off, pool_mid, pool_off, L,
    doc,
) -> Changeset:
    """Lift the dense device IR (``ops/tree_kernel.DenseChange`` lanes)
    back to a mark changeset — the inverse of ``tree_kernel.from_marks``.
    Dense deletes/move-outs are positional, so the pre-image document
    ``doc`` supplies the carried values; dense move tags are 1-based
    (0 = none) and lift back to the host's 0-based mids. Used by the
    wire-golden fixtures and device-path debugging, not the hot path."""
    out: Changeset = []
    p = 0
    for i in range(int(L) + 1):
        n_attach = int(ins_cnt[i])
        for _ in range(n_attach):
            if int(pool_mid[p]) > 0:
                out.append(
                    ("min", (int(pool_mid[p]) - 1, int(pool_off[p]), 1))
                )
            else:
                out.append(("ins", [int(ins_ids[p])]))
            p += 1
        if i == int(L):
            break
        if int(del_mask[i]):
            out.append(("del", [doc[i]]))
        elif int(mov_id[i]) > 0:
            out.append(
                ("mout", (int(mov_id[i]) - 1, int(mov_off[i]), [doc[i]]))
            )
        else:
            out.append(("skip", 1))
    return normalize(out)


class _Reader:
    """Run reader with head splitting (the reference's MarkQueue)."""

    def __init__(self, marks: Changeset):
        for t, _v in marks:
            _check_kind(t)  # compose/rebase reject unknown kinds loudly
        self.q = [(t, v if t == "skip" else list(v)) for t, v in marks]

    def done(self) -> bool:
        return not self.q

    def head(self) -> Mark:
        return self.q[0]

    def pop(self) -> Mark:
        return self.q.pop(0)

    def take(self, n: int) -> Mark:
        """Take up to n input-units from the head run (must not be an ins)."""
        t, v = self.q[0]
        ln = mark_len((t, v))
        assert ln > 0
        if n >= ln:
            return self.q.pop(0)
        if t == "skip":
            self.q[0] = ("skip", v - n)
            return ("skip", n)
        self.q[0] = ("del", v[n:])
        return ("del", v[:n])


def compose_all(changes: List[Changeset]) -> Changeset:
    out: Changeset = []
    for c in changes:
        out = compose(out, c)
    return out


def compose(a: Changeset, b: Changeset) -> Changeset:
    """Changeset equivalent to applying ``a`` then ``b``.

    ``b`` reads a's output; the result reads a's input.
    """
    if has_moves(a) or has_moves(b):
        return _compose_units(a, b)
    return _compose_runs(a, b)


def _compose_runs(a: Changeset, b: Changeset) -> Changeset:
    """Run-based co-iteration — the move-free hot path."""
    out: Changeset = []
    ar = _Reader(a)
    br = _Reader(b)
    while not br.done():
        bt, bv = br.head()
        if bt == "ins":
            out.append(br.pop())
            continue
        n = mark_len((bt, bv))
        # Pull n units of a-output to cover b's mark.
        taken = 0
        while taken < n:
            if ar.done():
                # a's implicit trailing skip.
                rest = br.take(n - taken)
                out.append(rest)
                taken = n
                break
            at, av = ar.head()
            if at == "del":
                out.append(ar.pop())  # invisible to b; passes through
                continue
            if at == "ins":
                m = min(len(av), n - taken)
                piece = av[:m]
                if m == len(av):
                    ar.pop()
                else:
                    ar.q[0] = ("ins", av[m:])
                bm = br.take(m)
                if bm[0] == "skip":
                    out.append(("ins", piece))  # survives
                # else b deleted a's insert: cancels, emit nothing
                taken += m
            else:  # a skip
                m = min(av, n - taken)
                ar.take(m)
                out.append(br.take(m))
                taken += m
    while not ar.done():
        out.append(ar.pop() if ar.head()[0] != "ins" else ar.pop())
    return normalize(out)


def rebase(c: Changeset, over: Changeset, c_after: bool = False) -> Changeset:
    """Rebase ``c`` over concurrent ``over`` (both read the same input).

    ``c_after=False`` (default): ``c`` is the later-sequenced change, so at
    attach ties c's content lands *before* over's (merge-tree ordering),
    and when both sides move the same units c's move wins. The EditManager
    always rebases later changes over earlier ones, so the default applies
    there; ``c_after=True`` gives the mirror policy (over's attaches land
    first; over's move of shared units wins), used by axiom checks.
    """
    if has_moves(c) or has_moves(over):
        return _rebase_units(c, over, c_after)
    return _rebase_runs(c, over, c_after)


def _rebase_runs(c: Changeset, over: Changeset, c_after: bool) -> Changeset:
    """Run-based co-iteration — the move-free hot path."""
    out: Changeset = []
    cr = _Reader(c)
    orr = _Reader(over)
    while not cr.done():
        ct, cv = cr.head()
        if ct == "ins":
            if c_after and not orr.done() and orr.head()[0] == "ins":
                out.append(("skip", len(orr.pop()[1])))
            out.append(cr.pop())
            continue
        if orr.done():
            out.append(cr.pop())
            continue
        ot, ov = orr.head()
        if ot == "ins":
            out.append(("skip", len(ov)))  # over's new content: step across
            orr.pop()
            continue
        n = min(mark_len((ct, cv)), mark_len((ot, ov)))
        cm = cr.take(n)
        om = orr.take(n)
        if om[0] == "skip":
            out.append(cm)
        # om is del: that input is gone; c's skip/del over it vanishes.
    # over's trailing inserts after c's input end with no more c marks: c's
    # implicit trailing skip covers them — nothing to emit.
    return normalize(out)


# ---------------------------------------------------------------------------
# Unit-level canonical form — the move-bearing engine.
#
# A changeset over an input of n units canonicalizes to:
#   actions[i], i in [0, n):   ("skip",) | ("del", value)
#                            | ("mout", mid, off, value)
#   gaps[g], g in [0, n]:      ordered attach atoms, each
#                              ("ins", value) | ("min", mid, off)
# Gap g's atoms attach BEFORE input unit g (gap n = after the last unit).
# Move stream tags (mid, off) are positionless identity: `apply` matches
# detach to attach by tag, so relocation and reordering of pieces is free.


def _canon(c: Changeset, n: int):
    """Canonicalize over an input of ``n`` units (pads the implicit
    trailing skip)."""
    actions: List[tuple] = []
    gaps: List[List[tuple]] = [[] for _ in range(n + 1)]
    for t, v in c:
        _check_kind(t)
        i = len(actions)
        if t == "skip":
            actions.extend([("skip",)] * v)
        elif t == "del":
            actions.extend(("del", val) for val in v)
        elif t == "mout":
            mid, start, vals = v
            actions.extend(
                ("mout", mid, start + j, val) for j, val in enumerate(vals)
            )
        elif t == "ins":
            gaps[i].extend(("ins", val) for val in v)
        else:  # min
            mid, start, cnt = v
            gaps[i].extend(("min", mid, start + j) for j in range(cnt))
    assert len(actions) <= n, "canonical width below changeset input length"
    actions.extend([("skip",)] * (n - len(actions)))
    return actions, gaps


def _from_canon(actions, gaps) -> Changeset:
    out: Changeset = []
    for i in range(len(actions) + 1):
        for atom in gaps[i]:
            if atom[0] == "ins":
                out.append(("ins", [atom[1]]))
            else:
                out.append(("min", (atom[1], atom[2], 1)))
        if i == len(actions):
            break
        act = actions[i]
        if act[0] == "skip":
            out.append(("skip", 1))
        elif act[0] == "del":
            out.append(("del", [act[1]]))
        else:
            out.append(("mout", (act[1], act[2], [act[3]])))
    return normalize(out)


def _compose_units(a: Changeset, b: Changeset) -> Changeset:
    """Unit-level compose (move-bearing path). Frames: input I -> (a) ->
    O1 -> (b) -> O2; the result reads I and writes O2."""
    # Widen the input frame so a's implicit trailing skip covers all of
    # b's input: every O1 unit b touches must trace to a real input unit.
    olen_a = input_len(a) + output_len_delta(a)
    n_in = input_len(a) + max(0, input_len(b) - olen_a)
    a_act, a_gaps = _canon(a, n_in)
    # O1 with provenance: ("unit", i) kept input (possibly via a-move) or
    # ("ins", value) — a-min atoms resolve to the input unit they carry.
    a_mout_unit = {
        (act[1], act[2]): i
        for i, act in enumerate(a_act)
        if act[0] == "mout"
    }
    o1: List[tuple] = []
    for g in range(n_in + 1):
        for atom in a_gaps[g]:
            if atom[0] == "ins":
                o1.append(("ins", atom[1]))
            else:
                o1.append(("unit", a_mout_unit[(atom[1], atom[2])]))
        if g < n_in and a_act[g][0] == "skip":
            o1.append(("unit", g))
    n_o1 = len(o1)
    assert n_o1 >= input_len(b)
    b_act, b_gaps = _canon(b, n_o1)
    b_mout_o1 = {
        (act[1], act[2]): p
        for p, act in enumerate(b_act)
        if act[0] == "mout"
    }

    # Fate of each input unit i: where does it land in O2 (if anywhere)?
    # in-place (neither side moved it), dead, or at an O2 attach site.
    o1_of_unit = {
        e[1]: p for p, e in enumerate(o1) if e[0] == "unit"
    }

    def unit_value(i: int) -> Any:
        act = a_act[i]
        return act[3] if act[0] == "mout" else None

    # Composed move tags: one fresh mid per maximal contiguous attach run
    # (assigned while walking O2 attach sites below).
    actions: List[tuple] = [None] * n_in
    for i in range(n_in):
        act = a_act[i]
        if act[0] == "del":
            actions[i] = ("del", act[1])
            continue
        p = o1_of_unit.get(i)
        if p is None:
            # a moved it but its min atom resolved nowhere — impossible in
            # a well-formed changeset (apply would have asserted).
            raise AssertionError(f"input unit {i} lost by a")
        bact = b_act[p]
        if bact[0] == "del":
            actions[i] = ("del", bact[1])
        elif bact[0] == "skip":
            if act[0] == "skip":
                actions[i] = ("skip",)
            else:
                actions[i] = ("moved", None)  # a-moved, b kept: attach site
        else:  # b mout
            actions[i] = ("moved", None)
    # Walk O2 in order, assigning attach atoms to input gaps. Anchor rule:
    # an atom attaches at the gap AFTER the last in-place unit seen.
    gaps: List[List[tuple]] = [[] for _ in range(n_in + 1)]
    cur_gap = 0
    mid_counter = [0]
    run: List[int] = []  # input units of the current contiguous move run

    def flush_run():
        if not run:
            return
        mid = mid_counter[0]
        mid_counter[0] += 1
        for off, i in enumerate(run):
            # Values for units the a-canon carried (a mout'd them); units
            # a skipped but b moved get their value from b's mout below.
            actions[i] = ("mout", mid, off, unit_value(i))
            gaps[cur_gap].append(("min", mid, off))
        run.clear()

    def o2_entries():
        for p in range(n_o1 + 1):
            for atom in b_gaps[p]:
                if atom[0] == "ins":
                    yield ("ins", atom[1])
                else:
                    q = b_mout_o1[(atom[1], atom[2])]
                    yield ("o1", q)
            if p < n_o1 and b_act[p][0] == "skip":
                yield ("o1", p)

    for kind, val in o2_entries():
        if kind == "ins":
            flush_run()
            gaps[cur_gap].append(("ins", val))
            continue
        p = val
        src = o1[p]
        if src[0] == "ins":
            flush_run()
            gaps[cur_gap].append(("ins", src[1]))
            continue
        i = src[1]
        if actions[i] == ("skip",):
            flush_run()
            cur_gap = i + 1  # in-place unit: subsequent atoms anchor after
            continue
        # moved unit (by a, b, or both): extend the current move run
        run.append(i)
    flush_run()

    # Fill values for mout actions of units whose content the canonical a
    # didn't carry (a skipped them; b moved them). b's mout carried the
    # value (it read O1 = a's output, where a kept units hold input
    # values).
    for p, act in enumerate(b_act):
        if act[0] != "mout":
            continue
        src = o1[p]
        if src[0] == "unit":
            i = src[1]
            got = actions[i]
            if got[0] == "mout" and got[3] is None:
                actions[i] = ("mout", got[1], got[2], act[3])
    for i, act in enumerate(actions):
        assert act is not None and act[0] != "moved"
        if act[0] == "mout":
            assert act[3] is not None, f"unit {i} moved without a value"
    return _from_canon(actions, gaps)


def _rebase_units(c: Changeset, over: Changeset, c_after: bool) -> Changeset:
    """Unit-level rebase (move-bearing path): both read the same input;
    the result reads over's OUTPUT. Marks follow content that ``over``
    moved (capture/splice); deletion wins over movement in either order;
    both-move conflicts resolve to the later-sequenced side."""
    n = max(input_len(c), input_len(over))
    c_act, c_gaps = _canon(c, n)
    o_act, o_gaps = _canon(over, n)
    o_mout_unit = {
        (act[1], act[2]): i
        for i, act in enumerate(o_act)
        if act[0] == "mout"
    }

    # Dead / cancelled c-move units: their min atoms must drop too.
    dead: set = set()  # c (mid, off) tags whose unit over deleted
    cancelled: set = set()  # c (mid, off) tags losing a both-move conflict
    for i in range(n):
        cact = c_act[i]
        if cact[0] != "mout":
            continue
        oact = o_act[i]
        if oact[0] == "del":
            dead.add((cact[1], cact[2]))
        elif oact[0] == "mout" and c_after:
            cancelled.add((cact[1], cact[2]))

    # over's output frame: each entry is ("unit", i) (kept in place or
    # carried by over's min atoms) or ("ins",) for over's ins atoms.
    # c's rebased action applies to the carried unit wherever it lands.
    out_units: List[tuple] = []  # rebased actions, one per over-output unit
    out_gaps: List[List[tuple]] = [[]]

    def rebased_action(i: int) -> tuple:
        cact = c_act[i]
        if cact[0] == "skip":
            return ("skip",)
        if cact[0] == "del":
            return cact
        if (cact[1], cact[2]) in cancelled:
            return ("skip",)
        return cact

    def emit_unit(i: int) -> None:
        out_units.append(rebased_action(i))
        out_gaps.append([])

    def emit_over_ins() -> None:
        out_units.append(("skip",))
        out_gaps.append([])

    def emit_c_atoms(g: int) -> None:
        for atom in c_gaps[g]:
            if atom[0] == "min" and (
                (atom[1], atom[2]) in dead or (atom[1], atom[2]) in cancelled
            ):
                continue
            out_gaps[-1].append(atom)

    for g in range(n + 1):
        if not c_after:
            emit_c_atoms(g)  # c later-sequenced: its attaches land first
        for atom in o_gaps[g]:
            if atom[0] == "ins":
                emit_over_ins()
            else:
                emit_unit(o_mout_unit[(atom[1], atom[2])])
        if c_after:
            emit_c_atoms(g)
        if g < n and o_act[g][0] == "skip":
            emit_unit(g)
        # over del / over mout of unit g: nothing emitted here — the unit
        # is gone from over's output (mout'd units re-emerge at o_gaps
        # atoms above; c's del/mout of a deleted unit simply vanishes,
        # and its ATTACHES slid to this boundary via the shared gap).

    # Re-mark over the over-output frame.
    return _from_canon(out_units, out_gaps)
