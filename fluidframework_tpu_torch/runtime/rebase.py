"""Reconnect rebase: regenerate pending ops from kernel state.

Reference: merge-tree ``client.ts:699,917`` (``regeneratePendingOp``) +
``mergeTree.normalizeSegmentsOnRebase``: after reconnect, every unacked op
is re-created against the *current* state, at the local perspective of that
op's localSeq (later local edits are invisible to it).

Works on host copies of the segment lanes — reconnect is a rare host-side
path. The key observation that keeps regenerated ops simple: at perspective
``localSeq = L``, the rows stamped by op L are contiguous except across
rows that are visible at L, so an op regenerates into one message per
visible-gap-separated run. A copy of ``fluidframework_tpu/runtime/rebase.py``
with the port's imports: it reads host copies (``segment_state.to_host``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)


@dataclass
class RegenRun:
    """One regenerated op: a position/range plus the state rows it covers."""

    pos: int  # insert position / range start
    span: int  # range length (insert: total text length)
    rows: List[int]  # state row indices belonging to this run


def _vis(h, i: int, L: int, *, remove_strict: bool) -> int:
    """Visible length of row i at local perspective L.

    ``remove_strict``: for regenerating a remove op L, removes with
    ``rlseq == L`` are NOT yet applied (we need the rows' own widths);
    for inserts/annotates they are.
    """
    if int(h.kind[i]) == KIND_FREE:
        return 0
    ins_ok = int(h.seq[i]) != UNASSIGNED_SEQ or 0 < int(h.lseq[i]) <= L
    if not ins_ok:
        return 0
    rseq = int(h.rseq[i])
    rlseq = int(h.rlseq[i])
    if rseq != RSEQ_NONE and rseq != UNASSIGNED_SEQ:
        return 0  # acked remove hides
    if rlseq > 0 and (rlseq < L if remove_strict else rlseq <= L):
        return 0
    if rseq == UNASSIGNED_SEQ and rlseq == 0:
        # Locally removed with the pending stamp already consumed by a
        # different op's restamp — treat as hidden.
        return 0
    return int(h.length[i])


def _regen_ranges(
    h, L: int, covered, *, remove_strict: bool, consume_covered: bool
) -> List[RegenRun]:
    """Gap-separated runs of covered rows with wire positions.

    The regenerated runs go on the wire as SEPARATE ops applied in order, so
    a later run's position must match the perspective remote replicas hold
    *after the earlier runs applied*:

    - inserts/annotates (``consume_covered=True``): an earlier run's rows are
      visible to later ops (own pending inserts pass the kernel's
      ``client == clientn`` fast path even before ack), at their FULL width
      — local hiding (e.g. a not-yet-resubmitted local remove over them)
      has not happened remotely yet;
    - removes (``consume_covered=False``): an earlier run's rows are hidden
      to later ops (the removers bitmask marks them at apply time), so their
      widths must NOT advance the position.
    """
    runs: List[RegenRun] = []
    pos = 0
    current: List[int] = []
    start = 0
    for i in range(int(h.count)):
        if covered(i):
            if not current:
                start = pos
            current.append(i)
            if consume_covered:
                pos += int(h.length[i])
            continue
        v = _vis(h, i, L, remove_strict=remove_strict)
        if v > 0:
            if current:
                runs.append(
                    RegenRun(
                        pos=start,
                        span=sum(int(h.length[j]) for j in current),
                        rows=current,
                    )
                )
                current = []
            pos += v
    if current:
        runs.append(
            RegenRun(
                pos=start,
                span=sum(int(h.length[j]) for j in current),
                rows=current,
            )
        )
    return runs


def regen_insert(h, L: int) -> List[RegenRun]:
    """Regenerate a pending insert op L: one run per gap-separated group of
    its rows (an acked remote insert may have split them — each group needs
    its own wire op, as the reference emits one op per pending segment)."""

    def covered(i):
        return int(h.lseq[i]) == L and int(h.kind[i]) != KIND_FREE

    return _regen_ranges(
        h, L, covered, remove_strict=False, consume_covered=True
    )


def regen_remove(h, L: int) -> List[RegenRun]:
    """Regenerate a pending remove op L: one range per run of rows still
    only locally removed; rows whose removal was superseded by an acked
    remote remove are skipped (they are invisible to the new perspective)."""

    def covered(i):
        return (
            int(h.rlseq[i]) == L
            and int(h.rseq[i]) == UNASSIGNED_SEQ
            and int(h.kind[i]) != KIND_FREE
        )

    return _regen_ranges(
        h, L, covered, remove_strict=True, consume_covered=False
    )


def regen_annotate(h, L: int) -> List[RegenRun]:
    """Regenerate a pending annotate op L over rows still live (the
    reference skips removed segments on annotate resubmit)."""

    def covered(i):
        return (
            int(h.alseq[i]) == L
            and int(h.rseq[i]) == RSEQ_NONE
            and int(h.kind[i]) != KIND_FREE
        )

    return _regen_ranges(
        h, L, covered, remove_strict=False, consume_covered=True
    )
