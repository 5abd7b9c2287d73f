"""Pure-Python oracle for the merge-sequence semantics.

An independent, list-based implementation of the merge rules in SURVEY.md
Appendix A (the reference's ``mergeTree.ts`` behavior), used to cross-check
the merge kernels K1/K2 on random op streams — the analog of the reference's
``TestClient`` + ``TestClientLogger`` harness
(``packages/dds/merge-tree/src/test/``). Deliberately simple and O(n) per op.

Consumes the same int32 op rows as the kernel (see ``ops.encode``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from fluidframework_tpu_torch.protocol.constants import (
    F_ARG,
    F_CLIENT,
    F_LEN,
    F_LSEQ,
    F_MSN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    NORM_EXISTING_LOCAL,
    NORM_NEW_LOCAL,
    OP_ACK_ANNOTATE,
    OP_ACK_INSERT,
    OP_ACK_REMOVE,
    OP_ANNOTATE,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    UNASSIGNED_SEQ,
)

SKIP = None  # the reference's `undefined` length


@dataclass
class Seg:
    orig: int
    off: int
    length: int
    seq: int
    client: int
    lseq: int = 0
    removed_seq: Optional[int] = None  # None = not removed; -1 = local pending
    rlseq: int = 0
    removers: set = field(default_factory=set)
    aseq: int = 0
    alseq: int = 0
    aval: int = 0

    def clone_tail(self, at: int) -> "Seg":
        tail = Seg(
            orig=self.orig,
            off=self.off + at,
            length=self.length - at,
            seq=self.seq,
            client=self.client,
            lseq=self.lseq,
            removed_seq=self.removed_seq,
            rlseq=self.rlseq,
            removers=set(self.removers),
            aseq=self.aseq,
            alseq=self.alseq,
            aval=self.aval,
        )
        self.length = at
        return tail


class OracleDoc:
    """One document, replica of client `self_client` (or a server replica)."""

    def __init__(self, self_client: int = -3, min_seq: int = 0):
        self.segs: List[Seg] = []
        self.self_client = self_client
        self.min_seq = min_seq
        self.cur_seq = 0

    # -- visibility ---------------------------------------------------------

    def _vis(self, seg: Seg, ref: int, client: int, is_local: bool):
        """New-length-calculation visibility (reference mergeTree.ts:935-964):
        tombstones are skipped only below minSeq; otherwise they are length 0
        and still participate in tie-breaking."""
        removed = seg.removed_seq is not None
        r_acked = removed and seg.removed_seq != UNASSIGNED_SEQ
        if r_acked and seg.removed_seq <= self.min_seq:
            return SKIP
        if is_local:
            return 0 if removed else seg.length
        rseq_eff = (
            2**62 if seg.removed_seq == UNASSIGNED_SEQ else seg.removed_seq
        )
        if removed and (rseq_eff <= ref or client in seg.removers):
            return 0
        ins_vis = seg.client == client or (
            seg.seq != UNASSIGNED_SEQ and seg.seq <= ref
        )
        return seg.length if ins_vis else 0

    # -- op application -----------------------------------------------------

    def apply(self, op: np.ndarray) -> None:
        op = np.asarray(op)
        ty = int(op[F_TYPE])
        seq = int(op[F_SEQ])
        if ty == OP_NOOP:
            pass
        elif ty == OP_INSERT:
            self._insert(op)
        elif ty == OP_REMOVE:
            self._remove(op)
        elif ty == OP_ANNOTATE:
            self._annotate(op)
        elif ty == OP_ACK_INSERT:
            for s in self.segs:
                if s.seq == UNASSIGNED_SEQ and s.lseq == int(op[F_LSEQ]):
                    s.seq = seq
                    s.lseq = 0
        elif ty == OP_ACK_REMOVE:
            for s in self.segs:
                if s.rlseq == int(op[F_LSEQ]):
                    if s.removed_seq == UNASSIGNED_SEQ:
                        s.removed_seq = seq
                    s.rlseq = 0
        elif ty == OP_ACK_ANNOTATE:
            for s in self.segs:
                if s.alseq == int(op[F_LSEQ]):
                    s.aseq = seq
                    s.alseq = 0
        self.cur_seq = max(self.cur_seq, seq)
        self.min_seq = max(self.min_seq, int(op[F_MSN]))

    def _insert(self, op: np.ndarray) -> None:
        pos, ref, client = int(op[F_POS1]), int(op[F_REF]), int(op[F_CLIENT])
        seq, lseq = int(op[F_SEQ]), int(op[F_LSEQ])
        is_local = client == self.self_client
        new = Seg(
            orig=int(op[F_ARG]),
            off=0,
            length=int(op[F_LEN]),
            seq=seq,
            client=client,
            lseq=lseq if seq == UNASSIGNED_SEQ else 0,
        )
        op_norm = NORM_NEW_LOCAL if seq == UNASSIGNED_SEQ else seq
        rem = pos
        for i, s in enumerate(self.segs):
            v = self._vis(s, ref, client, is_local)
            if v is SKIP:
                continue
            if v > 0 and rem < v:
                if rem > 0:
                    tail = s.clone_tail(rem)
                    self.segs.insert(i + 1, new)
                    self.segs.insert(i + 2, tail)
                else:
                    self.segs.insert(i, new)
                return
            if v == 0 and rem == 0:
                seg_norm = (
                    NORM_EXISTING_LOCAL if s.seq == UNASSIGNED_SEQ else s.seq
                )
                if op_norm > seg_norm:
                    self.segs.insert(i, new)
                    return
            rem -= v
        self.segs.append(new)

    def _boundary(self, pos: int, ref: int, client: int, is_local: bool) -> None:
        rem = pos
        for i, s in enumerate(self.segs):
            v = self._vis(s, ref, client, is_local)
            if v is SKIP:
                continue
            if v > 0 and 0 < rem < v:
                self.segs.insert(i + 1, s.clone_tail(rem))
                return
            if rem < v:
                return
            rem -= v

    def _walk_range(self, op: np.ndarray, action) -> None:
        start, end = int(op[F_POS1]), int(op[F_POS2])
        ref, client = int(op[F_REF]), int(op[F_CLIENT])
        is_local = client == self.self_client
        self._boundary(start, ref, client, is_local)
        self._boundary(end, ref, client, is_local)
        at = 0
        for s in self.segs:
            v = self._vis(s, ref, client, is_local)
            if v is SKIP:
                continue
            if v > 0 and at >= start and at + v <= end:
                action(s)
            at += v

    def _remove(self, op: np.ndarray) -> None:
        seq, client, lseq = int(op[F_SEQ]), int(op[F_CLIENT]), int(op[F_LSEQ])
        local_op = seq == UNASSIGNED_SEQ

        def mark(s: Seg) -> None:
            if s.removed_seq is None:
                s.removed_seq = seq
                s.rlseq = lseq if local_op else 0
            elif s.removed_seq == UNASSIGNED_SEQ:
                s.removed_seq = seq
            s.removers.add(client)

        self._walk_range(op, mark)

    def _annotate(self, op: np.ndarray) -> None:
        seq, lseq, val = int(op[F_SEQ]), int(op[F_LSEQ]), int(op[F_ARG])
        local_op = seq == UNASSIGNED_SEQ

        def mark(s: Seg) -> None:
            if not local_op and s.alseq != 0:
                return  # local pending annotate wins until acked
            s.aval = val
            s.aseq = seq
            s.alseq = lseq if local_op else 0

        self._walk_range(op, mark)

    # -- materialization ----------------------------------------------------

    def text(self, payloads: dict) -> str:
        return "".join(
            payloads[s.orig][s.off : s.off + s.length]
            for s in self.segs
            if s.removed_seq is None
        )

    def struct(self) -> list:
        """Structural fingerprint for replica comparison (live rows only)."""
        return [
            (s.orig, s.off, s.length, s.seq, s.client, s.removed_seq, s.aval)
            for s in self.segs
        ]
