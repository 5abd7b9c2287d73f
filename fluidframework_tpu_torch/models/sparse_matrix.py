"""SparseMatrix — row-sequenced sparse grid (sequence-deprecated family).

Reference: ``experimental/dds/sequence-deprecated`` ``SparseMatrix``: rows
are a collaborative sequence (merge-tree client) so concurrent row
insertion/removal merges positionally, while the column space is a huge
fixed virtual width (16k) and cells are LWW values addressed (rowHandle,
col) — no column insertion (that is SharedMatrix's upgrade).

Here: one kernel-backed permutation vector orders row handles (reusing the
SharedMatrix machinery, which is itself the merge-sequence kernel), and
cells live in an LWW map keyed by (row handle, col).

Counterpart of ``fluidframework_tpu/models/sparse_matrix.py``: the row
vector is a packed one-document state on the matrix's device (the card
unless the caller names the CPU).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.models.shared_matrix import (
    _MINT_STRIDE,
    _PermutationVector,
)
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops.segment_state import (
    adopt_client_slot,
    restamp_rows,
    to_host,
)
from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.rebase import regen_insert, regen_remove
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.utils import resolve_device

MAX_COLS = 1 << 14  # reference SparseMatrix's fixed virtual column space


class SparseMatrix(SharedObject):
    """Rows on ``device``: the card by default (raises without one), the
    CPU (K1/K2's plain versions) when named."""

    def __init__(self, channel_id: str, capacity: int = 128, device="cuda"):
        super().__init__(channel_id)
        self._capacity = capacity
        self._device = resolve_device(device)
        self._rows: Optional[_PermutationVector] = None
        self._cells: Dict[Tuple[tuple, int], Any] = {}
        self._cell_pending: Dict[Tuple[tuple, int], int] = {}
        self._lseq = 0
        self._mint = 0

    def attach(self, runtime) -> None:
        super().attach(runtime)
        self._rows = _PermutationVector.empty(self._capacity, self.client_id,
                                              self._device)

    def on_reconnect(self, new_client_id: int) -> None:
        self._mint = 0
        self._rows.state = adopt_client_slot(self._rows.state, new_client_id)

    # -- reads ----------------------------------------------------------------

    @property
    def row_count(self) -> int:
        return len(self._rows.handles())

    def get_cell(self, row: int, col: int, default: Any = None) -> Any:
        assert 0 <= col < MAX_COLS
        handles = self._rows.handles()
        if row >= len(handles):
            return default
        return self._cells.get((handles[row], col), default)

    def row_values(self, row: int) -> Dict[int, Any]:
        handles = self._rows.handles()
        h = handles[row]
        return {
            col: v for (hh, col), v in self._cells.items() if hh == h
        }

    # -- local edits -----------------------------------------------------------

    def insert_rows(self, pos: int, count: int) -> None:
        assert 0 < count < _MINT_STRIDE
        self._lseq += 1
        self._mint += 1
        assert self._mint < _MINT_STRIDE
        orig = self.conn_no * _MINT_STRIDE + self._mint
        row = E.insert(
            pos, orig, count, seq=UNASSIGNED_SEQ,
            client=self.client_id, lseq=self._lseq,
        )
        self._rows.apply(row)
        self.submit_local_message(
            {"k": "insrow", "pos": pos, "count": count, "orig": orig},
            {"kind": "insert", "lseq": self._lseq},
        )

    def remove_rows(self, pos: int, count: int) -> None:
        self._lseq += 1
        row = E.remove(
            pos, pos + count, seq=UNASSIGNED_SEQ,
            client=self.client_id, lseq=self._lseq,
        )
        self._rows.apply(row)
        self.submit_local_message(
            {"k": "remrow", "start": pos, "end": pos + count},
            {"kind": "remove", "lseq": self._lseq},
        )

    def set_cell(self, row: int, col: int, value: Any) -> None:
        assert 0 <= col < MAX_COLS
        handle = self._rows.handles()[row]
        key = (handle, col)
        self._cells[key] = value
        self._cell_pending[key] = self._cell_pending.get(key, 0) + 1
        self.submit_local_message(
            {"k": "cell", "handle": list(handle), "col": col, "value": value},
            {"kind": "cell"},
        )

    # -- sequenced stream ------------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        d = msg.contents
        k = d["k"]
        common = dict(
            seq=msg.sequence_number,
            ref=msg.reference_sequence_number,
            client=msg.client_id,
            msn=msg.minimum_sequence_number,
        )
        if k == "insrow":
            if local:
                self._rows.apply(
                    E.ack("insert", lseq=local_metadata["lseq"],
                          seq=msg.sequence_number,
                          msn=msg.minimum_sequence_number)
                )
            else:
                self._rows.apply(
                    E.insert(d["pos"], d["orig"], d["count"], **common)
                )
        elif k == "remrow":
            if local:
                self._rows.apply(
                    E.ack("remove", lseq=local_metadata["lseq"],
                          seq=msg.sequence_number,
                          msn=msg.minimum_sequence_number)
                )
            else:
                self._rows.apply(E.remove(d["start"], d["end"], **common))
        elif k == "cell":
            key = (tuple(d["handle"]), d["col"])
            if local:
                n = self._cell_pending.get(key, 0) - 1
                if n > 0:
                    self._cell_pending[key] = n
                else:
                    self._cell_pending.pop(key, None)
            elif key not in self._cell_pending:
                self._cells[key] = d["value"]  # LWW; local-pending wins

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        """Row ops regenerate through the kernel rebase; cell sets re-send
        (handle-addressed: stable across reconnects)."""
        if local_metadata and local_metadata.get("kind") in ("insert", "remove"):
            h = to_host(self._rows.state)
            L = local_metadata["lseq"]
            if local_metadata["kind"] == "insert":
                for run in regen_insert(h, L):
                    self._lseq += 1
                    self._restamp_rows("lseq", run.rows, self._lseq)
                    self.submit_local_message(
                        {
                            "k": "insrow",
                            "pos": run.pos,
                            "count": run.span,
                            "orig": contents["orig"],
                        },
                        {"kind": "insert", "lseq": self._lseq},
                    )
            else:
                for run in regen_remove(h, L):
                    self._lseq += 1
                    self._restamp_rows("rlseq", run.rows, self._lseq)
                    self.submit_local_message(
                        {"k": "remrow", "start": run.pos,
                         "end": run.pos + run.span},
                        {"kind": "remove", "lseq": self._lseq},
                    )
        else:
            self.submit_local_message(contents, local_metadata)

    def _restamp_rows(self, lane: str, rows: List[int], value: int) -> None:
        self._rows.state = restamp_rows(self._rows.state, lane, rows, value)

    # -- summary ---------------------------------------------------------------

    def summarize_core(self) -> dict:
        assert not self._cell_pending
        h = to_host(self._rows.state)
        # Deprecated DDS: snapshots are acked-state only (load_core replays
        # rows as baseline inserts). Stashing pending rows through it would
        # silently ack them — refuse loudly instead.
        assert not any(
            int(h.seq[i]) == UNASSIGNED_SEQ or int(h.rseq[i]) == UNASSIGNED_SEQ
            for i in range(int(h.count))
        ), "SparseMatrix snapshots cannot carry pending (unacked) rows"
        rows = []
        for i in range(int(h.count)):
            rows.append(
                [int(h.kind[i]), int(h.orig[i]), int(h.off[i]),
                 int(h.length[i]), int(h.seq[i]), int(h.rseq[i])]
            )
        return {
            "rows": rows,
            "cells": [
                [list(hh), col, v] for (hh, col), v in self._cells.items()
            ],
        }

    def load_core(self, summary: dict) -> None:
        self._rows = _PermutationVector.empty(self._capacity, self.client_id,
                                              self._device)
        # Replay visible row-runs as baseline inserts (seq 0 =
        # UniversalSequenceNumber), then restore each run's payload offset
        # so handles (orig, off + j) reproduce exactly for split rows.
        pos = 0
        offs: List[int] = []
        for kind, orig, off, length, seq, rseq in summary["rows"]:
            if kind == KIND_FREE or rseq != RSEQ_NONE:
                continue
            self._rows.apply(E.insert(pos, orig, length, seq=0, ref=0, client=0))
            offs.append(off)
            pos += length
        if offs:
            self._rows.state = restamp_rows(
                self._rows.state, "off", range(len(offs)), offs)
        self._cells = {
            (tuple(hh), col): v for hh, col, v in summary["cells"]
        }
        self._cell_pending = {}