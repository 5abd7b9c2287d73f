"""SharedMatrix — 2-D grid with collaborative row/col insertion and LWW cells.

Reference: ``packages/dds/matrix`` (``matrix.ts:80``): row and column order
are two merge-tree clients used as **permutation vectors**
(``permutationvector.ts:151``), cells are a sparse store keyed by stable
row/col *handles* so concurrent reorder and cell writes commute.

TPU design: both permutation vectors are :class:`SegmentState` tables driven
by the same merge kernel as SharedString (a row-insert of ``count`` rows is
one segment of length ``count``; each position's stable handle is
``(orig, offset)``), and the cell store is host-side LWW with
pending-local-wins — the reference's conflict policy.

Counterpart of ``fluidframework_tpu/models/shared_matrix.py``: each
permutation vector is a packed one-document state on the matrix's device
(the card unless the caller names the CPU), applied by K1 and compacted by
K2 in place, with the host count bound of ``models/shared_string.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops.merge_kernel import compact, jit_apply_ops
from fluidframework_tpu_torch.models.shared_string import MAX_ROWS_PER_OP
from fluidframework_tpu_torch.ops.segment_state import (
    adopt_client_slot,
    capacity_of,
    grow,
    interactive_state_from_rows,
    make_interactive_state,
    to_host,
)
from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.utils import resolve_device

# Axis-run identity: conn_no * stride + per-connection counter (slots
# recycle; the connection ordinal never does).
_MINT_STRIDE = 1 << 14


class _PermutationVector:
    """One axis's order: a kernel-backed sequence of handle runs."""

    def __init__(self, state):
        self.state = state
        self.count_hi = int(state.count)  # host upper bound on the count

    @classmethod
    def empty(cls, capacity: int, self_client: int, device):
        return cls(make_interactive_state(capacity, self_client,
                                          device=device))

    def apply(self, row: np.ndarray) -> None:
        self.state = jit_apply_ops(self.state, row[None, :].astype(np.int32))
        self.count_hi += MAX_ROWS_PER_OP
        cap = capacity_of(self.state)
        if self.count_hi > cap - 8:
            self.count_hi = int(self.state.count)
        if self.count_hi > cap - 8:
            self.state = compact(self.state)
            self.count_hi = int(self.state.count)
            if self.count_hi > cap - 8:
                self.state = grow(self.state, cap * 2)

    def handles(self) -> list:
        """Live handles in axis order: (orig, offset) per position."""
        h = to_host(self.state)
        out = []
        for i in range(int(h.count)):
            if int(h.kind[i]) == KIND_FREE or int(h.rseq[i]) != RSEQ_NONE:
                continue
            o, f, n = int(h.orig[i]), int(h.off[i]), int(h.length[i])
            out.extend((o, f + j) for j in range(n))
        return out


class SharedMatrix(SharedObject):
    """Rows and columns on ``device``: the card by default (raises without
    one), the CPU (K1/K2's plain versions) when named."""

    def __init__(self, channel_id: str, capacity: int = 128, device="cuda"):
        super().__init__(channel_id)
        self._capacity = capacity
        self._device = resolve_device(device)
        self._rows: Optional[_PermutationVector] = None
        self._cols: Optional[_PermutationVector] = None
        self._cells: Dict[Tuple[tuple, tuple], Any] = {}
        self._cell_pending: Dict[Tuple[tuple, tuple], int] = {}
        self._lseq = 0
        self._mint = 0  # per-connection axis-run id counter

    def on_reconnect(self, new_client_id: int) -> None:
        """Adopt the new client slot on both axis kernels (see
        ``segment_state.adopt_client_slot`` for the restamp rationale)."""
        self._mint = 0
        for vec in (self._rows, self._cols):
            vec.state = adopt_client_slot(vec.state, new_client_id)

    def adopt_stashed_slot(self, old_client_id: int) -> None:
        for vec in (self._rows, self._cols):
            vec.state.self_client.fill_(old_client_id)

    def attach(self, runtime) -> None:
        super().attach(runtime)
        self._rows = _PermutationVector.empty(self._capacity, self.client_id,
                                              self._device)
        self._cols = _PermutationVector.empty(self._capacity, self.client_id,
                                              self._device)

    # -- reads ----------------------------------------------------------------

    @property
    def row_count(self) -> int:
        return len(self._rows.handles())

    @property
    def col_count(self) -> int:
        return len(self._cols.handles())

    def get_cell(self, row: int, col: int, default: Any = None) -> Any:
        rh = self._rows.handles()[row]
        ch = self._cols.handles()[col]
        return self._cells.get((rh, ch), default)

    def to_list(self, default: Any = None) -> list:
        rows = self._rows.handles()
        cols = self._cols.handles()
        return [
            [self._cells.get((r, c), default) for c in cols] for r in rows
        ]

    # -- local edits ----------------------------------------------------------

    def _vector_op(self, axis: str, contents: dict, row: np.ndarray, kind: str):
        vec = self._rows if axis == "row" else self._cols
        vec.apply(row)
        self.submit_local_message(
            contents, {"kind": kind, "axis": axis, "lseq": self._lseq}
        )

    def insert_rows(self, pos: int, count: int) -> None:
        self._insert_axis("row", pos, count)

    def insert_cols(self, pos: int, count: int) -> None:
        self._insert_axis("col", pos, count)

    def _insert_axis(self, axis: str, pos: int, count: int) -> None:
        assert 0 < count < _MINT_STRIDE
        self._lseq += 1
        self._mint += 1
        assert self._mint < _MINT_STRIDE
        orig = self.conn_no * _MINT_STRIDE + self._mint
        row = E.insert(
            pos, orig, count, seq=UNASSIGNED_SEQ,
            client=self.client_id, lseq=self._lseq,
        )
        self._vector_op(
            axis,
            {"k": f"ins{axis}", "pos": pos, "count": count, "orig": orig},
            row,
            "insert",
        )

    def remove_rows(self, pos: int, count: int) -> None:
        self._remove_axis("row", pos, count)

    def remove_cols(self, pos: int, count: int) -> None:
        self._remove_axis("col", pos, count)

    def _remove_axis(self, axis: str, pos: int, count: int) -> None:
        self._lseq += 1
        row = E.remove(
            pos, pos + count, seq=UNASSIGNED_SEQ,
            client=self.client_id, lseq=self._lseq,
        )
        self._vector_op(
            axis,
            {"k": f"rem{axis}", "start": pos, "end": pos + count},
            row,
            "remove",
        )

    def set_cell(self, row: int, col: int, value: Any) -> None:
        rh = self._rows.handles()[row]
        ch = self._cols.handles()[col]
        key = (rh, ch)
        self._cells[key] = value
        self._cell_pending[key] = self._cell_pending.get(key, 0) + 1
        self.submit_local_message(
            {"k": "cell", "row": list(rh), "col": list(ch), "val": value},
            {"kind": "cell"},
        )

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        c = msg.contents
        if c["k"] == "cell":
            key = (tuple(c["row"]), tuple(c["col"]))
            if local:
                left = self._cell_pending.get(key, 0) - 1
                if left <= 0:
                    self._cell_pending.pop(key, None)
                else:
                    self._cell_pending[key] = left
                return
            if self._cell_pending.get(key, 0) > 0:
                return  # pending local write wins until acked
            self._cells[key] = c["val"]
            return

        axis = "row" if c["k"].endswith("row") else "col"
        vec = self._rows if axis == "row" else self._cols
        common = dict(
            seq=msg.sequence_number,
            ref=msg.reference_sequence_number,
            client=msg.client_id,
            msn=msg.minimum_sequence_number,
        )
        if local:
            row = E.ack(
                local_metadata["kind"],
                local_metadata["lseq"],
                msg.sequence_number,
                msn=msg.minimum_sequence_number,
            )
        elif c["k"].startswith("ins"):
            row = E.insert(c["pos"], c["orig"], c["count"], **common)
        else:
            row = E.remove(c["start"], c["end"], **common)
        vec.apply(row)

    # -- summary / load -------------------------------------------------------

    def summarize_core(self) -> dict:
        def dump(vec):
            h = to_host(vec.state)
            n = int(h.count)
            return {
                "lanes": {
                    k: np.asarray(getattr(h, k))[:n].tolist()
                    for k in (
                        "kind", "orig", "off", "length", "seq", "client",
                        "lseq", "rseq", "rlseq", "rbits", "rbits2", "rbits3", "aseq", "alseq",
                        "aval",
                    )
                },
                "count": n,
                "min_seq": int(h.min_seq),
                "cur_seq": int(h.cur_seq),
            }

        live_keys = set()
        rows = set(self._rows.handles())
        cols = set(self._cols.handles())
        cells = {}
        for (rh, chd), v in self._cells.items():
            if rh in rows and chd in cols:  # GC unreachable cells
                cells[f"{rh[0]}:{rh[1]}:{chd[0]}:{chd[1]}"] = v
        return {"rows": dump(self._rows), "cols": dump(self._cols), "cells": cells}

    def load_core(self, summary: dict) -> None:
        def restore(d):
            return _PermutationVector(interactive_state_from_rows(
                max(self._capacity, d["count"] + 16), self.client_id,
                d["lanes"], d["count"], d["min_seq"], d["cur_seq"],
                device=self._device,
            ))

        self._rows = restore(summary["rows"])
        self._cols = restore(summary["cols"])
        # A stashed-state snapshot may carry pending rows (unacked lseq
        # stamps): future local ops must not collide with them.
        self._lseq = max(
            [0]
            + [
                int(v)
                for d in (summary["rows"], summary["cols"])
                for lane in ("lseq", "rlseq", "alseq")
                for v in d["lanes"].get(lane, [])
            ]
        )
        self._cells = {}
        for key, v in summary["cells"].items():
            a, b, c, d = (int(x) for x in key.split(":"))
            self._cells[((a, b), (c, d))] = v
