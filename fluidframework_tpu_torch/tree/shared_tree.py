"""SharedTree — rebase-merged collaborative sequence DDS.

Counterpart of ``fluidframework_tpu/tree/shared_tree.py``. ``device``
names where the EditManager's batched ingest runs: the card unless the
caller asks for the CPU.

Reference: ``packages/dds/tree`` (``shared-tree-core/sharedTreeCore.ts``,
``shared-tree/sharedTree.ts``): unlike the merge-tree family, SharedTree
merges by *rebasing changesets* through an EditManager. This exposes the
root sequence field (a collaborative list) over the full trunk/branch
machinery; hierarchical fields (modular-schema) layer on in later rounds.

Items are cells ``(id, value)`` — ids allocated per author (the
id-compressor analog: ``session_slot * 2^20 + counter``). Local edits author
positional changesets against the current view; remote commits transport
through the EditManager's id-anchor rebase. Resubmission after reconnect
re-sends the local view chain, which is kept rebased onto the trunk tip —
rebased content, not stale coordinates, goes back on the wire.
"""

from __future__ import annotations

from typing import Any, List, Optional

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.tree import marks as M
from fluidframework_tpu_torch.tree.edit_manager import Commit, EditManager

# Cell ids scope to the never-recycled connection ordinal (client slots
# recycle; a recycled slot minting slot-scoped ids would collide with the
# previous holder's still-live cells, breaking identity-based merge).
_ID_STRIDE = 1 << 14


def _decode_mark(t: str, v) -> tuple:
    """Wire form -> mark tuples (cells arrive as JSON lists)."""
    if t == "skip":
        return (t, v)
    if t in ("del", "ins"):
        return (t, [tuple(c) for c in v])
    if t == "mout":
        return (t, (v[0], v[1], [tuple(c) for c in v[2]]))
    if t == "min":
        return (t, (v[0], v[1], v[2]))
    raise ValueError(f"unknown wire mark kind {t!r}")


class SharedTree(SharedObject):
    def __init__(self, channel_id: str, device="cuda"):
        super().__init__(channel_id)
        self.device = device
        self._em: Optional[EditManager] = None
        self._counter = 0
        # Boxcar of remote sequenced commits not yet integrated: the device
        # idiom applied to the DDS itself — ingestion defers until a read/
        # author/summary forces it, so a catch-up backlog integrates as ONE
        # device trunk-scan (EditManager.add_sequenced_batch) instead of
        # per-commit host rebases.
        self._ingest_buf: List[Commit] = []
        self._ingest_min_seq = 0

    def attach(self, runtime) -> None:
        super().attach(runtime)
        self._em = EditManager(self.client_id, device=self.device)

    def on_reconnect(self, new_client_id: int) -> None:
        self._drain()
        self._em.set_session(new_client_id)
        self._counter = 0  # cell ids re-scope to the new connection ordinal

    # -- deferred ingest ------------------------------------------------------

    def _drain(self) -> None:
        if not self._ingest_buf:
            return
        buf, self._ingest_buf = self._ingest_buf, []
        self._em.add_sequenced_batch(buf, self._ingest_min_seq)

    @property
    def ingest_stats(self) -> dict:
        """Counters proving which path integrated commits, with the host
        tail broken down by fallback cause (with moves device-native,
        the remaining host share must be attributable, not a lump). The
        same tallies feed the unified registry as the labeled
        ``tree_ingest_commits_total{path,reason}`` counter at the point
        of counting (EditManager), so the burn-down is visible on
        ``GET /metrics``, not only in test assertions."""
        return {
            "device_commits": self._em.device_commits,
            "device_batches": self._em.device_batches,
            "host_commits": self._em.host_commits,
            "host_fallback_reason": dict(self._em.host_fallback_reason),
        }

    # -- reads ----------------------------------------------------------------

    def get(self) -> list:
        self._drain()
        return [v for _i, v in self._em.local_view()]

    def __len__(self) -> int:
        self._drain()
        return len(self._em.local_view())

    # -- local edits ----------------------------------------------------------

    def _fresh_cells(self, values: list) -> list:
        cells = []
        for v in values:
            self._counter += 1
            assert self._counter < _ID_STRIDE, (
                "per-connection cell-id space exhausted; reconnect to refresh"
            )
            cells.append((self.conn_no * _ID_STRIDE + self._counter, v))
        return cells

    def _author(self, change: M.Changeset) -> None:
        self._drain()
        change = M.normalize(change)
        self._em.add_local(change)
        self.submit_local_message({"marks": change})

    def insert_nodes(self, index: int, values: list) -> None:
        assert values
        self._drain()
        view = self._em.local_view()
        assert 0 <= index <= len(view), f"insert index {index} out of range"
        self._author([M.skip(index), M.insert(self._fresh_cells(values))])

    def delete_nodes(self, index: int, count: int = 1) -> None:
        self._drain()
        view = self._em.local_view()
        assert 0 <= index and index + count <= len(view)
        self._author([M.skip(index), M.delete(view[index : index + count])])

    def move_nodes(self, index: int, count: int, dest: int) -> None:
        """Move ``view[index:index+count]`` so it lands at position
        ``dest`` of the post-detach sequence — a first-class move
        changeset (mout/min marks, the reference sequence-field MoveOut/
        MoveIn, ``format.ts:14-220``), NOT a delete + fresh insert: cell
        ids are preserved, so concurrent edits anchored to the moved
        cells follow them."""
        self._drain()
        view = self._em.local_view()
        assert 0 <= index and index + count <= len(view)
        assert 0 <= dest <= len(view) - count, (
            f"move dest {dest} out of range for the post-detach sequence"
        )
        cells = view[index : index + count]
        if dest == index:
            return
        if dest < index:
            change = [
                M.skip(dest), M.move_in(0, count),
                M.skip(index - dest), M.move_out(0, cells),
            ]
        else:
            change = [
                M.skip(index), M.move_out(0, cells),
                M.skip(dest - index), M.move_in(0, count),
            ]
        self._author(change)

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self, msg: SequencedDocumentMessage, local: bool, local_metadata: Optional[Any]
    ) -> None:
        marks = [_decode_mark(t, v) for t, v in msg.contents["marks"]]
        commit = Commit(
            session=msg.client_id,
            seq=msg.sequence_number,
            ref=msg.reference_sequence_number,
            change=marks,
        )
        if local or msg.client_id == self._em.session:
            # Own echoes adjust inflight bookkeeping — integrate in order.
            self._drain()
            self._em.add_sequenced(commit)
            self._em._count_host("own_session")
            self._em.advance_min_seq(msg.minimum_sequence_number)
            self._ingest_min_seq = msg.minimum_sequence_number
        else:
            self._ingest_buf.append(commit)
            self._ingest_min_seq = msg.minimum_sequence_number

    # -- resubmit: squash the pending delta against the current trunk ---------

    def begin_resubmit(self) -> None:
        self._squashed = False

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        """All pending local edits resubmit as one squashed changeset: the
        id-diff of the local view against the trunk tip (both concrete, so
        the rebased positions are exact by construction)."""
        if self._squashed:
            return
        self._squashed = True
        self._drain()
        from fluidframework_tpu_torch.tree.edit_manager import _diff_cells

        trunk = self._em.trunk_state
        view = self._em.local_view()
        view_ids = {c[0] for c in view}
        deleted = {c[0] for c in trunk if c[0] not in view_ids}
        change = _diff_cells(trunk, view, deleted)
        if change:
            self._em.reset_inflight(1)
            self.submit_local_message({"marks": change})
        else:
            self._em.reset_inflight(0)

    def end_resubmit(self) -> None:
        self._squashed = False

    # -- summary / load -------------------------------------------------------

    def summarize_core(self) -> dict:
        self._drain()
        assert self._em.inflight == 0, "summarize with pending local edits"
        return {
            "cells": [[i, v] for i, v in self._em.trunk_state],
            "seq": self._em.trunk_seq,
        }

    def load_core(self, summary: dict) -> None:
        self._ingest_buf.clear()
        self._em = EditManager(self.client_id, device=self.device)
        self._em.trunk_state = [(int(i), v) for i, v in summary["cells"]]
        self._em.view_state = list(self._em.trunk_state)
        self._em.trunk_seq = summary["seq"]
