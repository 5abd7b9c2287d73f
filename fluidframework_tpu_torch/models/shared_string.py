"""SharedString — collaborative text DDS backed by the merge kernel.

Reference: ``packages/dds/sequence/src/sharedString.ts`` +
``packages/dds/merge-tree/src/client.ts`` (``applyMsg`` :858, local-op
``insertSegmentLocal``, ack :641). The TPU design splits responsibilities:
merge structure lives device-side in a :class:`SegmentState` table; segment
payload text lives host-side keyed by an ``orig`` content id (allocated per
local op as ``client_slot * 2^20 + lseq``), so device rows never carry bytes.

Ops lower to int32 kernel rows (``ops.encode``); the local echo applies
immediately with the UNASSIGNED seq sentinel, acks stamp server seqs by
``lseq``, remote ops apply at their ``(refSeq, client)`` perspective —
exactly the reference's applyMsg trichotomy.

Counterpart of ``fluidframework_tpu/models/shared_string.py``. The segment
table is a packed one-document state on the string's device (the card
unless the caller names the CPU): every local and sequenced op is one K1
launch on it, in place (``ops/merge_kernel.py``), and the table is
compacted by K2 when it fills and grows when compaction is not enough, at
the same ops as in the reference. Deciding that needs the table's row
count, which the reference reads back after every op; here a host upper
bound (an op adds at most two rows: an insert splits one row and adds one,
a range op splits at both ends) stands in for it until it passes
``cap - 8``, and only then is the count read back. Host reads (the text,
annotations, interval positions, summaries) copy the packed pair once.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops.merge_kernel import compact, jit_apply_ops
from fluidframework_tpu_torch.ops.segment_state import (
    adopt_client_slot,
    capacity_of,
    grow,
    interactive_state_from_rows,
    make_interactive_state,
    materialize,
    restamp_rows,
    to_host,
)
from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject
from fluidframework_tpu_torch.runtime.rebase import (
    regen_annotate,
    regen_insert,
    regen_remove,
)
from fluidframework_tpu_torch.utils import resolve_device

# Rows one op can add to the table: an insert splits a row and adds one; a
# remove or annotate splits at both ends of its range.
MAX_ROWS_PER_OP = 2

# Content ids: conn_no * stride + per-connection mint counter. Scoped to the
# never-recycled connection ordinal — client slots recycle, and a recycled
# slot must not overwrite the previous holder's still-live payloads.
_MINT_STRIDE = 1 << 14


def _delta_from_contents(c: dict) -> dict:
    """Decode wire op contents to a delta dict — the single place the
    SharedString wire keys are spelled out (consumed by both the kernel-row
    lowering and remote sequenceDelta events)."""
    if c["k"] == "ins":
        return {"kind": "insert", "pos": c["pos"], "text": c["text"],
                "orig": c["orig"]}
    if c["k"] == "rem":
        return {"kind": "remove", "start": c["start"], "end": c["end"],
                "removed": None}
    if c["k"] == "ann":
        return {"kind": "annotate", "start": c["start"], "end": c["end"],
                "val": c["val"], "previous": None}
    raise ValueError(f"unknown SharedString op {c!r}")


def row_from_wire(
    contents: dict, *, seq: int, ref: int, client: int, msn: int,
    payloads: dict,
) -> Optional[np.ndarray]:
    """Lower sequenced SharedString wire contents to one kernel op row —
    the shared decode used by client replicas (``process_core``) and the
    service-side device stage (``service/device_backend.py``), so both
    apply byte-identical rows. Inserts record their payload text; returns
    None for non-kernel ops (interval-collection bodies)."""
    k = contents.get("k")
    common = dict(seq=seq, ref=ref, client=client, msn=msn)
    if k == "ins":
        payloads[contents["orig"]] = contents["text"]
        return E.insert(
            contents["pos"], contents["orig"], len(contents["text"]),
            **common,
        )
    if k == "rem":
        return E.remove(contents["start"], contents["end"], **common)
    if k == "ann":
        return E.annotate(
            contents["start"], contents["end"], contents["val"], **common
        )
    return None


class SharedString(SharedObject):
    """Collaborative sequence of text with LWW annotations (single lane).
    Its segment table lives on ``device``: the card by default (raises
    without one), the CPU (K1/K2's plain versions) when named."""

    def __init__(self, channel_id: str, capacity: int = 256, device="cuda"):
        super().__init__(channel_id)
        self._capacity = capacity
        self._device = resolve_device(device)
        self._state = None  # created on attach (needs client slot)
        self._count_hi = 0  # host upper bound on the table's row count
        self._payloads: dict = {}
        self._lseq = 0
        self._mint = 0  # per-connection content-id counter
        self._interval_collections: dict = {}
        self._local_refs: list = []

    def _mint_orig(self) -> int:
        self._mint += 1
        assert self._mint < _MINT_STRIDE, (
            "per-connection content-id space exhausted; reconnect to refresh"
        )
        return self.conn_no * _MINT_STRIDE + self._mint

    def attach(self, runtime) -> None:
        super().attach(runtime)
        self._state = make_interactive_state(
            self._capacity, self.client_id, device=self._device)
        self._count_hi = 0

    # -- reads ----------------------------------------------------------------

    def get_text(self) -> str:
        return materialize(self._state, self._payloads)

    def __len__(self) -> int:
        return len(self.get_text())

    def annotations(self) -> list:
        """[(start, end, value)] runs of the annotation lane over live text."""
        h = to_host(self._state)
        runs = []
        pos = 0
        for i in range(int(h.count)):
            if int(h.kind[i]) == KIND_FREE or int(h.rseq[i]) != RSEQ_NONE:
                continue
            n, v = int(h.length[i]), int(h.aval[i])
            if v != 0:
                if runs and runs[-1][1] == pos and runs[-1][2] == v:
                    runs[-1] = (runs[-1][0], pos + n, v)
                else:
                    runs.append((pos, pos + n, v))
            pos += n
        return runs

    @property
    def err_flags(self) -> int:
        return int(self._state.err)

    def _host_view(self):
        return to_host(self._state)

    # -- local references / interval collections ------------------------------

    def create_local_reference(self, pos: int, bias: str = "fwd"):
        """A position reference that survives concurrent edits and slides on
        acked remove (reference ``localReference.ts:142``). Resolve with
        ``ref.position(string._host_view())``."""
        from fluidframework_tpu_torch.models.interval_collection import (
            LocalReference,
            anchor_from_pos,
        )

        ref = LocalReference(anchor_from_pos(self._host_view(), pos), bias=bias)
        self._local_refs.append(ref)
        return ref

    def ref_position(self, ref) -> int:
        return ref.position(self._host_view())

    def get_interval_collection(self, label: str):
        """Named interval collection (reference
        ``sequence.ts getIntervalCollection``), created lazily."""
        from fluidframework_tpu_torch.models.interval_collection import (
            IntervalCollection,
        )

        col = self._interval_collections.get(label)
        if col is None:
            col = self._interval_collections[label] = IntervalCollection(
                label, self
            )
        return col

    def _submit_interval_op(self, label: str, body: dict) -> None:
        self.submit_local_message(
            {"k": "ic", "label": label, "body": body},
            {"kind": "ic", "label": label, "body": body},
        )

    def remove_local_reference(self, ref) -> None:
        try:
            self._local_refs.remove(ref)
        except ValueError:
            pass

    def _normalize_refs(self) -> None:
        if not (self._interval_collections or self._local_refs):
            return
        h = self._host_view()
        for col in self._interval_collections.values():
            col.normalize_all(h)
        for ref in self._local_refs:
            ref.normalize(h)
        # Detached references never resolve again; stop paying for them.
        self._local_refs = [r for r in self._local_refs if not r.detached]

    # -- local edits ----------------------------------------------------------

    def insert_text(self, pos: int, text: str) -> None:
        assert len(text) > 0, "empty insert"
        self._lseq += 1
        orig = self._mint_orig()
        self._payloads[orig] = text
        row = E.insert(
            pos, orig, len(text), seq=UNASSIGNED_SEQ,
            client=self.client_id, lseq=self._lseq,
        )
        self._apply(row)
        self.submit_local_message(
            {"k": "ins", "pos": pos, "text": text, "orig": orig},
            {"kind": "insert", "lseq": self._lseq},
        )
        self.emit(
            "sequenceDelta",
            {"kind": "insert", "pos": pos, "text": text, "orig": orig},
            True,
        )

    def remove_range(self, start: int, end: int) -> None:
        # Removed text is only observable before the apply; capture it just
        # for listeners (undo-redo needs it, reference SequenceDeltaEvent).
        removed = (
            self.get_text()[start:end]
            if self.has_listeners("sequenceDelta")
            else None
        )
        self._lseq += 1
        row = E.remove(
            start, end, seq=UNASSIGNED_SEQ, client=self.client_id, lseq=self._lseq
        )
        self._apply(row)
        self.submit_local_message(
            {"k": "rem", "start": start, "end": end},
            {"kind": "remove", "lseq": self._lseq},
        )
        self.emit(
            "sequenceDelta",
            {"kind": "remove", "start": start, "end": end, "removed": removed},
            True,
        )

    def annotate(self, start: int, end: int, value: int) -> None:
        """Annotate a range with an interned int value (LWW single lane;
        PropertySet-keyed annotation is layered host-side in round 2)."""
        previous = (
            self._annotation_runs_in(start, end)
            if self.has_listeners("sequenceDelta")
            else None
        )
        self._lseq += 1
        row = E.annotate(
            start, end, value, seq=UNASSIGNED_SEQ,
            client=self.client_id, lseq=self._lseq,
        )
        self._apply(row)
        self.submit_local_message(
            {"k": "ann", "start": start, "end": end, "val": value},
            {"kind": "annotate", "lseq": self._lseq},
        )
        self.emit(
            "sequenceDelta",
            {"kind": "annotate", "start": start, "end": end, "val": value,
             "previous": previous},
            True,
        )

    def _annotation_runs_in(self, start: int, end: int) -> list:
        """[(s, e, value)] runs fully covering [start, end), value 0 for
        unannotated gaps — the exact inverse data an undo needs."""
        runs = []
        pos = start
        for s, e, v in self.annotations():
            s, e = max(s, start), min(e, end)
            if s >= e:
                continue
            if s > pos:
                runs.append((pos, s, 0))
            runs.append((s, e, v))
            pos = e
        if pos < end:
            runs.append((pos, end, 0))
        return runs

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        if local and local_metadata["kind"] == "ic":
            self.get_interval_collection(local_metadata["label"]).process(
                local_metadata["body"], msg, local=True
            )
            return
        if not local and msg.contents.get("k") == "ic":
            self.get_interval_collection(msg.contents["label"]).process(
                msg.contents["body"], msg, local=False
            )
            return
        if local:
            row = E.ack(
                local_metadata["kind"],
                local_metadata["lseq"],
                msg.sequence_number,
                msn=msg.minimum_sequence_number,
            )
        else:
            row = self._row_from_contents(msg)
        remote_delta = None
        if not local and self.has_listeners("sequenceDelta"):
            # Remote coordinates are in the sender's (refSeq, client)
            # perspective — resolving them against the local view is the
            # kernel's job, so remote events carry op coordinates only
            # (no removed-text/previous-value capture; undo-redo consumes
            # local events exclusively).
            remote_delta = _delta_from_contents(msg.contents)
        self._apply(row)
        if remote_delta is not None:
            self.emit("sequenceDelta", remote_delta, False)
        # Slide references eagerly once a removal is sequenced (A.9): the
        # remove just applied is acked, so anchors on it re-anchor before
        # compaction can reclaim the row.
        is_remove = (local and local_metadata["kind"] == "remove") or (
            not local and msg.contents["k"] == "rem"
        )
        if is_remove:
            self._normalize_refs()

    def _row_from_contents(self, msg: SequencedDocumentMessage) -> np.ndarray:
        row = row_from_wire(
            msg.contents,
            seq=msg.sequence_number,
            ref=msg.reference_sequence_number,
            client=msg.client_id,
            msn=msg.minimum_sequence_number,
            payloads=self._payloads,
        )
        if row is None:
            raise ValueError(f"unknown SharedString op {msg.contents!r}")
        return row

    def _apply(self, row: np.ndarray) -> None:
        self._state = jit_apply_ops(self._state, row[None, :].astype(np.int32))
        # Keep headroom: compact when the table is nearly full, growing if
        # the live rows genuinely outgrew it. Compaction timing is
        # replica-local and only touches invisible state, so replicas stay
        # convergent regardless of when each one compacts. The count is
        # read back only once its host bound passes the threshold, so the
        # decisions fall at the same ops as with a readback per op.
        self._count_hi += MAX_ROWS_PER_OP
        cap = capacity_of(self._state)
        if self._count_hi > cap - 8:
            self._count_hi = int(self._state.count)
        if self._count_hi > cap - 8:
            # References must slide off acked-removed rows before compaction
            # reclaims them (A.9 eager slide).
            self._normalize_refs()
            self._state = compact(self._state)
            self._count_hi = int(self._state.count)
            if self._count_hi > cap - 8:
                self._state = grow(self._state, cap * 2)

    # -- reconnect rebase (reference regeneratePendingOp, client.ts:917) ------

    def on_reconnect(self, new_client_id: int) -> None:
        """Adopt the new connection's client slot (see
        ``segment_state.adopt_client_slot`` for the restamp rationale)."""
        self._mint = 0  # content ids scope to the connection ordinal
        self._state = adopt_client_slot(self._state, new_client_id)

    def adopt_stashed_slot(self, old_client_id: int) -> None:
        self._state.self_client.fill_(old_client_id)

    def begin_resubmit(self) -> None:
        # All regenerations in one batch read the reconnect-time state;
        # restamps land on the live state without perturbing the view.
        self._rebase_view = to_host(self._state)

    def end_resubmit(self) -> None:
        self._rebase_view = None

    def _restamp(self, lane: str, rows: list, new_value) -> None:
        self._state = restamp_rows(self._state, lane, rows, new_value)

    def resubmit_core(self, contents: Any, local_metadata: Any) -> None:
        kind = local_metadata["kind"]
        if kind == "ic":
            self.get_interval_collection(local_metadata["label"]).resubmit(
                local_metadata["body"]
            )
            return
        L = local_metadata["lseq"]
        h = getattr(self, "_rebase_view", None) or to_host(self._state)
        if kind == "insert":
            runs = regen_insert(h, L)
            for run in runs:
                self._lseq += 1
                text = "".join(
                    self._payloads[int(h.orig[i])][
                        int(h.off[i]) : int(h.off[i]) + int(h.length[i])
                    ]
                    for i in run.rows
                )
                # Each run is a fresh wire insert and needs its own payload:
                # re-sending the original orig would make every replica
                # overwrite it with THIS run's text while other runs' rows
                # still slice it. Local rows restamp onto the new payload.
                orig = self._mint_orig()
                self._payloads[orig] = text
                self._restamp("lseq", run.rows, self._lseq)
                self._restamp("orig", run.rows, orig)
                offs = []
                off = 0
                for i in run.rows:
                    offs.append(off)
                    off += int(h.length[i])
                self._restamp("off", run.rows, offs)
                self.submit_local_message(
                    {"k": "ins", "pos": run.pos, "text": text, "orig": orig},
                    {"kind": "insert", "lseq": self._lseq},
                )
        elif kind == "remove":
            for run in regen_remove(h, L):
                self._lseq += 1
                self._restamp("rlseq", run.rows, self._lseq)
                self.submit_local_message(
                    {"k": "rem", "start": run.pos, "end": run.pos + run.span},
                    {"kind": "remove", "lseq": self._lseq},
                )
        elif kind == "annotate":
            for run in regen_annotate(h, L):
                self._lseq += 1
                self._restamp("alseq", run.rows, self._lseq)
                self.submit_local_message(
                    {
                        "k": "ann",
                        "start": run.pos,
                        "end": run.pos + run.span,
                        "val": contents["val"],
                    },
                    {"kind": "annotate", "lseq": self._lseq},
                )
        else:
            raise ValueError(f"unknown resubmit kind {kind!r}")

    # -- summary / load (round-1: full state snapshot) ------------------------

    def summarize_core(self) -> dict:
        h = to_host(self._state)
        n = int(h.count)
        return {
            "lanes": {k: np.asarray(getattr(h, k))[:n].tolist() for k in (
                "kind", "orig", "off", "length", "seq", "client", "lseq",
                "rseq", "rlseq", "rbits", "rbits2", "rbits3", "aseq",
                "alseq", "aval",
            )},
            "count": n,
            "min_seq": int(h.min_seq),
            "cur_seq": int(h.cur_seq),
            "payloads": dict(self._payloads),
            "intervals": {
                label: col.summarize()
                for label, col in sorted(self._interval_collections.items())
            },
        }

    def load_core(self, summary: dict) -> None:
        n = summary["count"]
        self._state = interactive_state_from_rows(
            max(self._capacity, n + 16), self.client_id, summary["lanes"], n,
            summary["min_seq"], summary["cur_seq"], device=self._device,
        )
        self._count_hi = n
        self._payloads = {int(k): v for k, v in summary["payloads"].items()}
        # A stashed-state snapshot may carry pending rows (unacked lseq
        # stamps): future local ops must not collide with them.
        lanes = summary["lanes"]
        self._lseq = max(
            [0]
            + list(lanes.get("lseq", []))
            + list(lanes.get("rlseq", []))
            + list(lanes.get("alseq", []))
        )
        for label, entries in summary.get("intervals", {}).items():
            self.get_interval_collection(label).load(entries)
