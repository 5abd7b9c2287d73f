"""Struct-of-arrays document state for the merge kernels, as torch tensors.

Counterpart of ``fluidframework_tpu/ops/segment_state.py``: one document is
a dense int32 table of segment rows in document order; every per-segment
stamp of the reference merge-tree (``seq``, ``clientId``, ``localSeq``,
``removedSeq``, ``removedClientIds``, ``localRemovedSeq``) is one int32
lane. Segment text lives host-side, keyed by ``orig``; a row covers
``payload[orig][off : off + length]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    MAX_WRITERS,
    RSEQ_NONE,
)
from fluidframework_tpu_torch.utils import resolve_device

_I32 = torch.int32


class SegmentState(NamedTuple):
    """One document's merge state (or a [D, ...] batch). Fields are torch
    tensors on the device, or numpy arrays once read back to the host."""

    # --- per-segment lanes [S] ---
    kind: object  # KIND_FREE / KIND_TEXT / KIND_MARKER
    orig: object  # host content id
    off: object  # offset into the orig payload
    length: object  # segment length (chars)
    seq: object  # insert seq (UNASSIGNED_SEQ while local)
    client: object  # inserting client slot
    lseq: object  # local seq of pending insert (0 = none)
    rseq: object  # removedSeq (RSEQ_NONE = not removed, UNASSIGNED_SEQ = local)
    rlseq: object  # local seq of pending remove (0 = none)
    rbits: object  # bitmask of removing client slots 0-30
    rbits2: object  # bitmask of removing client slots 31-61
    rbits3: object  # bitmask of removing client slots 62-92
    aseq: object  # seq of last annotate (0 = never)
    alseq: object  # local seq of pending annotate (0 = none)
    aval: object  # interned annotate value
    # --- per-document scalars ---
    count: object  # high-water mark of used rows
    min_seq: object  # collab-window minimum sequence number
    cur_seq: object  # last applied sequence number
    self_client: object  # local client slot (NO_CLIENT on the server)
    err: object  # ERR_* flag bits (sticky)


# Lane order of the packed [N_LANES, D, S] tables; every packed index in
# the kernels (and in csrc/merge_kernels.cu) derives from it.
SEGMENT_LANES = (
    "kind",
    "orig",
    "off",
    "length",
    "seq",
    "client",
    "lseq",
    "rseq",
    "rlseq",
    "rbits",
    "rbits2",
    "rbits3",
    "aseq",
    "alseq",
    "aval",
)

# Value a free row holds in each lane (every lane not listed is 0).
LANE_FILLS = {"kind": KIND_FREE, "rseq": RSEQ_NONE}


def make_state(
    capacity: int, self_client: int, min_seq: int = 0, device="cuda"
) -> SegmentState:
    """Fresh empty document state with room for ``capacity`` segment rows."""
    batch = make_batched_state(
        1, capacity, self_client, device=device, min_seq=min_seq
    )
    return SegmentState(*[x[0] for x in batch])


def make_batched_state(
    n_docs: int, capacity: int, self_client: int, device="cuda",
    min_seq: int = 0,
) -> SegmentState:
    """[D, S] batch of empty documents."""
    dev = resolve_device(device)
    lanes = {
        k: torch.full((n_docs, capacity), LANE_FILLS.get(k, 0), dtype=_I32,
                      device=dev)
        for k in SEGMENT_LANES
    }

    def scalar(v):
        return torch.full((n_docs,), v, dtype=_I32, device=dev)

    return SegmentState(
        **lanes,
        count=scalar(0),
        min_seq=scalar(min_seq),
        cur_seq=scalar(0),
        self_client=scalar(self_client),
        err=scalar(0),
    )


def removed_by_slot(rbits, rbits2, rbits3, client):
    """Whether the writer slot appears in the three-lane removers bitmask
    (slots 0-30 / 31-61 / 62-92; 31 usable bits per int32 lane). Out-of-
    range slots (negative sentinels, >= MAX_WRITERS) read as not removed.
    ``client`` broadcasts against the bitmask lanes."""
    client = torch.as_tensor(client, dtype=_I32, device=rbits.device)
    lane = torch.clamp(torch.div(client, 31, rounding_mode="floor"), 0, 2)
    bits = torch.where(lane == 0, rbits, torch.where(lane == 1, rbits2, rbits3))
    shift = torch.clamp(client - 31 * lane, 0, 30)
    in_range = (client >= 0) & (client < MAX_WRITERS)
    return (((bits >> shift) & 1) == 1) & in_range


def writer_bits(slot):
    """(lo, mid, hi) single-bit masks for a writer slot: slots 0-30 set a
    bit in ``rbits``, 31-61 in ``rbits2``, 62-92 in ``rbits3``. A negative
    slot lands on bit 0 of ``rbits``, exactly as the reference computes it."""
    s = torch.as_tensor(slot, dtype=_I32)
    one = torch.ones_like(s)
    zero = torch.zeros_like(s)
    lo = torch.where(s < 31, one << torch.clamp(s, 0, 30), zero)
    mid = torch.where((s >= 31) & (s < 62),
                      one << torch.clamp(s - 31, 0, 30), zero)
    hi = torch.where(s >= 62, one << torch.clamp(s - 62, 0, 30), zero)
    return lo, mid, hi


def to_host(state: SegmentState) -> SegmentState:
    """Pull a state to host numpy for materialization/tests."""
    return SegmentState(*[
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in state
    ])


def materialize(state: SegmentState, payloads: dict) -> str:
    """Join live, locally-visible rows of one document into its text (the
    local perspective: any removal, acked or pending, hides the segment)."""
    h = to_host(state)
    parts = []
    for i in range(int(h.count)):
        if int(h.kind[i]) == KIND_FREE:
            continue
        if int(h.rseq[i]) != RSEQ_NONE:
            continue
        o, f, n = int(h.orig[i]), int(h.off[i]), int(h.length[i])
        parts.append(payloads[o][f : f + n])
    return "".join(parts)
