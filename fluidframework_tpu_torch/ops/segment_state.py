"""Struct-of-arrays document state for the merge kernels, as torch tensors.

Counterpart of ``fluidframework_tpu/ops/segment_state.py``: one document is
a dense int32 table of segment rows in document order; every per-segment
stamp of the reference merge-tree (``seq``, ``clientId``, ``localSeq``,
``removedSeq``, ``removedClientIds``, ``localRemovedSeq``) is one int32
lane. Segment text lives host-side, keyed by ``orig``; a row covers
``payload[orig][off : off + length]``.

A state can be *packed*: its lanes and scalars are views of one pair of
contiguous int32 tensors, ``tables [N_LANES, D, S]`` and ``scalars [D,
N_SCALARS]`` (:func:`packed_views`), the layout the kernels take. The
client path keeps its one-document states packed between ops, so the
kernels update them in place and a host read is one copy of the pair.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fluidframework_tpu_torch.protocol.constants import (
    KIND_FREE,
    MAX_WRITERS,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
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
# Columns of the packed scalars [D, N_SCALARS] (the rest are 0 padding).
SCALAR_FIELDS = ("count", "min_seq", "cur_seq", "self_client", "err")
N_SCALARS = 8


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


def make_interactive_state(
    capacity: int, self_client: int, min_seq: int = 0, device="cuda"
) -> SegmentState:
    """A packed one-document state for per-op interactive applies (a
    client DDS's replica): :func:`packed_views` of a fresh
    ``tables [N_LANES, 1, capacity]`` / ``scalars [1, N_SCALARS]`` pair on
    ``device``. The reference pins this state to its host CPU backend;
    here it lives on the card unless the caller names the CPU."""
    return interactive_state_from_rows(capacity, self_client, {}, 0, min_seq,
                                       0, device)


def interactive_state_from_rows(
    capacity: int, self_client: int, rows: dict, count: int, min_seq: int,
    cur_seq: int, device="cuda",
) -> SegmentState:
    """A packed one-document state whose first ``count`` rows hold
    ``rows`` (lane name -> ``count`` values; lanes not named stay free),
    built on the host and uploaded in one copy (a summary's load)."""
    dev = resolve_device(device)
    t = np.empty((len(SEGMENT_LANES), 1, capacity), np.int32)
    for i, k in enumerate(SEGMENT_LANES):
        t[i] = LANE_FILLS.get(k, 0)
    for k, vals in rows.items():
        t[SEGMENT_LANES.index(k), 0, :count] = vals
    s = np.zeros((1, N_SCALARS), np.int32)
    s[0, : len(SCALAR_FIELDS)] = [count, min_seq, cur_seq, self_client, 0]
    return packed_views(torch.from_numpy(t).to(dev),
                        torch.from_numpy(s).to(dev), single=True)


def packed_views(tables, scalars, single: bool = False) -> SegmentState:
    """The state whose fields are views of the packed pair: lanes
    ``tables[i]`` [D, S] and scalars ``scalars[:, j]`` [D], or with
    ``single`` (D == 1) lanes [S] and 0-d scalars."""
    if single:
        return SegmentState(
            *[tables[i, 0] for i in range(len(SEGMENT_LANES))],
            *[scalars[0, j] for j in range(len(SCALAR_FIELDS))],
        )
    return SegmentState(
        *[tables[i] for i in range(len(SEGMENT_LANES))],
        *[scalars[:, j] for j in range(len(SCALAR_FIELDS))],
    )


def _views_of(fields, base, single: bool) -> bool:
    """Whether ``fields`` are, in order, the views :func:`packed_views`
    takes of ``base`` (the tables along axis 0, the scalars along axis 1),
    checked by pointer, shape and stride without indexing."""
    ptr, es, st = base.data_ptr(), base.element_size(), base.stride()
    if base.dim() == 3:
        step = st[0]
        shape, stride = ((base.shape[2],), (st[2],)) if single else (
            tuple(base.shape[1:]), st[1:])
    else:
        step = st[1]
        shape, stride = ((), ()) if single else ((base.shape[0],),
                                                  (st[0],))
    for i, x in enumerate(fields):
        if (not isinstance(x, torch.Tensor) or x._base is not base
                or x.data_ptr() != ptr + i * step * es
                or tuple(x.shape) != shape or x.stride() != stride):
            return False
    return True


def packed_of(state: SegmentState):
    """The (tables, scalars) pair a packed state views, or None when its
    fields are separate tensors (or host arrays)."""
    lanes = state[: len(SEGMENT_LANES)]
    scal = state[len(SEGMENT_LANES):]
    t = getattr(lanes[0], "_base", None)
    s = getattr(scal[0], "_base", None)
    if t is None or s is None:
        return None
    if (t.dim() != 3 or t.shape[0] != len(SEGMENT_LANES)
            or not t.is_contiguous() or s.dim() != 2
            or s.shape != (t.shape[1], N_SCALARS) or not s.is_contiguous()):
        return None
    single = lanes[0].dim() == 1
    if single and t.shape[1] != 1:
        return None
    if not (_views_of(lanes, t, single) and _views_of(scal, s, single)):
        return None
    return t, s


def to_packed(state: SegmentState, pair=None):
    """(tables, scalars, single): the pair a packed state views (no copy;
    ``pair`` is its :func:`packed_of` where the caller has it), or a
    packed copy of a state held as separate tensors."""
    single = state.kind.dim() == 1
    pair = pair if pair is not None else packed_of(state)
    if pair is not None:
        return pair[0], pair[1], single
    lanes = torch.stack([torch.as_tensor(getattr(state, k))
                         for k in SEGMENT_LANES]).to(_I32)
    sc = [torch.as_tensor(getattr(state, k)).to(lanes.device)
          for k in SCALAR_FIELDS]
    sc = torch.stack(sc + [torch.zeros_like(sc[0])]
                     * (N_SCALARS - len(sc)), dim=-1).to(_I32)
    if single:
        lanes, sc = lanes[:, None], sc[None]
    return lanes.contiguous(), sc.contiguous(), single


def capacity_of(state: SegmentState) -> int:
    return state.kind.shape[-1]


def grow(state: SegmentState, new_capacity: int) -> SegmentState:
    """Reallocate a state with a larger segment table (new rows free),
    returned packed on the state's device. On the card a table above the
    kernels' largest tier (2**30 rows per document, the split tier's int
    row indices) raises ``ValueError``: no kernel could apply an op to it,
    and the state never moves to the CPU behind the caller's back. A
    table the card cannot hold fails at allocation, with PyTorch's
    out-of-memory error."""
    cap = capacity_of(state)
    assert new_capacity > cap, "grow() requires a larger capacity"
    t, s, single = to_packed(state)
    if t.device.type == "cuda":
        from fluidframework_tpu_torch.ops import _cuda

        if new_capacity > _cuda.MAX_CAPACITY:
            raise ValueError(
                f"grow: a table of {new_capacity} rows exceeds the "
                f"kernels' largest tier ({_cuda.MAX_CAPACITY} rows per "
                "document); the document is too large for the card"
            )
    nt = torch.empty(t.shape[:2] + (new_capacity,), dtype=_I32,
                     device=t.device)
    nt[..., :cap] = t
    for i, k in enumerate(SEGMENT_LANES):
        nt[i, :, cap:] = LANE_FILLS.get(k, 0)
    return packed_views(nt, s.clone(), single)


def removed_by_slot_host(rbits: int, rbits2: int, rbits3: int,
                         client: int) -> bool:
    """Host-int twin of :func:`removed_by_slot` for per-row Python loops
    (the same slot layout)."""
    if client < 0 or client >= MAX_WRITERS:
        return False
    if client < 31:
        return bool((rbits >> client) & 1)
    if client < 62:
        return bool((rbits2 >> (client - 31)) & 1)
    return bool((rbits3 >> (client - 62)) & 1)


def adopt_client_slot(state: SegmentState, new_client_id: int) -> SegmentState:
    """Adopt a new connection's client slot after reconnect, in place.

    Pending rows restamp from the old slot to the new one: client slots
    recycle, and rows that exist only on this replica (unacked local
    inserts / removes) would otherwise satisfy the kernel's own-insert
    fast path (``client == clientn``) or the removers bitmask for the
    slot's next holder. Updates the lanes where they lie (a packed state
    stays packed) and returns the state."""
    pending_ins = state.seq == UNASSIGNED_SEQ
    pending_rem = state.rlseq > 0
    old = writer_bits(state.self_client)
    new = [int(b) for b in writer_bits(new_client_id)]
    state.client.copy_(torch.where(pending_ins, new_client_id, state.client))
    for lane, o, n in zip((state.rbits, state.rbits2, state.rbits3), old,
                          new):
        lane.copy_(torch.where(pending_rem, (lane & ~o.to(lane.device)) | n,
                               lane))
    state.self_client.fill_(new_client_id)
    return state


def restamp_rows(state: SegmentState, lane: str, rows, value) -> SegmentState:
    """Set ``lane`` to ``value`` on the listed rows of a one-document state
    (resubmit bookkeeping), by indexed assignment on the state's device,
    in place; ``value`` is one int or one per row. Returns the state."""
    arr = getattr(state, lane)
    idx = torch.as_tensor(list(rows), dtype=torch.long)
    if isinstance(value, int):
        arr[idx.to(arr.device)] = value
    else:
        arr[idx.to(arr.device)] = torch.as_tensor(
            list(value), dtype=_I32).to(arr.device)
    return state


def to_host(state: SegmentState) -> SegmentState:
    """Pull a state to host numpy copies for materialization/tests. A
    packed state crosses as one copy of its pair."""
    pair = packed_of(state) if isinstance(state.kind, torch.Tensor) else None
    if pair is not None:
        t, s = pair
        flat = torch.cat([t.reshape(-1), s.reshape(-1)]).cpu().numpy()
        nt = flat[: t.numel()].reshape(t.shape)
        ns = flat[t.numel():].reshape(s.shape)
        single = state.kind.dim() == 1
        return SegmentState(
            *[nt[i, 0] if single else nt[i]
              for i in range(len(SEGMENT_LANES))],
            *[ns[0, j:j + 1].reshape(()) if single else ns[:, j]
              for j in range(len(SCALAR_FIELDS))],
        )
    return SegmentState(*[
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in state
    ])


def materialize(state: SegmentState, payloads: dict) -> str:
    """Join live, locally-visible rows of one document into its text (the
    local perspective: any removal, acked or pending, hides the segment)."""
    h = to_host(state)
    n = int(h.count)
    live = np.nonzero((h.kind[:n] != KIND_FREE)
                      & (h.rseq[:n] == RSEQ_NONE))[0]
    return "".join(
        payloads[o][f : f + ln]
        for o, f, ln in zip(h.orig[live].tolist(), h.off[live].tolist(),
                            h.length[live].tolist())
    )
