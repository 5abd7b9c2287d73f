"""Carry state from the reference package to the port.

The reference's state crosses as numpy arrays (the caller fetches them
with ``np.asarray`` on its side), so this module imports nothing of the
reference. Hand-over is exact: a service built here continues bit for bit
where the reference service stopped, given the same later inputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fluidframework_tpu_torch.ops.apply_kernel import N_LANES, N_SCALARS
from fluidframework_tpu_torch.ops.segment_state import (
    SegmentState,
    packed_views,
    to_host,
)
from fluidframework_tpu_torch.parallel.fleet import DocFleet
from fluidframework_tpu_torch.parallel.mesh import (
    DocShard,
    Mesh,
    gather_parts,
    shard_state,
)
from fluidframework_tpu_torch.parallel.sharded_doc import ShardedDoc
from fluidframework_tpu_torch.ops.tree_kernel import DenseChange
from fluidframework_tpu_torch.service.fleet_service import TpuFleetService
from fluidframework_tpu_torch.tree.device_em import EmCommitBatch
from fluidframework_tpu_torch.tree.device_trunk import CommitBatch
from fluidframework_tpu_torch.utils import resolve_device


def state_from_numpy(tables, scalars, device="cuda"):
    """Packed (tables [N_LANES, D, S], scalars [D, N_SCALARS]) int32 numpy
    arrays -> the same state as contiguous int32 tensors on ``device``
    (always a copy)."""
    dev = resolve_device(device)
    t = np.asarray(tables)
    s = np.asarray(scalars)
    if t.ndim != 3 or t.shape[0] != N_LANES:
        raise ValueError(f"tables must be [{N_LANES}, D, S], got {t.shape}")
    if s.shape != (t.shape[1], N_SCALARS):
        raise ValueError(f"scalars must be [{t.shape[1]}, {N_SCALARS}], "
                         f"got {s.shape}")
    if t.dtype != np.int32 or s.dtype != np.int32:
        raise ValueError("packed state must be int32")
    return (torch.tensor(t, device=dev).contiguous(),
            torch.tensor(s, device=dev).contiguous())


def segment_state_from_numpy(arrays, device="cuda") -> SegmentState:
    """A reference ``SegmentState`` read as numpy arrays (its 20 fields in
    order: 15 lanes [S] or [D, S], then count, min_seq, cur_seq,
    self_client, err as 0-d or [D]) -> the port's state, packed, on
    ``device`` (one copy)."""
    arrays = [np.asarray(x, np.int32) for x in arrays]
    if len(arrays) != len(SegmentState._fields):
        raise ValueError(f"a SegmentState has {len(SegmentState._fields)} "
                         f"fields, got {len(arrays)}")
    single = arrays[0].ndim == 1
    tables = np.stack(arrays[:N_LANES])
    sc = np.stack(arrays[N_LANES:], axis=-1)
    if single:
        tables, sc = tables[:, None], sc[None]
    scalars = np.zeros((tables.shape[1], N_SCALARS), np.int32)
    scalars[:, : sc.shape[1]] = sc
    return packed_views(*state_from_numpy(tables, scalars, device), single)


def segment_state_to_numpy(state) -> tuple:
    """A port ``SegmentState`` -> its 20 fields as host numpy copies in
    field order (the reference's ``SegmentState`` takes them
    positionally)."""
    return tuple(np.array(x, np.int32) for x in to_host(state))


def service_from_reference_arrays(
    tables,
    scalars,
    doc_state,
    clients,
    summarized_seq,
    device="cuda",
    *,
    compact_every: int = 1,
    rounds_applied: int = 0,
    lane_set: Optional[Sequence[int]] = None,
    lane_idle=None,
    wire_widths: Optional[Sequence[int]] = None,
) -> TpuFleetService:
    """A port ``TpuFleetService`` holding the reference service's state:
    the packed device tables/scalars, the sequencer's ``doc_state`` [D, 2]
    and ``clients`` [D, W, 3], and the scribe watermark ``summarized_seq``
    [D]. The keyword arguments carry the service's adaptive state —
    compaction cadence position, the scribe's shipped lane set and idle
    ages, and the op wire's sticky field widths — so later rounds and
    sweeps take the same paths as the reference would. Earlier summaries
    stay in the reference's store."""
    t = np.asarray(tables)
    svc = TpuFleetService(
        t.shape[1], capacity=t.shape[2], compact_every=compact_every,
        device=device,
    )
    svc.tables, svc.scalars = state_from_numpy(t, scalars, device)
    svc.fseq.doc_state[:] = np.asarray(doc_state, np.int32)
    svc.fseq.clients[:] = np.asarray(clients, np.int32)
    svc._summarized_seq[:] = np.asarray(summarized_seq, np.int64)
    svc.rounds_applied = rounds_applied
    if lane_set is not None:
        svc._lane_set = tuple(int(i) for i in lane_set)
    if lane_idle is not None:
        svc._lane_idle[:] = np.asarray(lane_idle, np.int32)
    if wire_widths is not None:
        svc._wire_widths = tuple(int(w) for w in wire_widths)
    return svc


def fleet_from_reference(
    pools: Dict[int, tuple],
    placement,
    *,
    base_capacity: int,
    high_water: float = 0.75,
    low_water: float = 0.2,
    max_capacity: int = 1 << 16,
    migrations: int = 0,
    demotions: int = 0,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> DocFleet:
    """A port ``DocFleet`` in the state of a reference ``DocFleet``.

    ``pools`` maps each capacity, in the reference's pool order, to
    ``(state, doc_of_slot, slot_gen, free)`` read off the reference pool:
    ``state`` is its SegmentState as numpy arrays (15 lanes [n_slots, S],
    then count, min_seq, cur_seq, self_client, err [n_slots]) and ``free``
    its slot free-list (``pool._free``), so slots are handed out in the
    reference's order. ``placement`` is the reference's per-doc
    ``(cap, slot)`` or ``None`` (evicted). With ``mesh`` (the reference
    fleet's mesh read as global arrays) each pool splits into the port's
    per-shard tensors."""
    return DocFleet.from_pools(
        {cap: (*_packed(state), doc_of_slot, slot_gen, free)
         for cap, (state, doc_of_slot, slot_gen, free) in pools.items()},
        placement, base_capacity=base_capacity, high_water=high_water,
        low_water=low_water, max_capacity=max_capacity,
        migrations=migrations, demotions=demotions,
        device=None if mesh is not None else device, mesh=mesh,
    )


def _packed(state):
    """20 SegmentState fields as numpy (15 lanes [D, S], 5 scalars [D]) ->
    a packed host pair of tensors."""
    arrays = [np.asarray(x, np.int32) for x in state]
    scalars = np.zeros((arrays[0].shape[0], N_SCALARS), np.int32)
    scalars[:, : len(arrays) - N_LANES] = np.stack(arrays[N_LANES:], 1)
    return (torch.from_numpy(np.stack(arrays[:N_LANES])),
            torch.from_numpy(scalars))


# -- mesh-sharded state ---------------------------------------------------------
#
# A mesh-sharded reference state crosses as its global arrays (the 20
# SegmentState fields as numpy, the document or shard axis first); the port
# splits them into per-shard tensors, and reads them back as one array.


def doc_shard_from_reference(state, mesh: Mesh,
                             kernel: str = "auto") -> DocShard:
    """A port ``DocShard`` holding a reference ``DocShard``'s state (its
    ``state`` or ``unpacked_state()`` as 20 numpy fields [D, ...])."""
    t, s = _packed(state)
    shard = DocShard(t.shape[1], t.shape[2], mesh=mesh, kernel=kernel)
    shard.parts = shard_state(t, s, mesh)
    return shard


def sharded_doc_from_reference(state, mesh: Mesh,
                               kernel: str = "auto") -> ShardedDoc:
    """A port ``ShardedDoc`` holding a reference ``ShardedDoc``'s state
    (20 numpy fields, lanes [n_shards, shard_cap])."""
    fields = [np.asarray(x, np.int32) for x in state]
    doc = ShardedDoc(fields[0].shape[1], mesh=mesh,
                     self_client=int(fields[N_LANES + 3][0]), kernel=kernel)
    doc.load_state(fields)
    return doc


def mesh_state_to_numpy(obj) -> tuple:
    """The 20 SegmentState fields of a port ``DocShard``, fleet pool or
    ``ShardedDoc`` as one host numpy array each (its per-shard tensors
    concatenated shard-major, as the reference's global arrays read)."""
    if isinstance(obj, ShardedDoc):
        return tuple(np.asarray(x, np.int32) for x in obj.state)
    t, s = gather_parts(obj.parts, obj.parts[0][0].device)
    t = t.to("cpu", copy=True).numpy()
    s = s.to("cpu", copy=True).numpy()
    return tuple(t) + tuple(s[:, j] for j in range(len(SegmentState._fields)
                                                  - N_LANES))


# -- SharedTree dense IR ------------------------------------------------------
#
# The reference's ``DenseChange``, ``CommitBatch`` and ``EmCommitBatch`` are
# NamedTuples of arrays in the same field order as the port's; they cross as
# a sequence of numpy lanes (None for an absent optional move lane).


def _lanes_to(cls, lanes, device):
    dev = resolve_device(device)
    lanes = list(lanes)
    if len(lanes) != len(cls._fields):
        raise ValueError(f"{cls.__name__} has {len(cls._fields)} lanes, "
                         f"got {len(lanes)}")
    return cls(*[
        None if x is None
        else torch.tensor(np.asarray(x, np.int32), device=dev)
        for x in lanes
    ])


def _lanes_from(batch) -> tuple:
    return tuple(None if x is None else x.to("cpu", copy=True).numpy()
                 for x in batch)


def dense_change_from_numpy(lanes, device="cuda") -> DenseChange:
    """Reference ``DenseChange`` lanes (numpy, [N, ...]) -> the port's."""
    return _lanes_to(DenseChange, lanes, device)


def commit_batch_from_numpy(lanes, device="cuda") -> CommitBatch:
    """Reference ``CommitBatch`` lanes (numpy, [N, C, ...]) -> the port's."""
    return _lanes_to(CommitBatch, lanes, device)


def em_commit_batch_from_numpy(lanes, device="cuda") -> EmCommitBatch:
    """Reference ``EmCommitBatch`` lanes (numpy, [N, C, ...]) -> the
    port's."""
    return _lanes_to(EmCommitBatch, lanes, device)


def tree_lanes_to_numpy(batch) -> tuple:
    """A port ``DenseChange``, ``CommitBatch`` or ``EmCommitBatch`` -> its
    lanes as host numpy copies in field order (the reference's NamedTuple
    takes them positionally)."""
    return _lanes_from(batch)
