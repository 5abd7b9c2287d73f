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
from fluidframework_tpu_torch.parallel.fleet import DocFleet
from fluidframework_tpu_torch.service.fleet_service import TpuFleetService
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
) -> DocFleet:
    """A port ``DocFleet`` in the state of a reference ``DocFleet``.

    ``pools`` maps each capacity, in the reference's pool order, to
    ``(state, doc_of_slot, slot_gen, free)`` read off the reference pool:
    ``state`` is its SegmentState as numpy arrays (15 lanes [n_slots, S],
    then count, min_seq, cur_seq, self_client, err [n_slots]) and ``free``
    its slot free-list (``pool._free``), so slots are handed out in the
    reference's order. ``placement`` is the reference's per-doc
    ``(cap, slot)`` or ``None`` (evicted)."""

    def packed(state):
        arrays = [np.asarray(x, np.int32) for x in state]
        scalars = np.zeros((arrays[0].shape[0], N_SCALARS), np.int32)
        scalars[:, : len(arrays) - N_LANES] = np.stack(arrays[N_LANES:], 1)
        return (torch.from_numpy(np.stack(arrays[:N_LANES])),
                torch.from_numpy(scalars))

    return DocFleet.from_pools(
        {cap: (*packed(state), doc_of_slot, slot_gen, free)
         for cap, (state, doc_of_slot, slot_gen, free) in pools.items()},
        placement, base_capacity=base_capacity, high_water=high_water,
        low_water=low_water, max_capacity=max_capacity,
        migrations=migrations, demotions=demotions, device=device,
    )
