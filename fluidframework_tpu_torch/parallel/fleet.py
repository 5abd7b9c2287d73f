"""Capacity lifecycle for the document fleet: pooled blocks + promotion.

Counterpart of ``fluidframework_tpu/parallel/fleet.py``. The fleet is a set
of POOLS, one per capacity tier, each a packed ``[N_LANES, n_slots, S]``
table plus ``[n_slots, N_SCALARS]`` scalars held on the device in the layout
the kernels take (the reference packs and unpacks around every Pallas step;
the port keeps the packed form). A host-driven lifecycle step promotes hot
documents into the next tier BEFORE they overflow:

- after an applied batch the host reads the per-slot ``count`` column and
  promotes any doc above ``high_water * capacity`` into a free slot of the
  pool one tier up (capacity doubles per tier, up to ``max_capacity``);
- a doc whose live rows fell below ``low_water * capacity`` steps down one
  tier (after a compaction of its pool), and a doc can be evicted to a host
  copy and restored later into the tier its state has;
- the sticky err lane is still checked: ERR_CAPACITY means a doc grew
  faster than the tier headroom in one batch.

Every step runs K1 (``ops/apply_kernel.py``) and every compaction K2
(``ops/compact_kernel.py``) on the pool in place, at every tier: the
kernels' shared-memory tier up to 2,048 rows and their global-memory tier
from 4,096 to 65,536 rows. Promotion, demotion and eviction move lanes with
device-side ``index_select`` / ``index_copy_`` instead of the reference's
whole-pool host round trip; the result is the same bit for bit.

Not ported: the mesh (a pool sharded over several devices; ``mesh=``
raises) and ``parallel/aot.py`` — PyTorch runs eagerly, so
``sparse_step_aot`` and ``compact_aot`` run the same eager step under the
reference's names.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import compact_kernel as K2
from fluidframework_tpu_torch.ops.apply_kernel import (
    N_LANES,
    N_SCALARS,
    SC_COUNT,
    SC_CUR_SEQ,
    SC_ERR,
    SC_MIN_SEQ,
    SC_SELF,
    unpack_state,
)
from fluidframework_tpu_torch.ops.segment_state import (
    LANE_FILLS,
    SEGMENT_LANES,
    SegmentState,
)
from fluidframework_tpu_torch.protocol.constants import NO_CLIENT, OP_WIDTH
from fluidframework_tpu_torch.utils import pow2_at_least, resolve_device

_I32 = torch.int32
_SCALARS = ("count", "min_seq", "cur_seq", "self_client", "err")
# The packed scalar columns 0..4 hold _SCALARS in this order (SC_COUNT ..
# SC_ERR); columns 5..7 are padding and stay 0.
_N_SC = len(_SCALARS)
_SCALAR_FILLS = {SC_SELF: NO_CLIENT}
KERNELS = ("auto", "cuda", "plain")


# -- device telemetry lanes ----------------------------------------------------

TELEMETRY_ERR_BITS = 4  # ERR_CAPACITY / ERR_RANGE / ERR_CLIENT + spare
TELEMETRY_COLS = (
    "live_slots", "rows_in_use", "err_docs",
    "err_bit0", "err_bit1", "err_bit2", "err_bit3",
    "min_seq_floor", "cur_seq_head",
)

_SEQ_SENTINEL = 2**31 - 1  # dead rows must not lower the min_seq floor


def _reduce_telemetry(live, count, err, min_seq, cur_seq, axis: int):
    """The column assembly every telemetry reduction shares, in the order
    of :data:`TELEMETRY_COLS`. Inputs are 2-D blocks whose ``axis`` folds;
    ``live`` is the same-shape bool occupancy mask."""
    zero = torch.zeros_like(count)
    count = torch.where(live, count, zero)
    err = torch.where(live, err, zero)
    min_seq = torch.where(live, min_seq, torch.full_like(min_seq,
                                                         _SEQ_SENTINEL))
    cur_seq = torch.where(live, cur_seq, zero)
    cols = [
        live.to(torch.int32).sum(dim=axis),
        count.sum(dim=axis),
        (err != 0).to(torch.int32).sum(dim=axis),
    ]
    for b in range(TELEMETRY_ERR_BITS):
        cols.append(((err >> b) & 1).sum(dim=axis))
    floor = min_seq.amin(dim=axis)
    cols.append(torch.where(floor == _SEQ_SENTINEL, 0, floor))
    cols.append(cur_seq.amax(dim=axis))
    return torch.stack([c.to(torch.int32) for c in cols], dim=1)


def _scalars_telemetry(scalars, n_shards: int):
    """[n_shards, len(TELEMETRY_COLS)] reduction over packed scalars
    ([D, N_SCALARS], the SC_* columns); every row live."""
    shape = (n_shards, scalars.shape[0] // n_shards)
    return _pool_telemetry(
        scalars, torch.ones(shape, dtype=torch.bool, device=scalars.device),
        n_shards,
    )


def _pool_telemetry(scalars, live, n_shards: int):
    """[n_shards, len(TELEMETRY_COLS)] health reduction of one pool on the
    device: the slot axis folds per shard. ``live`` is the slot-occupancy
    mask (free slots count as no occupancy and no watermark)."""
    shape = (n_shards, scalars.shape[0] // n_shards)
    return _reduce_telemetry(
        live.reshape(shape),
        scalars[:, SC_COUNT].reshape(shape),
        scalars[:, SC_ERR].reshape(shape),
        scalars[:, SC_MIN_SEQ].reshape(shape),
        scalars[:, SC_CUR_SEQ].reshape(shape),
        axis=1,
    )


def _stacked_docs_telemetry(live, count, err, min_seq, cur_seq):
    """[n_shards, len(TELEMETRY_COLS)] reduction over stacked per-shard doc
    scalars ([n_docs_padded, n_shards] each): the doc axis folds, the shard
    axis stays. ``live`` is the per-doc mask ([n_docs_padded] bool)."""
    return _reduce_telemetry(
        live[:, None] & torch.ones(count.shape, dtype=torch.bool,
                                   device=count.device),
        count, err, min_seq, cur_seq, axis=0,
    )


def split_telemetry(host: np.ndarray, layout) -> Dict[Any, np.ndarray]:
    """Slice one telemetry readback back into per-pool
    [n_shards, len(TELEMETRY_COLS)] blocks (``layout`` =
    [(pool key, n_shards), ...] in concatenation order)."""
    out: Dict[Any, np.ndarray] = {}
    o = 0
    ncol = len(TELEMETRY_COLS)
    for cap, shards in layout:
        out[cap] = host[o: o + shards * ncol].reshape(shards, ncol)
        o += shards * ncol
    return out


# -- pool state helpers (torch, on the pool's device) --------------------------


def _blank_packed(n_docs: int, capacity: int, device):
    """Packed (tables, scalars) of ``n_docs`` empty documents, built on
    ``device`` (the reference's ``_np_batched_state`` builds them in host
    numpy and uploads them)."""
    tables = torch.zeros((N_LANES, n_docs, capacity), dtype=_I32,
                         device=device)
    for i, k in enumerate(SEGMENT_LANES):
        if LANE_FILLS.get(k, 0):
            tables[i] = LANE_FILLS[k]
    scalars = torch.zeros((n_docs, N_SCALARS), dtype=_I32, device=device)
    for c, v in _SCALAR_FILLS.items():
        scalars[:, c] = v
    return tables, scalars


def _blank_slots(pool: "_Pool", slots) -> None:
    """Blank a batch of vacated slots in place on the device (the lanes'
    and scalars' free values), without a host round trip."""
    idx = torch.as_tensor(slots, dtype=torch.long, device=pool.device)
    pool.tables.index_fill_(1, idx, 0)
    for i, k in enumerate(SEGMENT_LANES):
        if LANE_FILLS.get(k, 0):
            pool.tables[i].index_fill_(0, idx, LANE_FILLS[k])
    pool.scalars.index_fill_(0, idx, 0)
    for c, v in _SCALAR_FILLS.items():
        pool.scalars[:, c].index_fill_(0, idx, v)


def _write_slot(pool: "_Pool", slot: int, doc: SegmentState) -> None:
    """Write one document's [S]-lane state (host numpy or tensors) into a
    pool slot: one upload of the document, not of the pool."""
    lanes = torch.tensor(
        np.stack([np.asarray(getattr(doc, k)) for k in SEGMENT_LANES]),
        dtype=_I32,
    )
    scal = torch.zeros(N_SCALARS, dtype=_I32)
    scal[:_N_SC] = torch.tensor([int(getattr(doc, s)) for s in _SCALARS],
                                dtype=_I32)
    pool.tables[:, slot, :] = lanes.to(pool.device)
    pool.scalars[slot] = scal.to(pool.device)


def _scatter_rows(rows_b, slots, n_slots: int):
    """Inflate a gathered op upload ``[B, K, OP_WIDTH]`` + ``[B]`` slot
    indices into the dense ``[n_slots, K, OP_WIDTH]`` batch the pool step
    consumes, on the device. Rows whose slot lies outside ``[0, n_slots)``
    are dropped: they land in one spare row past the end, which is cut off
    (no mask, so no host sync). The reference drops ``slot >= n_slots``
    the same way (XLA's out-of-bounds scatter); DocFleet pads with
    ``n_slots`` and never passes a negative slot."""
    k, w = rows_b.shape[1], rows_b.shape[2]
    dense = torch.zeros((n_slots + 1, k, w), dtype=_I32, device=rows_b.device)
    slots = slots.to(torch.long)
    keep = (slots >= 0) & (slots < n_slots)
    dense.index_copy_(0, torch.where(keep, slots, n_slots), rows_b.to(_I32))
    return dense[:n_slots]


def _fused_sparse_step(pool: "_Pool", rows_b, slots) -> None:
    """Scatter + apply: the dense batch built on the device by
    :func:`_scatter_rows`, then K1 on the pool in place (the serving path's
    dispatch unit)."""
    pool._step(_scatter_rows(rows_b, slots, pool.n_slots))


def _pool_scan(scalars):
    """One [2, n_slots] (count, err) scan of a pool — the fused health
    readback the serving path consumes asynchronously."""
    return torch.stack([scalars[:, SC_COUNT], scalars[:, SC_ERR]])


def _doc_gather(tables, scalars, slot: int):
    """One document's lanes [N_LANES, S] + scalars [5], sliced on the
    device (a doc's worth of bytes crosses to the host, not the pool)."""
    return tables[:, slot, :], scalars[slot, :_N_SC]


def _docs_gather(tables, scalars, slots):
    """N documents' lanes + scalars gathered on the device as one flat
    ``[n * (N_LANES * S + 5)]`` vector (per doc: its lanes row-major, then
    its five scalars) — N snapshot reads, one transfer."""
    n = slots.shape[0]
    lanes = tables.index_select(1, slots).permute(1, 0, 2).reshape(n, -1)
    scal = scalars.index_select(0, slots)[:, :_N_SC]
    return torch.cat([lanes, scal], dim=1).reshape(-1)


class _Pool:
    """One capacity tier: packed ``tables [N_LANES, n_slots, S]`` and
    ``scalars [n_slots, N_SCALARS]`` on the device, plus slot bookkeeping
    on the host. ``doc_of_slot`` is an int32 array (-1 = free) so batch
    routing is a vectorized gather, not a Python slot loop."""

    def __init__(self, capacity: int, n_slots: int, kernel: str, device):
        self.capacity = capacity
        self.n_slots = n_slots
        self.kernel = kernel
        self.device = device
        self.tables, self.scalars = _blank_packed(n_slots, capacity, device)
        self.doc_of_slot = np.full(n_slots, -1, np.int32)
        # Placement generation per slot: bumped whenever the occupant
        # changes, so a stale health scan cannot attribute a departed doc's
        # count/err to the slot's new occupant.
        self.slot_gen = np.zeros(n_slots, np.int64)
        # Slot free-list. Entries are validated against doc_of_slot on pop
        # (a slot may be handed out through a path that never popped it),
        # so a stale entry skips instead of double-allocating; an exhausted
        # list falls back to a scan.
        self._free: List[int] = list(range(n_slots - 1, -1, -1))

    @property
    def state(self) -> SegmentState:
        """The pool as a SegmentState of [n_slots, S] / [n_slots] views of
        the packed tensors."""
        return unpack_state(self.tables, self.scalars)

    def _step(self, ops) -> None:
        """K1 on the whole pool, in place (ops [n_slots, K, OP_WIDTH])."""
        if self.kernel == "plain":
            nt, ns = K1.apply_plain(self.tables, self.scalars, ops)
            self.tables.copy_(nt)
            self.scalars.copy_(ns)
        else:
            K1.apply_ops_packed(self.tables, self.scalars, ops)

    def _compact(self) -> None:
        """K2 on the whole pool, in place, at every tier (the reference
        compacts in Pallas up to 256 rows and with XLA above; one kernel
        here)."""
        if self.kernel == "plain":
            nt, ns = K2.compact_plain(self.tables, self.scalars)
            self.tables.copy_(nt)
            self.scalars.copy_(ns)
        else:
            K2.compact_packed(self.tables, self.scalars)

    def sparse_step_aot(self, dev_rows, dev_slots) -> None:
        """One serving dispatch: scatter ``dev_rows [B, K, OP_WIDTH]`` (on
        the device, not consumed) to ``dev_slots`` and apply. The name is
        the reference's; PyTorch runs it eagerly."""
        _fused_sparse_step(self, dev_rows, dev_slots)

    def compact_aot(self) -> None:
        """The serving path's cadence compaction (eager, as ``_compact``)."""
        self._compact()

    def free_slot(self) -> Optional[int]:
        while self._free:
            s = self._free.pop()
            if self.doc_of_slot[s] < 0:
                return s
        # Free-list dry but slots may have been vacated through a path
        # that never released them: refill from one scan.
        free = np.flatnonzero(self.doc_of_slot < 0)
        if not free.size:
            return None
        self._free = [int(s) for s in free[::-1]]
        return self._free.pop()

    def release_slot(self, slot: int) -> None:
        """Push a vacated slot onto the free-list (the caller already
        blanked it and cleared doc_of_slot)."""
        self._free.append(int(slot))

    def n_free(self) -> int:
        return int(np.sum(self.doc_of_slot < 0))

    def live_slots(self) -> np.ndarray:
        return np.flatnonzero(self.doc_of_slot >= 0)

    def grow_slots(self) -> None:
        """Double the slot dimension (new slots empty), on the device."""
        extra = self.n_slots
        t, s = _blank_packed(extra, self.capacity, self.device)
        self.tables = torch.cat([self.tables, t], dim=1)
        self.scalars = torch.cat([self.scalars, s], dim=0)
        self.doc_of_slot = np.concatenate(
            [self.doc_of_slot, np.full(extra, -1, np.int32)]
        )
        self.slot_gen = np.concatenate(
            [self.slot_gen, np.zeros(extra, np.int64)]
        )
        self._free.extend(range(self.n_slots + extra - 1, self.n_slots - 1, -1))
        self.n_slots += extra


def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` (never a view of device or pool memory:
    on the CPU ``.cpu()`` alone would return the pool's own storage)."""
    return t.to("cpu", copy=True).numpy()


class DocFleet:
    """The service's compute backend with a capacity lifecycle. External
    doc ids are dense [0, n_docs); ops arrive in external order and are
    routed to each doc's current pool/slot.

    ``kernel``: ``"auto"`` runs the hand-written CUDA kernels on a CUDA
    device and the plain PyTorch versions on the CPU; ``"cuda"`` insists on
    the kernels (a CPU device raises); ``"plain"`` runs the plain versions
    on any device (an explicit reference run, never a fallback).
    ``device`` defaults to ``"cuda"`` and raises without a card."""

    def __init__(
        self,
        n_docs: int,
        capacity: int,
        high_water: float = 0.75,
        max_capacity: int = 1 << 16,
        kernel: str = "auto",
        mesh=None,
        axis: str = "docs",
        low_water: float = 0.2,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded DocFleet is not ported yet (multi-device "
                "is a later slice of the port; see ROADMAP.md)"
            )
        if kernel not in KERNELS:
            raise ValueError(
                f"kernel must be one of {KERNELS}; got {kernel!r}"
            )
        self.device = resolve_device("cuda" if device is None else device)
        if kernel == "cuda" and self.device.type != "cuda":
            raise ValueError("kernel='cuda' needs a CUDA device; use "
                             "kernel='auto' or 'plain' on the CPU")
        self.kernel = kernel
        self.n_docs = n_docs
        self.high_water = high_water
        # Demotion threshold (the inverse of the promotion walk): a doc
        # whose live rows fall below ``low_water * cap`` steps down one
        # tier. low_water must sit below high_water/2 so a one-scan-stale
        # count still fits the smaller tier when the move lands.
        self.low_water = low_water
        self.max_capacity = max_capacity
        self.base_capacity = capacity
        self.mesh = None
        pool = _Pool(capacity, pow2_at_least(n_docs), kernel, self.device)
        pool.doc_of_slot[:n_docs] = np.arange(n_docs)
        self.pools: Dict[int, _Pool] = {capacity: pool}
        self.placement: List[Optional[Tuple[int, int]]] = [
            (capacity, d) for d in range(n_docs)
        ]
        # Vectorized routing cache: (cap, slot) per doc as numpy arrays,
        # rebuilt lazily after placement mutations.
        self._place_dirty = True
        self._cap_arr = self._slot_arr = None
        self.migrations = 0
        self.demotions = 0
        self.last_routing_s = 0.0

    @classmethod
    def from_pools(
        cls,
        pools: Dict[int, tuple],
        placement,
        *,
        base_capacity: int,
        high_water: float = 0.75,
        low_water: float = 0.2,
        max_capacity: int = 1 << 16,
        migrations: int = 0,
        demotions: int = 0,
        device=None,
    ) -> "DocFleet":
        """A fleet in a given state. ``pools`` maps each capacity, in pool
        order, to ``(tables, scalars, doc_of_slot, slot_gen, free)``: the
        packed state ``[N_LANES, n_slots, S]`` / ``[n_slots, N_SCALARS]``
        (copied to the fleet's device), each slot's doc (-1 = free), the
        slot generations and the slot free-list (popped from its end).
        ``placement`` is each doc's ``(cap, slot)``, or ``None`` when
        evicted."""
        fleet = cls(0, base_capacity, high_water=high_water,
                    max_capacity=max_capacity, low_water=low_water,
                    device=device)
        fleet.pools = {}
        for cap, (tables, scalars, doc_of_slot, slot_gen, free) in \
                pools.items():
            pool = fleet._new_pool(int(cap), int(tables.shape[1]))
            pool.tables.copy_(tables)
            pool.scalars.copy_(scalars)
            pool.doc_of_slot = np.array(doc_of_slot, np.int32)
            pool.slot_gen = np.array(slot_gen, np.int64)
            pool._free = [int(s) for s in free]
            fleet.pools[int(cap)] = pool
        fleet.placement = [None if p is None else (int(p[0]), int(p[1]))
                           for p in placement]
        fleet.n_docs = len(fleet.placement)
        fleet.migrations = migrations
        fleet.demotions = demotions
        return fleet

    def _new_pool(self, capacity: int, n_slots: int) -> _Pool:
        return _Pool(capacity, n_slots, self.kernel, self.device)

    def _place_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._place_dirty:
            n = len(self.placement)
            cap = np.empty(n, np.int64)
            slot = np.empty(n, np.int64)
            for i, pl in enumerate(self.placement):
                if pl is None:  # evicted
                    cap[i] = -1
                    slot[i] = -1
                else:
                    cap[i], slot[i] = pl
            self._cap_arr, self._slot_arr = cap, slot
            self._place_dirty = False
        return self._cap_arr, self._slot_arr

    def doc_caps(self, docs: np.ndarray) -> np.ndarray:
        """Per-doc capacity tier as one gather (-1 = evicted)."""
        return self._place_arrays()[0][np.asarray(docs, np.int64)]

    def add_doc(self) -> int:
        """Register one more document; returns its dense external id.
        Placed in the base tier, growing its slot dimension when full."""
        doc = self.n_docs
        self.n_docs += 1
        pool = self.pools.get(self.base_capacity)
        if pool is None:
            pool = self.pools[self.base_capacity] = self._new_pool(
                self.base_capacity, 1
            )
        slot = pool.free_slot()
        if slot is None:
            pool.grow_slots()
            slot = pool.free_slot()
        pool.doc_of_slot[slot] = doc
        pool.slot_gen[slot] += 1
        self.placement.append((self.base_capacity, slot))
        self._place_dirty = True
        return doc

    # -- the service step -----------------------------------------------------

    def apply(self, ops: np.ndarray) -> dict:
        """ops: [n_docs, K, OP_WIDTH] sequenced rows in external doc order.
        Uploads them once and routes them on the device, one gather per
        pool; the host part of the routing (index vectors) is recorded in
        ``last_routing_s``. Returns :meth:`stats` (a synchronous read)."""
        ops = np.asarray(ops, np.int32)
        k = ops.shape[1]
        routing = 0.0
        dev_ops = torch.from_numpy(np.ascontiguousarray(ops)).to(self.device)
        for pool in self.pools.values():
            live = pool.live_slots()
            if live.size == 0:
                continue
            t0 = time.perf_counter()
            dst = torch.from_numpy(live).to(self.device)
            src = torch.from_numpy(
                pool.doc_of_slot[live].astype(np.int64)
            ).to(self.device)
            routing += time.perf_counter() - t0
            routed = torch.zeros((pool.n_slots, k, OP_WIDTH), dtype=_I32,
                                 device=self.device)
            routed.index_copy_(0, dst, dev_ops.index_select(0, src))
            pool._step(routed)
        self.last_routing_s = routing
        return self.stats()

    def apply_sparse(self, docs, ops_b: np.ndarray) -> None:
        """Apply one boxcar staged over BUSY documents only: ``docs`` are
        external doc ids, ``ops_b [B, K, OP_WIDTH]`` their rows (row i
        belongs to docs[i]). The upload is O(busy × K); each pool's dense
        batch is rebuilt on the device by :func:`_scatter_rows`. ``B`` pads
        to a pow2 bucket per pool; padding rows carry slot ``n_slots`` and
        drop. Health rides :meth:`begin_scan` / :meth:`finish_scan`."""
        k = ops_b.shape[1]
        routing = 0.0
        t0 = time.perf_counter()
        docs = np.asarray(docs, np.int64)
        cap_arr, slot_arr = self._place_arrays()
        caps = cap_arr[docs]
        uniq = np.unique(caps)
        routing += time.perf_counter() - t0
        for cap in uniq:
            pool = self.pools[int(cap)]
            t0 = time.perf_counter()
            if uniq.size == 1:
                members = ops_b
                mdocs = docs
            else:
                sel = caps == cap
                members = ops_b[sel]
                mdocs = docs[sel]
            b = pow2_at_least(len(mdocs))
            rows_b = np.zeros((b, k, OP_WIDTH), np.int32)
            rows_b[: len(mdocs)] = members
            slots = np.full(b, pool.n_slots, np.int32)  # pad = dropped
            slots[: len(mdocs)] = slot_arr[mdocs]
            routing += time.perf_counter() - t0
            _fused_sparse_step(
                pool, torch.from_numpy(rows_b).to(self.device),
                torch.from_numpy(slots).to(self.device),
            )
        self.last_routing_s = routing

    def dispatch_staged(self, docs, dev_rows) -> None:
        """Apply one staged boxcar: ``docs`` are external doc ids,
        ``dev_rows`` their ``[B, K, OP_WIDTH]`` rows already on the device.
        Row i belongs to docs[i]; padding rows (i >= len(docs)) route out
        of range and drop. Placement is resolved here, not at stage time,
        so a promotion since staging re-routes the rows."""
        b = dev_rows.shape[0]
        t0 = time.perf_counter()
        docs = np.asarray(docs, np.int64)
        cap_arr, slot_arr = self._place_arrays()
        caps = cap_arr[docs]
        uniq = np.unique(caps[caps > 0])
        routing = time.perf_counter() - t0
        for cap in uniq:
            pool = self.pools[int(cap)]
            t0 = time.perf_counter()
            slots = np.full(b, pool.n_slots, np.int32)  # pad = dropped
            sel = np.flatnonzero(caps == cap)
            slots[sel] = slot_arr[docs[sel]]
            routing += time.perf_counter() - t0
            pool.sparse_step_aot(dev_rows,
                                 torch.from_numpy(slots).to(self.device))
        self.last_routing_s = routing

    def compact_aot(self) -> None:
        """Compact every pool that holds a document (the serving path's
        cadence compaction; see :meth:`compact`)."""
        for pool in self._occupied_pools():
            pool.compact_aot()

    def _occupied_pools(self) -> List[_Pool]:
        """The pools with at least one document. Every free slot is blank
        (never used, or blanked when vacated), and compacting a blank slot
        leaves it as it is, so a pool without documents needs no K2."""
        return [p for p in self.pools.values() if (p.doc_of_slot >= 0).any()]

    def begin_scan(self) -> Dict[int, tuple]:
        """Start an asynchronous (count, err) readback of every pool;
        returns a token for :meth:`finish_scan`: cap -> (host buffer, CUDA
        event or None, slot generations). On a card each scan is copied
        into a pinned host buffer with ``non_blocking=True`` behind an
        event, so later steps queue without waiting; the scan snapshots the
        state at call time. The slot generations let :meth:`finish_scan`
        drop columns of slots whose occupant changed since."""
        token = {}
        for cap, pool in self.pools.items():
            dev = _pool_scan(pool.scalars)
            if dev.is_cuda:
                host = torch.empty(dev.shape, dtype=dev.dtype,
                                   pin_memory=True)
                host.copy_(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev.device))
            else:
                host, event = dev, None
            token[cap] = (host, event, pool.slot_gen.copy())
        return token

    def finish_scan(self, token, host=None) -> Dict[int, np.ndarray]:
        """Wait for a begin_scan token: cap -> [2, n_slots] host array.
        Columns for slots reassigned since begin_scan are zeroed (no false
        promotion/nack for the new occupant). ``host`` lets a caller that
        already waited off-thread pass the per-cap host arrays in."""
        out = {}
        for cap, (buf, event, gen_snap) in token.items():
            if host is None:
                if event is not None:
                    event.synchronize()
                arr = buf.numpy().copy()
            else:
                arr = host[cap]
            pool = self.pools.get(cap)
            if pool is not None:
                n = min(arr.shape[1], len(gen_snap), len(pool.slot_gen))
                stale = pool.slot_gen[:n] != gen_snap[:n]
                if stale.any():
                    arr[:, :n][:, stale] = 0
            out[cap] = arr
        return out

    def compact(self) -> None:
        """Compact every pool that holds a document (K2 at its tier)."""
        for pool in self._occupied_pools():
            pool._compact()

    def _telemetry_device(self):
        """The device half of one scrape, no readback: every pool's
        :func:`_pool_telemetry` concatenated into one flat device vector,
        plus the [(cap, n_shards), ...] layout to split it with (one shard
        per pool: no mesh)."""
        layout: List[Tuple[int, int]] = []
        devs = []
        for cap in sorted(self.pools):
            pool = self.pools[cap]
            layout.append((cap, 1))
            live = torch.from_numpy(pool.doc_of_slot >= 0).to(self.device)
            devs.append(_pool_telemetry(pool.scalars, live, 1).reshape(-1))
        dev = torch.cat(devs) if len(devs) > 1 else devs[0]
        return dev, layout

    def telemetry_slice(self) -> Dict[int, np.ndarray]:
        """Per-pool telemetry — cap -> [n_shards, len(TELEMETRY_COLS)] — in
        exactly one device→host readback."""
        dev, layout = self._telemetry_device()
        return split_telemetry(_host(dev), layout)

    def stats(self) -> dict:
        errs = 0
        rows = 0
        for pool in self.pools.values():
            # The reference retries this readback because a concurrent
            # serving step may donate (delete) the pool's buffers under it.
            # The port updates pools in place and donates nothing, so one
            # read is always valid.
            sc = _host(pool.scalars[:, [SC_ERR, SC_COUNT]])
            live = pool.live_slots()
            errs += int(np.sum(sc[live, 0] != 0))
            rows += int(np.sum(sc[live, 1]))
        return {"docs_with_errors": errs, "rows_in_use": rows,
                "migrations": self.migrations, "demotions": self.demotions,
                "pools": sorted(self.pools)}

    # -- capacity lifecycle ---------------------------------------------------

    def check_and_migrate(
        self, counts: Optional[Dict[int, np.ndarray]] = None
    ) -> List[int]:
        """Host-driven promotion pass: move every doc above the high-water
        mark into the next capacity tier. Call between batches; returns the
        promoted doc ids. ``counts`` (cap -> [n_slots], e.g. from a
        :meth:`begin_scan` token) substitutes for the synchronous count
        readback."""
        promoted: List[int] = []
        for cap in sorted(self.pools):
            pool = self.pools[cap]
            if cap * 2 > self.max_capacity:
                continue
            c = counts.get(cap) if counts is not None else None
            hot_slots = self._hot_slots(pool, cap, c)
            hot = [(int(s), int(pool.doc_of_slot[s])) for s in hot_slots]
            if not hot:
                continue
            self._promote_batch(pool, cap, hot)
            promoted.extend(doc for _slot, doc in hot)
        return promoted

    def _dst_pool(self, new_cap: int, n_moves: int) -> _Pool:
        dst = self.pools.get(new_cap)
        if dst is None:
            dst = self.pools[new_cap] = self._new_pool(
                new_cap, pow2_at_least(n_moves)
            )
        while dst.n_free() < n_moves:
            dst.grow_slots()
        return dst

    def _move(self, pool: _Pool, dst: _Pool, moves, n_rows=None) -> None:
        """Move docs ``moves`` = [(slot, doc, dst_slot)] from ``pool`` to
        ``dst``: their lanes and scalars are copied on the device (a wider
        ``dst`` takes the whole lane, rows past it free; a narrower one the
        first ``n_rows[i]`` rows, the rest free), the vacated slots are
        blanked and released, and placement follows."""
        dev = self.device
        src = torch.tensor([m[0] for m in moves], dtype=torch.long,
                           device=dev)
        to = torch.tensor([m[2] for m in moves], dtype=torch.long, device=dev)
        lanes, _ = _blank_packed(len(moves), dst.capacity, dev)
        rows = pool.tables.index_select(1, src)
        if dst.capacity > pool.capacity:
            lanes[:, :, : pool.capacity] = rows
        else:
            n = torch.tensor(n_rows, dtype=_I32, device=dev)
            keep = (torch.arange(dst.capacity, dtype=_I32, device=dev)[None]
                    < n[:, None])
            lanes = torch.where(keep[None], rows[:, :, : dst.capacity], lanes)
        dst.tables.index_copy_(1, to, lanes)
        dst.scalars.index_copy_(0, to, pool.scalars.index_select(0, src))
        _blank_slots(pool, src)
        for slot, doc, dst_slot in moves:
            self._vacate(pool, slot, doc)
            dst.doc_of_slot[dst_slot] = doc
            dst.slot_gen[dst_slot] += 1
            self.placement[doc] = (dst.capacity, dst_slot)
        self._place_dirty = True

    def _promote_batch(self, pool, cap: int, hot: List[Tuple[int, int]]):
        """Promote every hot doc of one pool with one device-side copy per
        pool: each doc's whole lane goes to a free slot of the next tier,
        and its vacated slot is blanked for reuse."""
        dst = self._dst_pool(cap * 2, len(hot))
        free = [int(s) for s in np.flatnonzero(dst.doc_of_slot < 0)]
        self._move(pool, dst, [(slot, doc, dst_slot) for (slot, doc), dst_slot
                               in zip(hot, free)])
        self.migrations += len(hot)

    def check_and_demote(
        self,
        counts: Optional[Dict[int, np.ndarray]] = None,
        max_moves: int = 32,
    ) -> List[int]:
        """Host-driven demotion pass — the inverse of the promotion walk:
        move docs whose live rows fell below ``low_water * cap`` down one
        tier. ``counts`` substitutes for the synchronous readback as in
        :meth:`check_and_migrate`; the post-compact count re-verifies the
        fit before anything moves. ``max_moves`` bounds the moves per
        pass."""
        demoted: List[int] = []
        for cap in sorted(self.pools, reverse=True):
            if len(demoted) >= max_moves:
                break
            pool = self.pools[cap]
            if cap // 2 < self.base_capacity:
                continue
            c = counts.get(cap) if counts is not None else None
            cold_slots = self._cold_slots(pool, cap, c)
            budget = max_moves - len(demoted)
            cold = [
                (int(s), int(pool.doc_of_slot[s]))
                for s in cold_slots[:budget]
            ]
            if not cold:
                continue
            demoted.extend(self._demote_batch(pool, cap, cold))
        return demoted

    def _demote_batch(
        self, pool, cap: int, cold: List[Tuple[int, int]]
    ) -> List[int]:
        """Demote the cold docs of one pool with one device-side copy. The
        source pool is compacted first (K2) so every live row sits in
        ``[0, count)``; each doc's fit is then re-verified against the
        fresh count (docs that no longer fit, or whose sticky err lane
        fired, are skipped — moving corrupt state would launder the
        error); the first ``count`` rows move and the rest of the narrower
        lane is free."""
        new_cap = cap // 2
        pool._compact()
        dst = self._dst_pool(new_cap, len(cold))
        idx = torch.tensor([s for s, _d in cold], dtype=torch.long,
                           device=self.device)
        sc = _host(pool.scalars.index_select(0, idx)[:, [SC_COUNT, SC_ERR]])
        free = [int(s) for s in np.flatnonzero(dst.doc_of_slot < 0)]
        picks = []  # (slot, doc, dst_slot)
        n_rows = []
        for (slot, doc), (n, err) in zip(cold, sc.tolist()):
            if err != 0 or n > self.high_water * new_cap:
                continue
            picks.append((slot, doc, free[len(picks)]))
            n_rows.append(n)
        if not picks:
            return []
        self._move(pool, dst, picks, n_rows)
        self.demotions += len(picks)
        return [doc for _slot, doc, _dst in picks]

    def _slot_counts(self, pool: _Pool, counts) -> np.ndarray:
        """Per-slot counts: the given scan (padded with zeros for slots
        added since it was taken) or a synchronous readback."""
        if counts is None:
            counts = _host(pool.scalars[:, SC_COUNT])
        if len(counts) < pool.n_slots:
            counts = np.concatenate(
                [counts, np.zeros(pool.n_slots - len(counts), np.int32)]
            )
        return counts[: pool.n_slots]

    def _cold_slots(
        self, pool: _Pool, cap: int, counts: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Live slots below the low-water mark — the demotion predicate."""
        return np.flatnonzero(
            (pool.doc_of_slot >= 0)
            & (self._slot_counts(pool, counts) < self.low_water * cap)
        )

    def _hot_slots(
        self, pool: _Pool, cap: int, counts: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Live slots above the high-water mark — the promotion predicate
        shared by tier promotion and the overflow scan."""
        return np.flatnonzero(
            (pool.doc_of_slot >= 0)
            & (self._slot_counts(pool, counts) > self.high_water * cap)
        )

    def overflowing_docs(self) -> List[int]:
        """Healthy docs above high water in a tier that cannot promote
        (cap*2 > max_capacity) — the candidates for re-homing before
        ERR_CAPACITY trips. Docs whose sticky err lane already fired are
        excluded."""
        out: List[int] = []
        for cap, pool in self.pools.items():
            if cap * 2 <= self.max_capacity:
                continue
            err = _host(pool.scalars[:, SC_ERR])
            out.extend(
                int(pool.doc_of_slot[s])
                for s in self._hot_slots(pool, cap)
                if err[s] == 0
            )
        return out

    def _vacate(self, pool: _Pool, slot: int, doc: int) -> None:
        pool.doc_of_slot[slot] = -1
        pool.slot_gen[slot] += 1
        pool.release_slot(slot)
        self.placement[doc] = None

    def evict_doc(self, doc: int) -> SegmentState:
        """Pull one document's state out of the fleet (host copy) and free
        its slot. The doc id stays allocated; routing it afterward is the
        caller's job."""
        state = self.doc_state(doc)
        self.evict_docs([doc], {doc: state})
        return state

    def restore_doc(self, doc: int, state: SegmentState) -> None:
        """Re-admit an evicted document from a host-side state — the
        inverse of :meth:`evict_doc`. Its capacity tier is read off the
        state's lane width, so a doc evicted from a promoted tier returns
        into that tier."""
        if self.placement[doc] is not None:
            raise ValueError(f"restore_doc({doc}): doc is still placed")
        cap = int(np.asarray(state.kind).shape[-1])
        pool = self.pools.get(cap)
        if pool is None:
            pool = self.pools[cap] = self._new_pool(cap, 1)
        slot = pool.free_slot()
        if slot is None:
            pool.grow_slots()
            slot = pool.free_slot()
        _write_slot(pool, slot, state)
        pool.doc_of_slot[slot] = doc
        pool.slot_gen[slot] += 1
        self.placement[doc] = (cap, slot)
        self._place_dirty = True

    def evict_docs(
        self,
        docs: List[int],
        states: Optional[Dict[int, SegmentState]] = None,
    ) -> Dict[int, SegmentState]:
        """Batched :meth:`evict_doc`: states come from one batched gather
        (or from ``states``), and the vacated slots blank with one
        device-side fill per pool."""
        if states is None:
            states = self.doc_states(docs)
        by_pool: Dict[int, List[int]] = {}
        for d in docs:
            cap, _slot = self.placement[d]
            by_pool.setdefault(cap, []).append(d)
        for cap, group in by_pool.items():
            pool = self.pools[cap]
            slots = [self.placement[d][1] for d in group]
            _blank_slots(pool, slots)
            for d, s in zip(group, slots):
                self._vacate(pool, s, d)
        self._place_dirty = True
        return states

    # -- introspection --------------------------------------------------------

    def doc_counts(self, docs: List[int]) -> np.ndarray:
        """Live row counts for a set of docs with one [n_slots] count
        readback per pool. Evicted docs report 0."""
        count_cache: Dict[int, np.ndarray] = {}
        out = np.zeros(len(docs), np.int32)
        for i, d in enumerate(docs):
            place = self.placement[d]
            if place is None:
                continue
            cap, slot = place
            counts = count_cache.get(cap)
            if counts is None:
                counts = count_cache[cap] = _host(
                    self.pools[cap].scalars[:, SC_COUNT]
                )
            out[i] = counts[slot]
        return out

    def doc_state(self, doc: int) -> SegmentState:
        """One document's full state read back to host via a device-side
        slice ([N_LANES, S] lanes + [5] scalars cross, not the pool)."""
        cap, slot = self.placement[doc]
        pool = self.pools[cap]
        lanes, scal = _doc_gather(pool.tables, pool.scalars, slot)
        lanes, scal = _host(lanes), _host(scal)
        return SegmentState(
            **{k: lanes[i] for i, k in enumerate(SEGMENT_LANES)},
            **{s: scal[i] for i, s in enumerate(_SCALARS)},
        )

    def doc_states_start(self, docs: List[int]):
        """The device half of one batched multi-doc gather, no readback:
        per-pool :func:`_docs_gather` results concatenated into one flat
        device vector, plus the layout to split it. Slot vectors pad to
        pow2 buckets (padding re-gathers slot 0, discarded at finish)."""
        _, slot_arr = self._place_arrays()
        by_cap: Dict[int, List[int]] = {}
        for d in docs:
            place = self.placement[d]
            if place is None:
                raise KeyError(f"doc {d} evicted from the fleet")
            by_cap.setdefault(place[0], []).append(int(d))
        devs = []
        layout: List[Tuple[int, List[int], int]] = []
        for cap in sorted(by_cap):
            pool = self.pools[cap]
            members = by_cap[cap]
            pad = pow2_at_least(len(members))
            slots = np.zeros(pad, np.int64)
            slots[: len(members)] = slot_arr[np.asarray(members, np.int64)]
            devs.append(_docs_gather(pool.tables, pool.scalars,
                                     torch.from_numpy(slots).to(self.device)))
            layout.append((cap, members, pad))
        dev = torch.cat(devs) if len(devs) > 1 else devs[0]
        return dev, layout

    @staticmethod
    def doc_states_transfer(dev) -> np.ndarray:
        """The blocking device→host half of one batched gather."""
        return _host(dev)

    @staticmethod
    def doc_states_finish(
        host: np.ndarray, layout
    ) -> Dict[int, SegmentState]:
        """Split one batched-gather readback into per-doc states (doc id
        -> :class:`SegmentState`), bit-identical to per-doc
        :meth:`doc_state`."""
        out: Dict[int, SegmentState] = {}
        nl = len(SEGMENT_LANES)
        ns = len(_SCALARS)
        o = 0
        for cap, members, pad in layout:
            row = nl * cap + ns
            block = host[o: o + pad * row].reshape(pad, row)
            o += pad * row
            for i, d in enumerate(members):
                lanes = block[i, : nl * cap].reshape(nl, cap)
                scal = block[i, nl * cap:]
                out[d] = SegmentState(
                    **{k: lanes[j] for j, k in enumerate(SEGMENT_LANES)},
                    **{s: scal[j] for j, s in enumerate(_SCALARS)},
                )
        return out

    def doc_states(self, docs: List[int]) -> Dict[int, SegmentState]:
        """N documents' full states in exactly one device→host readback."""
        if not docs:
            return {}
        dev, layout = self.doc_states_start(docs)
        return self.doc_states_finish(
            self.doc_states_transfer(dev), layout
        )
