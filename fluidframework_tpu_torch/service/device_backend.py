"""Device-resident document state for the serving path.

Counterpart of ``fluidframework_tpu/service/device_backend.py`` on
PyTorch. Reference: the deli lambda owns an authoritative view of every
document it orders (``server/routerlicious/packages/lambdas/src/deli/
lambda.ts:379,742``, driven per document by the partition framework,
``lambdas-driver/src/document-router/documentLambda.ts:20``). The
service's replica of every string channel lives in a
:class:`~fluidframework_tpu_torch.parallel.fleet.DocFleet` — packed
segment tables on the GPU — and reads, summaries and error feedback are
served from that device state.

Execution model: per-document stream lambdas (``TpuDeliLambda`` in
``service/device_lambda.py``) decode sequenced wire ops into kernel rows
and enqueue them here; the backend boxcars the buffered rows of the whole
fleet into one batched dispatch per flush (K1, the merge apply kernel, on
every pool the boxcar touches), compacts the pools every
``compact_every``-th flush (K2), runs the capacity lifecycle between
boxcars, and surfaces each document's sticky err lane exactly once as it
trips (the nack/telemetry feed).

The continuous pump: in ``pump_mode`` (default) the flush path is a
pipelined ring. Round N+1's boxcar assembles on the host in a PINNED
buffer and uploads with ``non_blocking=True`` into an ingest ring slot
while round N computes; round N-1's one-boxcar-stale (count, err) health
scan — a pinned copy behind a CUDA event (``DocFleet.begin_scan``) — is
the only device→host readback. ``pump_feed()`` is the hybrid size/time
boxcar trigger (a boxcar stages when the buffers reach ``max_batch`` or
``feed_deadline_ms`` after the oldest buffered row arrived); the
quiescence-time flush is the final drain and err-surface barrier.

Replay safety: delivery upstream is at-least-once; a per-channel applied-
sequence watermark drops already-applied rows host-side, so a crashed
consumer can rebuild the fleet by replaying the deltas log from offset
zero (the scribe rebuild model, ``scribe/lambda.ts:106``).

Differences from the reference, each forced by PyTorch or by what the
port has so far:

- the ring slot owns its pinned host buffer (``host_rows`` is a numpy view
  of it, the copy :meth:`_dispatch_fallback` re-applies from) until its
  dispatch has run; a dropped buffer returns to PyTorch's pinned-memory
  cache, which reuses it only after the copy recorded on it has finished;
- the scan token is the port's ``(pinned host buffer, CUDA event, slot
  generations)`` per pool, so :meth:`scan_transfer` waits on each event;
- every device readback copies (``parallel.fleet._host``);
- there is nothing to compile ahead: on a card the constructor builds and
  loads the kernel library (``ops/_cuda.py``) instead of warming
  throwaway fleets;
- ``mesh=`` is the port's :class:`~fluidframework_tpu_torch.parallel.mesh.
  Mesh` (an ordered device list), and a document re-homed by
  ``sharded_overflow=True`` spreads over :func:`parallel.mesh.devices`,
  the port's ``jax.devices()``; the sharded document takes the backend's
  ``kernel``;
- a sharded document's rows are applied unpadded: the reference pads them
  to a pow2 K of zero rows to bound its jit shapes, and a zero row changes
  nothing (a NOOP bookkeeping seq 0 and min seq 0).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops.apply_kernel import (
    SC_COUNT,
    SC_CUR_SEQ,
    SC_ERR,
    SC_MIN_SEQ,
)
from fluidframework_tpu_torch.ops.segment_state import (
    SEGMENT_LANES,
    materialize,
)
from fluidframework_tpu_torch.parallel.fleet import (
    TELEMETRY_COLS,
    DocFleet,
    _host,
    _stacked_docs_telemetry,
    split_telemetry,
)
from fluidframework_tpu_torch.parallel.mesh import devices as mesh_devices
from fluidframework_tpu_torch.parallel.sharded_doc import (
    ShardedDoc,
    check_shard_cap,
)
from fluidframework_tpu_torch.protocol.constants import F_ARG, F_SEQ, OP_WIDTH
from fluidframework_tpu_torch.service import retry
from fluidframework_tpu_torch.service.admission import PressureSignal
from fluidframework_tpu_torch.service.residency import (
    HeatTracker,
    ResidencyManager,
)
from fluidframework_tpu_torch.telemetry import (
    journal,
    metrics,
    profiler,
    tracing,
)
from fluidframework_tpu_torch.testing import faults
from fluidframework_tpu_torch.testing.faults import inject_fault
from fluidframework_tpu_torch.utils import pow2_at_least as _pow2_at_least

ChannelKey = Tuple[str, str]  # (doc_id, channel address)

class _RingSlot:
    """One staged boxcar in the ingest ring: the device rows (uploaded
    asynchronously while the previous step computes), the host rows they
    were copied from (``host_rows``; on a card a numpy view whose base is
    the pinned tensor, so the slot owns that buffer until its dispatch has
    run: the upload may still be reading it, and the dispatch fallback
    re-applies from it),
    the doc routing vector (slots resolve at DISPATCH time, so a promotion
    consumed from the previous health scan re-routes staged rows), the
    flight-recorder spans and the profiler's boxcar id."""

    __slots__ = (
        "dev_rows", "host_rows", "docs", "lens", "rows", "traces",
        "jspans", "bid",
    )

    def __init__(self, dev_rows, host_rows, docs, lens, rows, traces,
                 jspans=(), bid=-1):
        self.dev_rows = dev_rows
        self.host_rows = host_rows
        self.docs = docs
        self.lens = lens
        self.rows = rows  # real (unpadded) row count staged
        self.traces = traces
        # Per-channel (doc, seq_lo, seq_hi) runs this boxcar carries —
        # stamped once at stage time, reused by the dispatch and commit
        # journal events (journal off: empty).
        self.jspans = jspans
        # Serving-profiler boxcar id: the dispatch/device_step/
        # scan_consume intervals of this slot's round carry it
        # (profiler off: -1).
        self.bid = bid


class IngestRing:
    """Double-buffered (depth-N) staging ring: slot N+1 uploads while
    slot N dispatches and slot N-1's health scan streams back. ``full``
    is the backpressure signal — the pump dispatches the oldest staged
    slot before staging another."""

    def __init__(self, depth: int = 2):
        self.depth = max(1, int(depth))
        self.staged: Deque[_RingSlot] = deque()

    def full(self) -> bool:
        return len(self.staged) >= self.depth

    def push(self, slot: _RingSlot) -> None:
        self.staged.append(slot)

    def pop(self) -> _RingSlot:
        return self.staged.popleft()

    def __len__(self) -> int:
        return len(self.staged)


class DeviceFleetBackend:
    """The service's device compute backend: one DocFleet slot per string
    channel, shared by every partition's device lambdas.

    ``kernel`` passes through to the fleet (``"auto"``, ``"cuda"`` or
    ``"plain"``); ``device`` defaults to ``"cuda"`` and raises without a
    card (``device="cpu"`` runs the plain versions, for the tests).
    ``mesh`` shards every fleet pool's slot axis over a device list (then
    ``device`` is the mesh's first). ``sharded_overflow``: a channel that
    outgrows the top tier re-homes into a ``ShardedDoc`` instead of
    tripping ERR_CAPACITY (the default: a 429 nack)."""

    def __init__(
        self,
        capacity: int = 128,
        max_batch: int = 512,
        compact_every: int = 8,
        max_capacity: int = 1 << 16,
        sharded_overflow: bool = False,
        mesh=None,
        kernel: str = "auto",
        pump_mode: bool = True,
        ring_depth: int = 2,
        feed_deadline_ms: float = 3.0,
        max_resident: int = 0,
        wake_pending_max: int = 4096,
        device=None,
    ):
        self.fleet = DocFleet(
            0, capacity, max_capacity=max_capacity, mesh=mesh,
            kernel=kernel, device=device,
        )
        self.device = self.fleet.device
        self.max_batch = max_batch
        self.compact_every = compact_every
        self.sharded_overflow = sharded_overflow
        self._sharded: Dict[int, ShardedDoc] = {}  # fleet idx -> doc
        # Overflowing docs whose promotion the kernels' top tier refused:
        # they stay in their top-tier slot (as without sharded overflow).
        self._promotion_refused: set = set()
        self._index: Dict[ChannelKey, int] = {}
        self._keys: List[ChannelKey] = []  # dense fleet id -> key
        self.payloads: Dict[ChannelKey, dict] = {}
        # Per-channel watermarks as dense int64 arrays indexed by fleet id
        # (bookkeeping is two fancy-indexed array ops per boxcar):
        # _applied_a: highest applied seq; _buffseq_a: highest seq sitting
        # in _buffers (drops live redelivery duplicates before they
        # double-apply); _since_a: ops since the last summary readback
        # (the device scribe's dirtiness signal).
        self._applied_a = np.zeros(0, np.int64)
        self._buffseq_a = np.zeros(0, np.int64)
        self._since_a = np.zeros(0, np.int64)
        self._buffers: Dict[int, List[np.ndarray]] = {}
        self._buffered_rows = 0
        self._flushes = 0
        self._scan_token = None  # in-flight async (count, err) pool scan
        # Sampled-frame trace spine (telemetry/tracing.py): traces of
        # frames enqueued since the last flush, then awaiting the health
        # scan that covers their boxcar.
        self._trace_pending: List[list] = []
        self._trace_inflight: List[list] = []
        # Flight-recorder in-flight spans: boxcars dispatched but whose
        # health scan (the commit signal) has not been consumed yet.
        self._journal_inflight: List[tuple] = []
        self._errored: set = set()  # fleet ids already reported
        self._unreported: List[ChannelKey] = []
        self.ops_applied = 0
        # The read tier's amortization counters: snapshot reads served vs
        # device gather dispatches, and faulted batched gathers served
        # through per-doc gathers instead (never a failed read).
        self.reads_served = 0
        self.read_gathers = 0
        self.read_gather_fallbacks = 0
        # Where flush wall goes: staging_s (host assembly + upload
        # enqueue), dispatch_s (the dispatch call minus the fleet's host
        # routing), routing_s (that routing). last_flush_breakdown is the
        # most recent flush; flush_totals accumulates.
        self.last_flush_breakdown: Dict[str, float] = {}
        self.flush_totals: Dict[str, float] = {
            "staging_s": 0.0, "dispatch_s": 0.0, "routing_s": 0.0,
            "staged_rows": 0,
        }
        # The continuous device pump. pump_mode=False keeps the one-shot
        # stage->dispatch->wait path (the parity reference of the pump).
        # pump_busy_s is the union of dispatch->scan-readback intervals:
        # 1 - busy/wall is the device idle share.
        self.pump_mode = pump_mode
        self._ring = IngestRing(ring_depth)
        self.pump_dispatches = 0
        self.pump_backpressure = 0
        self.pump_busy_s = 0.0
        self._busy_edge = 0.0
        self._scan_dispatch_t: Optional[float] = None
        # Every staged boxcar gets a monotone id; _scan_bid is the boxcar
        # the in-flight health scan covers. pump_busy_s and flush_totals
        # derive from the same perf_counter reads as the profiler lanes.
        self._boxcar_seq = 0
        self._scan_bid = -1
        # The continuous front door: pump_feed() stages a boxcar once the
        # buffers reach max_batch (size trigger) or feed_deadline_ms has
        # elapsed since the oldest buffered row arrived (deadline trigger,
        # _feed_edge). _scan_prefetch holds an off-thread transfer of the
        # in-flight scan.
        self.feed_deadline_ms = float(feed_deadline_ms)
        self._feed_edge: Optional[float] = None
        self.feed_triggers: Dict[str, int] = {"size": 0, "deadline": 0}
        self._scan_prefetch: Optional[Tuple[object, Dict[int, np.ndarray]]] = None
        # Fleet-as-cache: the residency manager owns the per-doc
        # RESIDENT -> IDLE -> HIBERNATING -> COLD -> WAKING lifecycle;
        # max_resident (0 = unbounded) is the slot budget. _cold holds
        # each hibernated channel's exact evicted state + applied head;
        # the wake path restores it bit-identically and reads serve from
        # it without waking. _parked buffers rows addressed to a
        # COLD/WAKING doc: they must NOT enter _buffers (dispatch drops
        # rows routed to an evicted slot), so they park at the enqueue
        # boundary — never dropped, never reordered.
        self.residency = ResidencyManager(
            max_resident=max_resident, heat=HeatTracker(),
            wake_pending_max=wake_pending_max,
        )
        self._cold: Dict[ChannelKey, Tuple[object, int]] = {}
        # Serializes wake commits across threads: exactly one waker may
        # claim a cold record and restore it.
        self._wake_mu = threading.Lock()
        self._doc_channels: Dict[str, List[ChannelKey]] = {}
        self._parked: Dict[int, List[np.ndarray]] = {}
        self._parked_rows = 0
        self.hibernations = 0
        if self.device.type == "cuda" and kernel != "plain":
            # Build and load the kernels now, so the first serving flush
            # does not pay nvcc.
            _cuda.lib()

    # -- registry --------------------------------------------------------------

    def ensure(self, doc_id: str, address: str) -> int:
        key = (doc_id, address)
        idx = self._index.get(key)
        if idx is None:
            idx = self.fleet.add_doc()
            self._index[key] = idx
            self._keys.append(key)
            self.payloads[key] = {}
            self._doc_channels.setdefault(doc_id, []).append(key)
            self.residency.note_admit(doc_id)
            if len(self._keys) > self._applied_a.shape[0]:
                # Amortized doubling of the watermark arrays.
                grow = max(64, self._applied_a.shape[0])
                pad = np.zeros(grow, np.int64)
                self._applied_a = np.concatenate([self._applied_a, pad])
                self._buffseq_a = np.concatenate([self._buffseq_a, pad])
                self._since_a = np.concatenate([self._since_a, pad])
        return idx

    @property
    def applied_seq(self) -> Dict[ChannelKey, int]:
        """Per-channel applied-seq watermarks as a dict view."""
        return {
            k: int(self._applied_a[i]) for i, k in enumerate(self._keys)
        }

    @property
    def ops_since_summary(self) -> Dict[ChannelKey, int]:
        """Per-channel ops-since-summary dirtiness as a dict view."""
        return {
            k: int(self._since_a[i]) for i, k in enumerate(self._keys)
        }

    def channels(self) -> List[ChannelKey]:
        return list(self._keys)

    def has_channel(self, doc_id: str, address: str) -> bool:
        return (doc_id, address) in self._index

    # -- ingest ----------------------------------------------------------------

    def enqueue(self, doc_id: str, address: str, row: np.ndarray) -> None:
        """Buffer one sequenced kernel row. Rows at or below the channel's
        applied watermark — or its buffered high-water mark — are replay
        duplicates and drop here."""
        idx = self.ensure(doc_id, address)
        seq = int(row[F_SEQ])
        if seq <= self._applied_a[idx] or seq <= self._buffseq_a[idx]:
            return
        if not self.residency.note_op(doc_id):
            # COLD/WAKING doc: park + attempt wake.
            self._park(idx, doc_id, row[None, :])
            return
        self._buffseq_a[idx] = seq
        if not self._buffered_rows:
            self._feed_edge = time.perf_counter()
        self._buffers.setdefault(idx, []).append(row[None, :])
        self._buffered_rows += 1
        if self._buffered_rows >= self.max_batch:
            self._boxcar_full()

    def enqueue_frame(self, doc_id: str, frame) -> None:
        """Buffer a whole sequenced op frame (the batched binary wire,
        ``protocol/opframe.py``) with the replay-idempotence contract of
        :meth:`enqueue`, vectorized: the frame's contiguous seq run is cut
        at the channel watermark in one comparison, and insert payloads
        land in the channel dict in one update."""
        key = (doc_id, frame.address)
        idx = self._index.get(key)
        if idx is None:
            idx = self.ensure(doc_id, frame.address)
        rows = frame.rows
        texts = frame.texts
        n = rows.shape[0]
        water = max(int(self._applied_a[idx]), int(self._buffseq_a[idx]))
        skip = water - frame.first_seq + 1
        if skip > 0:
            rows = rows[skip:]
            if rows.shape[0] == 0:
                return
        if texts:
            if len(texts) == n:
                origs = frame.rows[:, F_ARG]
            else:
                origs, texts = frame.insert_payloads()
            self.payloads[key].update(zip(origs.tolist(), texts))
        if not self.residency.note_op(doc_id, float(rows.shape[0])):
            # Payloads are already landed (wake needs them); the rows
            # park until the doc's slot is restored.
            self._park(idx, doc_id, rows)
            return
        self._buffseq_a[idx] = int(rows[-1, F_SEQ])
        if not self._buffered_rows:
            self._feed_edge = time.perf_counter()
        self._buffers.setdefault(idx, []).append(rows)
        self._buffered_rows += rows.shape[0]
        if self._buffered_rows >= self.max_batch:
            self._boxcar_full()

    def track_trace(self, traces: list) -> None:
        """Register a sampled frame's trace list: its ``device`` span ends
        (and ``device_commit`` begins) when its boxcar dispatches;
        ``device_commit`` ends when that boxcar's health scan is consumed.
        ``feed_wait`` opens here and closes when the feed trigger stages
        the row's boxcar."""
        tracing.stamp(traces, tracing.STAGE_FEED_WAIT, "start")
        self._trace_pending.append(traces)

    def _boxcar_full(self) -> None:
        """The enqueue-time size trigger: in pump mode a full boxcar
        rides the continuous feed (stage + eager dispatch); the one-shot
        path flushes. An injected fault in the tick is counted and
        absorbed (every nested site's recovery already ran)."""
        if self.pump_mode:
            self.pump_feed_absorbed()
        else:
            self.flush()

    # -- residency: fleet-as-cache ---------------------------------------------
    #
    # Invariant: a row addressed to a COLD/WAKING doc NEVER enters
    # _buffers, and a doc with buffered, parked or ring-staged rows NEVER
    # hibernates — between the two, no op is lost.

    def _park(self, idx: int, doc_id: str, rows: np.ndarray) -> None:
        """Park sequenced rows for a COLD/WAKING doc and attempt the wake
        inline. Parked rows advance the buffered high-water mark but stay
        out of the boxcar until the slot is restored; they count into
        ``pressure().queue_frac`` and ``needs_flush``."""
        self._buffseq_a[idx] = max(
            int(self._buffseq_a[idx]), int(rows[-1, F_SEQ])
        )
        self._parked.setdefault(idx, []).append(rows)
        self._parked_rows += rows.shape[0]
        self.residency.begin_wake(doc_id)
        self._try_wake(doc_id)
        if self._buffered_rows >= self.max_batch:
            self._boxcar_full()

    def _unpark(self, idx: int) -> None:
        """Move a woken channel's parked rows into the boxcar buffers, in
        arrival (= seq) order."""
        chunks = self._parked.pop(idx, None)
        if not chunks:
            return
        n = sum(c.shape[0] for c in chunks)
        if not self._buffered_rows:
            self._feed_edge = time.perf_counter()
        self._buffers.setdefault(idx, []).extend(chunks)
        self._buffered_rows += n
        self._parked_rows -= n

    @inject_fault("doc.wake")
    def _wake_commit(self, doc_id: str) -> bool:
        """Restore every COLD channel of ``doc_id`` to a fleet slot and
        release its parked rows. Idempotent: a channel whose cold record
        is already gone just unparks."""
        woke = False
        for key in self._doc_channels.get(doc_id, ()):
            idx = self._index[key]
            with self._wake_mu:
                rec = self._cold.get(key)
                if rec is not None:
                    # Restore BEFORE dropping the cold record: a
                    # concurrent snapshot read must find one or the other.
                    self.fleet.restore_doc(idx, rec[0])
                    del self._cold[key]
                    woke = True
            self._unpark(idx)
        return woke

    def _try_wake(self, doc_id: str) -> bool:
        """One wake attempt under the ``doc.wake`` recovery contract: an
        injected failure leaves the cold state untouched and the rows
        parked; a crash after the restore finishes as a completed wake
        before the crash propagates."""
        head = max(
            (int(self._applied_a[self._index[k]])
             for k in self._doc_channels.get(doc_id, ())),
            default=-1,
        )
        try:
            woke = self._wake_commit(doc_id)
        except faults.InjectedCrash as e:
            if e.completed:
                self.residency.finish_wake(doc_id, "ok", head=head)
            else:
                self.residency.finish_wake(doc_id, "retry")
            raise
        except faults.InjectedFault:
            self.residency.finish_wake(doc_id, "retry")
            retry.retry_counter().inc(site="doc.wake", outcome="retry")
            if journal._ON:
                journal.record(
                    "retry.outcome", site="doc.wake", outcome="retry"
                )
            return False
        self.residency.finish_wake(
            doc_id, "ok" if woke else "noop", head=head
        )
        return True

    def _retry_parked_wakes(self) -> None:
        """The quiescence backstop: re-attempt the wake behind every
        parked channel."""
        for idx in list(self._parked):
            doc_id = self._keys[idx][0]
            if self.residency.is_cold(doc_id):
                self.residency.begin_wake(doc_id)
                self._try_wake(doc_id)

    def _hibernate_plan(
        self, doc_id: str,
    ) -> Optional[Tuple[List[ChannelKey], List[int]]]:
        """The doc's (keys, idxs) when every channel may hibernate, else
        None. Ineligible: buffered or parked rows, rows staged in the
        ingest ring, a tripped err lane (the nack must surface first), or
        an already-evicted slot."""
        keys = self._doc_channels.get(doc_id, [])
        if not keys:
            return None
        staged_docs: set = set()
        for slot in self._ring.staged:
            staged_docs.update(int(d) for d in slot.docs)
        idxs: List[int] = []
        for key in keys:
            idx = self._index[key]
            if (
                self.fleet.placement[idx] is None
                or idx in self._errored
                or idx in self._buffers
                or idx in self._parked
                or idx in staged_docs
            ):
                return None
            idxs.append(idx)
        return keys, idxs

    def hibernate_eligible(self, doc_id: str) -> bool:
        """Whether :meth:`hibernate_doc` would proceed."""
        return self._hibernate_plan(doc_id) is not None

    def hibernate_doc(
        self, doc_id: str, states: Optional[dict] = None,
    ) -> bool:
        """Evict one idle doc's channels from the fleet, keeping the exact
        evicted states as the in-RAM cold tier. ``states`` may carry the
        sweep's batched key->SegmentState gather so the commit skips a
        second readback. Returns False (doc untouched, RESIDENT) when any
        channel is ineligible."""
        plan = self._hibernate_plan(doc_id)
        if plan is None:
            return False
        keys, idxs = plan
        if not self.residency.begin_hibernate(doc_id):
            return False
        head = max(int(self._applied_a[i]) for i in idxs)
        try:
            self._hibernate_commit(doc_id, keys, idxs, states)
        except faults.InjectedCrash as e:
            # After the commit the doc is cold; before, it stays RESIDENT.
            self.residency.finish_hibernate(doc_id, ok=e.completed, head=head)
            raise
        except faults.InjectedFault:
            self.residency.finish_hibernate(doc_id, ok=False)
            retry.retry_counter().inc(
                site="doc.hibernate", outcome="fallback"
            )
            if journal._ON:
                journal.record(
                    "retry.outcome", site="doc.hibernate",
                    outcome="fallback",
                )
            return False
        self.residency.finish_hibernate(doc_id, ok=True, head=head)
        self.hibernations += 1
        return True

    @inject_fault("doc.hibernate")
    def _hibernate_commit(
        self, doc_id: str, keys: List[ChannelKey], idxs: List[int],
        states: Optional[dict],
    ) -> None:
        st: Optional[Dict[int, object]] = None
        if states is not None:
            st = {
                self._index[k]: states[k] for k in keys if k in states
            }
            if len(st) != len(idxs):
                st = None  # partial gather: re-gather inside the fleet
        ev = self.fleet.evict_docs(idxs, st)
        for key, idx in zip(keys, idxs):
            self._cold[key] = (ev[idx], int(self._applied_a[idx]))
            self._since_a[idx] = 0

    # -- the boxcar step -------------------------------------------------------

    def take_errors(self) -> List[ChannelKey]:
        """Drain channels whose err lane tripped since the last drain (the
        service turns these into nacks + telemetry)."""
        out, self._unreported = self._unreported, []
        return out

    def flush(self) -> List[ChannelKey]:
        """Apply every buffered row in batched dispatches; returns
        channels whose sticky err lane tripped since the last report (one
        boxcar stale — :meth:`collect_now` barriers the in-flight scan).

        In ``pump_mode`` the boxcars route through the ingest ring
        (:meth:`pump_stage` / :meth:`pump_dispatch`); ``pump_mode=False``
        keeps the one-shot stage→dispatch→wait path. Staging is gathered
        over busy channels only: the host builds ``[B, K]`` rows for the B
        channels with buffered rows and the device scatters them into each
        pool's dense batch. Each dispatch begins one (count, err) scan and
        consumes the previous one; the per-doc chunk limit is half the
        tier headroom, so a promotion read one boxcar late still fires
        before the doc can overflow."""
        if self._parked_rows:
            self._retry_parked_wakes()
        if self.pump_mode:
            return self._flush_pump()
        return self._flush_oneshot()

    def _stage_host(
        self,
    ) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray, tuple, int]:
        """One boxcar's host assembly, shared by the pump and one-shot
        paths: drain the channel buffers up to each doc's chunk limit
        (the remainder stays buffered for the next boxcar) and advance the
        watermarks. Returns ``(idxs, rows_list, lens, jspans, bid)``."""
        buffers = self._buffers
        n = len(buffers)
        idxs = np.fromiter(buffers.keys(), np.int64, n)
        rows_list = [
            c[0] if len(c) == 1 else np.concatenate(c)
            for c in buffers.values()
        ]
        lens = np.fromiter(
            (r.shape[0] for r in rows_list), np.int64, n
        )
        # Fleet docs chunk to HALF their tier's promotion headroom (the
        # promotion trigger is one boxcar stale); evicted docs (cap < 0)
        # take the raw boxcar limit.
        caps = self.fleet.doc_caps(idxs)
        limits = np.minimum(
            np.where(
                caps > 0,
                np.maximum(
                    1,
                    ((1 - self.fleet.high_water) * caps / 2).astype(
                        np.int64
                    ),
                ),
                self.max_batch,
            ),
            self.max_batch,
        )
        rest: Dict[int, List[np.ndarray]] = {}
        leftover = 0
        over = lens > limits
        if over.any():
            for i in np.flatnonzero(over):
                lim = int(limits[i])
                rest[int(idxs[i])] = [rows_list[i][lim:]]
                rows_list[i] = rows_list[i][:lim]
                leftover += int(lens[i]) - lim
                lens[i] = lim
        self._buffers = rest
        self._buffered_rows = leftover
        # The deadline re-arms from now for chunk-limit leftovers.
        self._feed_edge = time.perf_counter() if leftover else None
        # Rows per channel are seq-ascending: the applied watermark is
        # each chunk's last row.
        seqs = np.fromiter(
            (r[-1, F_SEQ] for r in rows_list), np.int64, n
        )
        self._applied_a[idxs] = np.maximum(self._applied_a[idxs], seqs)
        self._since_a[idxs] += lens
        self.ops_applied += int(lens.sum())
        jspans: tuple = ()
        if journal._ON:
            keys = self._keys
            jspans = tuple(
                (keys[int(idx)][0], int(r[0, F_SEQ]), int(hi))
                for idx, r, hi in zip(idxs, rows_list, seqs)
            )
            journal.record(
                "device.stage", spans=jspans, rows=int(lens.sum())
            )
        self._boxcar_seq += 1
        return idxs, rows_list, lens, jspans, self._boxcar_seq

    def _flush_oneshot(self) -> List[ChannelKey]:
        """The one-shot serving loop (the pump's parity reference)."""
        newly_errored: List[ChannelKey] = []
        staging_s = dispatch_s = routing_s = 0.0
        staged_rows = 0
        while self._buffers:
            # Consume the PREVIOUS dispatch's health scan before routing
            # this round: promotion changes where a doc's rows must go.
            self._consume_pending_scan(newly_errored)
            t0 = time.perf_counter()
            idxs, rows_list, lens, jspans, bid = self._stage_host()
            n = len(idxs)
            if self._sharded:
                shard_sel = np.fromiter(
                    (int(i) in self._sharded for i in idxs), bool, n
                )
                fleet_sel = np.flatnonzero(~shard_sel)
                sharded_rows = {
                    int(idxs[i]): rows_list[i]
                    for i in np.flatnonzero(shard_sel)
                }
            else:
                fleet_sel = np.arange(n)
                sharded_rows = {}
            if fleet_sel.size:
                fleet_docs = idxs[fleet_sel]
                fl = (rows_list if fleet_sel.size == n
                      else [rows_list[i] for i in fleet_sel])
                flens = lens[fleet_sel]
                k = _pow2_at_least(max(int(lens.max()), 8))
                lmax = int(flens.max())
                ops_b = np.zeros((len(fl), k, OP_WIDTH), np.int32)
                if int(flens.min()) == lmax:
                    ops_b[:, :lmax] = np.stack(fl)
                else:
                    for j, rows in enumerate(fl):
                        ops_b[j, : rows.shape[0]] = rows
                t1 = time.perf_counter()
                self.fleet.apply_sparse(fleet_docs, ops_b)
                t2 = time.perf_counter()
                if profiler._ON:
                    # One clock: the same t0/t1/t2 reads feed the profiler
                    # lanes and the staging/dispatch split below.
                    profiler.record(
                        "host_stage", t0, t1, boxcar=bid,
                        rows=int(lens.sum()),
                    )
                    profiler.record("dispatch", t1, t2, boxcar=bid)
                staging_s += t1 - t0
                routing_s += self.fleet.last_routing_s
                dispatch_s += (t2 - t1) - self.fleet.last_routing_s
                staged_rows += ops_b.shape[0] * k
                self._scan_token = self.fleet.begin_scan()
                self._scan_bid = bid
                if jspans:
                    journal.record("device.dispatch", spans=jspans)
                    self._journal_inflight.append(jspans)
            else:
                t1 = time.perf_counter()
                if profiler._ON:
                    profiler.record(
                        "host_stage", t0, t1, boxcar=bid,
                        rows=int(lens.sum()),
                    )
                staging_s += t1 - t0
            self._flushes += 1
            compact_now = self._flushes % self.compact_every == 0
            for idx, rows in sharded_rows.items():
                self._apply_sharded(idx, rows, compact_now)
            if compact_now:
                self.fleet.compact()
        self._buffered_rows = 0
        self._close_pending_traces()
        self.last_flush_breakdown = {
            "staging_s": staging_s,
            "dispatch_s": dispatch_s,
            "routing_s": routing_s,
            "staged_rows": staged_rows,
        }
        self.flush_totals["staging_s"] += staging_s
        self.flush_totals["dispatch_s"] += dispatch_s
        self.flush_totals["routing_s"] += routing_s
        self.flush_totals["staged_rows"] += staged_rows
        self._unreported.extend(newly_errored)
        return newly_errored

    # -- the continuous pump ---------------------------------------------------

    def _flush_pump(self) -> List[ChannelKey]:
        """flush() in pump mode: stage every buffered boxcar through the
        ring and dispatch it. One flush call still applies everything
        buffered; the overlap comes from the async upload and dispatch
        inside, and from continuous feeders calling :meth:`pump_stage` /
        :meth:`pump_dispatch` directly."""
        pre = dict(self.flush_totals)
        newly: List[ChannelKey] = []
        while self._buffers:
            self._pump_stage_counted()
            newly.extend(self.pump_dispatch())
        # Continuous feeders may have staged slots without dispatching.
        newly.extend(self.pump_dispatch())
        self._close_pending_traces()
        self.last_flush_breakdown = {
            key: self.flush_totals[key] - pre[key] for key in pre
        }
        return newly

    def _close_pending_traces(self) -> None:
        """End-of-flush trace closure, shared by both flush paths: traces
        still pending belong to frames whose boxcar was dispatched this
        flush (one-shot path) or whose rows were all replay-dropped —
        close their device span against the (possibly vacuous) in-flight
        scan."""
        if self._scan_token is None:
            self._flush_journal_commits()
        if not self._trace_pending:
            return
        for t in self._trace_pending:
            tracing.stamp(t, tracing.STAGE_FEED_WAIT, "end")
            tracing.stamp(t, tracing.STAGE_DEVICE, "end")
            tracing.stamp(t, tracing.STAGE_DEVICE_COMMIT, "start")
        if self._scan_token is None:
            for t in self._trace_pending:
                tracing.stamp(t, tracing.STAGE_DEVICE_COMMIT, "end")
        else:
            self._trace_inflight.extend(self._trace_pending)
        self._trace_pending = []

    def _flush_journal_commits(self) -> None:
        """Record the commit event of every boxcar whose covering scan has
        been consumed."""
        if self._journal_inflight:
            if journal._ON:
                for sp in self._journal_inflight:
                    journal.record("device.commit", spans=sp)
            self._journal_inflight = []

    def _pump_stage_counted(self) -> bool:
        """Stage one boxcar with the ``pump.stage`` recovery accounting: a
        fault at the staging boundary leaves every row buffered or
        ring-staged, so the next flush, feed tick or :meth:`pump_drain`
        replays it — counted, never silent. A fault from a nested boundary
        (the backpressure dispatch) already counted itself."""
        try:
            return self.pump_stage()
        except faults.InjectedFault as e:
            if e.site == "pump.stage":
                retry.retry_counter().inc(
                    site="pump.stage", outcome="requeue"
                )
                if journal._ON:
                    journal.record(
                        "retry.outcome", site="pump.stage",
                        outcome="requeue",
                    )
            raise

    def _host_buffer(self, shape) -> np.ndarray:
        """A zeroed int32 host buffer for one boxcar: on a card, a numpy
        view of a fresh pinned tensor (the view's base keeps it alive); on
        the CPU, plain numpy."""
        if self.device.type != "cuda":
            return np.zeros(shape, np.int32)
        return torch.zeros(shape, dtype=torch.int32, pin_memory=True).numpy()

    @inject_fault("pump.stage")
    def pump_stage(self) -> bool:
        """Stage ONE boxcar from the channel buffers into a ring slot: host
        assembly into a pinned buffer plus an ASYNC upload (a
        ``non_blocking`` copy on the current stream, so it overlaps the
        previous step's compute). A full ring is backpressure: the oldest
        staged slot dispatches first, so at most ``ring_depth`` uploads
        are in flight. Returns True when a slot was staged.

        Crash-at-boundary contract (the ``pump.stage`` site): a crash
        BEFORE staging leaves every row in the buffers; a crash AFTER
        leaves the staged slot in the ring with its watermarks advanced;
        :meth:`pump_drain` replays exactly what is buffered-or-staged. The
        backpressure dispatch runs before any staging work, so an injected
        dispatch failure never drops the boxcar being staged."""
        if not self._buffers:
            return False
        if self._ring.full():
            self.pump_backpressure += 1
            self._dispatch_one()
        feed_edge = self._feed_edge  # _stage_host re-arms it
        t0 = time.perf_counter()
        traces = self._trace_pending
        self._trace_pending = []
        for t in traces:
            tracing.stamp(t, tracing.STAGE_FEED_WAIT, "end")
            tracing.stamp(t, tracing.STAGE_RING_STAGE, "start")
        idxs, rows_list, lens, jspans, bid = self._stage_host()
        n = len(idxs)
        k = _pow2_at_least(max(int(lens.max()), 8))
        b = _pow2_at_least(n)
        rows_b = self._host_buffer((b, k, OP_WIDTH))
        lmax = int(lens.max())
        if int(lens.min()) == lmax:
            rows_b[:n, :lmax] = np.stack(rows_list)
        else:
            for j, rows in enumerate(rows_list):
                rows_b[j, : rows.shape[0]] = rows
        t_host = time.perf_counter()
        if self.device.type != "cuda":
            dev_rows = torch.from_numpy(rows_b)
        else:
            # Async upload into the slot: the copy is queued on the
            # current stream ahead of the dispatch that reads it.
            dev_rows = rows_b.base.to(self.device, non_blocking=True)
        t_put = time.perf_counter()
        if profiler._ON:
            # One clock, one record site: the same perf_counter reads feed
            # the timeline lanes and staging_s below.
            rows_n = int(lens.sum())
            if feed_edge is not None:
                profiler.record("feed_wait", feed_edge, t0, boxcar=bid,
                                rows=rows_n)
            profiler.record("host_stage", t0, t_host, boxcar=bid,
                            rows=rows_n)
            profiler.record("ring_put", t_host, t_put, boxcar=bid,
                            rows=rows_n)
        for t in traces:
            tracing.stamp(t, tracing.STAGE_RING_STAGE, "end")
        self._ring.push(
            _RingSlot(
                dev_rows, rows_b, idxs, lens, int(lens.sum()),
                traces, jspans, bid,
            )
        )
        self.flush_totals["staging_s"] += (t_host - t0) + (t_put - t_host)
        self.flush_totals["staged_rows"] += b * k
        return True

    def pump_dispatch(self) -> List[ChannelKey]:
        """Dispatch every staged ring slot (oldest first). Returns channels
        whose err lane tripped in the scans consumed along the way (also
        queued for :meth:`take_errors`)."""
        newly: List[ChannelKey] = []
        while len(self._ring):
            newly.extend(self._dispatch_one())
        return newly

    @inject_fault("pump.dispatch")
    def _dispatch_device(self, docs, dev_rows) -> None:
        """The device half of one ring-slot dispatch — the
        ``pump.dispatch`` injection boundary. An INJECTED fault fires
        before the dispatch runs, so the caller's fallback re-applies
        un-applied rows only."""
        self.fleet.dispatch_staged(docs, dev_rows)

    def _dispatch_fallback(self, slot: _RingSlot, in_fleet: np.ndarray) -> None:
        """An injected dispatch failure: apply the slot through the
        one-shot host-staged path (``DocFleet.apply_sparse``, K1 on a
        card) from the slot's host copy — the boxcar is never dropped, and
        the recovery is counted
        (``retry_attempts_total{pump.dispatch,fallback}``)."""
        retry.retry_counter().inc(site="pump.dispatch", outcome="fallback")
        if journal._ON:
            journal.record(
                "retry.outcome", site="pump.dispatch", outcome="fallback"
            )
        n = len(slot.docs)
        sel = np.flatnonzero(in_fleet)
        self.fleet.apply_sparse(slot.docs[sel], slot.host_rows[:n][sel])

    def _dispatch_one(self) -> List[ChannelKey]:
        """Dispatch the oldest staged ring slot: (1) consume the PREVIOUS
        dispatch's health scan (one boxcar stale; promotions it carries
        re-route this slot's docs); (2) scatter + apply
        (``DocFleet.dispatch_staged``); (3) begin this boxcar's scan — the
        pump's only device→host transfer."""
        slot = self._ring.pop()
        newly: List[ChannelKey] = []
        self._consume_pending_scan(newly)
        t0 = time.perf_counter()
        for t in slot.traces:
            tracing.stamp(t, tracing.STAGE_DEVICE, "end")
            tracing.stamp(t, tracing.STAGE_DEVICE_COMMIT, "start")
            tracing.stamp(t, tracing.STAGE_DEVICE_STEP, "start")
        in_fleet = self.fleet.doc_caps(slot.docs) > 0
        if in_fleet.any():
            t_d0 = time.perf_counter()
            try:
                self._dispatch_device(slot.docs, slot.dev_rows)
            except faults.InjectedCrash as e:
                # Crash mid-dispatch: if the dispatch never ran, the slot
                # must survive to the drain (watermarks advanced at stage
                # time, so the replay applies exactly once). After the
                # dispatch the applied state is authoritative — requeueing
                # would double-apply.
                if not e.completed:
                    self._ring.staged.appendleft(slot)
                    retry.retry_counter().inc(
                        site="pump.dispatch", outcome="requeue"
                    )
                    if journal._ON:
                        journal.record(
                            "retry.outcome", site="pump.dispatch",
                            outcome="requeue",
                        )
                else:
                    retry.retry_counter().inc(
                        site="pump.dispatch", outcome="fatal"
                    )
                    journal.retry_outcome("pump.dispatch", "fatal")
                raise
            except faults.InjectedFault:
                self._dispatch_fallback(slot, in_fleet)
            except Exception:
                # A real dispatch failure (a CUDA launch or build error)
                # may have applied a prefix of the slot's pools, so
                # neither a fallback nor a requeue is safe: it is counted
                # and re-raised. The device stage's recovery is the cold
                # restart + deltas-log replay.
                retry.retry_counter().inc(
                    site="pump.dispatch", outcome="fatal"
                )
                journal.retry_outcome("pump.dispatch", "fatal")
                raise
            self._scan_token = self.fleet.begin_scan()
            # One perf_counter read closes the dispatch interval and arms
            # the busy-union edge.
            t_d1 = time.perf_counter()
            self._scan_dispatch_t = t_d1
            self._scan_bid = slot.bid
            if profiler._ON:
                profiler.record(
                    "dispatch", t_d0, t_d1, boxcar=slot.bid,
                    rows=slot.rows,
                )
        if slot.jspans:
            journal.record("device.dispatch", spans=slot.jspans)
            self._journal_inflight.append(slot.jspans)
        for t in slot.traces:
            tracing.stamp(t, tracing.STAGE_DEVICE_STEP, "end")
        if slot.traces:
            if self._scan_token is None:
                for t in slot.traces:
                    tracing.stamp(t, tracing.STAGE_DEVICE_COMMIT, "end")
            else:
                self._trace_inflight.extend(slot.traces)
        self.pump_dispatches += 1
        self._flushes += 1
        compact_now = self._flushes % self.compact_every == 0
        if self._sharded and not in_fleet.all():
            # Docs re-homed into ShardedDocs (possibly by the promotion
            # consumed moments ago): their rows dropped in the scatter, so
            # they apply from the slot's host copy.
            for i in np.flatnonzero(~in_fleet):
                idx = int(slot.docs[i])
                if idx in self._sharded:
                    self._apply_sharded(
                        idx, slot.host_rows[i, : int(slot.lens[i])],
                        compact_now,
                    )
        if compact_now:
            self.fleet.compact_aot()
        routing = self.fleet.last_routing_s if in_fleet.any() else 0.0
        self.flush_totals["dispatch_s"] += (
            time.perf_counter() - t0 - routing
        )
        self.flush_totals["routing_s"] += routing
        self._unreported.extend(newly)
        return newly

    def _apply_sharded(self, idx: int, rows: np.ndarray,
                       compact_now: bool) -> None:
        """Apply one channel's rows to its ShardedDoc, compact on the
        cadence, then let it rebalance (which compacts when it fires)."""
        doc = self._sharded[idx]
        doc.apply(rows)
        if compact_now:
            doc.compact()
        doc.rebalance()

    def pump_drain(self) -> List[ChannelKey]:
        """Shutdown drain: stage whatever is still buffered, dispatch every
        in-flight ring slot, and barrier the final health scan. No op is
        lost and none duplicates — also after an injected crash at
        ``pump.stage`` or a pre-dispatch crash at ``pump.dispatch``."""
        newly = list(self.flush())
        newly.extend(self.collect_now())
        return newly

    # -- the continuous front door ---------------------------------------------

    @inject_fault("pump.feed")
    def pump_feed(self) -> List[ChannelKey]:
        """The streaming boxcar trigger: stage the buffered rows as soon
        as they reach ``max_batch`` (size trigger) or ``feed_deadline_ms``
        has elapsed since the oldest buffered row arrived (deadline
        trigger), then dispatch every staged slot eagerly. Between
        triggers this is a cheap no-op. A feed stages through the same
        ``pump_stage``/``_dispatch_one`` machinery as flush(), so its state
        is bit-exact against the quiescence path.

        Crash contract (the ``pump.feed`` site): a crash leaves every row
        buffered (fail / crash-before) or the feed complete (crash-after);
        the stage-time watermarks prevent duplicates either way."""
        if self._buffers:
            trigger = None
            if self._buffered_rows >= self.max_batch:
                trigger = "size"
            elif (
                self._feed_edge is not None
                and time.perf_counter() - self._feed_edge
                >= self.feed_deadline_ms / 1e3
            ):
                trigger = "deadline"
            if trigger is not None:
                self.feed_triggers[trigger] += 1
                self._pump_stage_counted()
                # Chunk-limit leftovers at or above a full boxcar keep
                # staging now; smaller remainders ride the re-armed
                # deadline.
                while self._buffers and (
                    self._buffered_rows >= self.max_batch
                ):
                    self.feed_triggers["size"] += 1
                    self._pump_stage_counted()
        # Eager dispatch: every staged slot (including one requeued by a
        # dispatch crash) goes to the device now.
        return self.pump_dispatch()

    def pump_feed_counted(self) -> List[ChannelKey]:
        """:meth:`pump_feed` with the ``pump.feed`` site's recovery
        accounting: a fault at the feed boundary leaves the rows buffered
        (``requeue``), a crash-after leaves the feed complete (``fatal``).
        Faults from nested boundaries already counted themselves."""
        try:
            return self.pump_feed()
        except faults.InjectedFault as e:
            if e.site == "pump.feed":
                outcome = (
                    "fatal"
                    if isinstance(e, faults.InjectedCrash) and e.completed
                    else "requeue"
                )
                retry.retry_counter().inc(
                    site="pump.feed", outcome=outcome
                )
                if outcome == "fatal":
                    journal.retry_outcome("pump.feed", "fatal")
                elif journal._ON:
                    journal.record(
                        "retry.outcome", site="pump.feed",
                        outcome="requeue",
                    )
            raise

    def pump_feed_absorbed(self) -> List[ChannelKey]:
        """One opportunistic feed tick: :meth:`pump_feed_counted` with any
        INJECTED fault absorbed (its recovery already ran and was counted;
        the quiescence flush or the next tick is the backstop). Any other
        exception propagates."""
        try:
            return self.pump_feed_counted()
        except faults.InjectedFault:
            return []

    def pressure(self) -> PressureSignal:
        """The typed backpressure signal: ring occupancy, queue depth and
        feed latency. Pure host state — no device round trip."""
        lag_ms = 0.0
        if self._feed_edge is not None and self._buffered_rows:
            lag_ms = (time.perf_counter() - self._feed_edge) * 1e3
        return PressureSignal(
            ring_frac=len(self._ring) / self._ring.depth,
            # Parked wake-pending rows count as queue depth.
            queue_frac=(self._buffered_rows + self._parked_rows)
            / max(1, self.max_batch),
            feed_lag_ms=lag_ms,
            scan_inflight=self._scan_token is not None,
        )

    def needs_flush(self, min_rows: int = 1) -> bool:
        """True when a flush would do work: buffered rows at/above
        ``min_rows``, staged ring slots, err channels not yet surfaced, or
        parked rows."""
        return (
            self._buffered_rows >= max(1, int(min_rows))
            or len(self._ring) > 0
            or bool(self._unreported)
            or self._parked_rows > 0
        )

    def needs_scan_drain(self) -> bool:
        """True when a health scan is still streaming back."""
        return self._scan_token is not None

    def prefetch_scan(self):
        """The in-flight scan token still needing its off-thread transfer,
        or None (also when its prefetch is already installed)."""
        if (
            self._scan_prefetch is not None
            and self._scan_prefetch[0] is self._scan_token
        ):
            return None
        return self._scan_token

    @staticmethod
    def scan_transfer(token) -> Dict[int, np.ndarray]:
        """The blocking device→host half of one scan consume: wait on each
        pool's CUDA event and copy its pinned buffer (cap -> [2, n_slots]).
        Safe off the serving thread; hand the result to
        :meth:`scan_prefetched`. It is the same one-boxcar-stale transfer
        the pump runs inline, moved, not an extra one."""
        out = {}
        for cap, (buf, event, _gen) in token.items():
            if event is not None:
                event.synchronize()
            out[cap] = buf.numpy().copy()
        return out

    def scan_prefetched(self, token, host: Dict[int, np.ndarray]) -> None:
        """Install an off-thread :meth:`scan_transfer` result: the next
        scan consume uses it instead of blocking, if the token is still the
        in-flight one (else the prefetch is dropped)."""
        self._scan_prefetch = (token, host)

    def _consume_pending_scan(self, newly: List[ChannelKey]) -> None:
        """Consume the in-flight health scan, if any: the pump's one
        readback (one boxcar stale). Closes the traced ``scan_consume``
        spans and folds the dispatch→readback wall into ``pump_busy_s``
        (on a card the readback is the CUDA event wait in
        ``finish_scan``)."""
        if self._scan_token is None:
            return
        for t in self._trace_inflight:
            tracing.stamp(t, tracing.STAGE_SCAN_CONSUME, "start")
        t_c0 = time.perf_counter()
        host = None
        if self._scan_prefetch is not None:
            tok, pre = self._scan_prefetch
            self._scan_prefetch = None
            if tok is self._scan_token:
                host = pre
        scans = self.fleet.finish_scan(self._scan_token, host=host)
        self._scan_token = None
        now = time.perf_counter()
        scan_bid, self._scan_bid = self._scan_bid, -1
        if profiler._ON:
            profiler.record("scan_consume", t_c0, now, boxcar=scan_bid)
        if self._scan_dispatch_t is not None:
            # Union of dispatch->readback intervals (ordered, so a running
            # edge suffices); device_step comes from the same floats.
            start = max(self._scan_dispatch_t, self._busy_edge)
            if now > start:
                self.pump_busy_s += now - start
                if profiler._ON:
                    profiler.record(
                        "device_step", start, now, boxcar=scan_bid
                    )
            self._busy_edge = now
            self._scan_dispatch_t = None
        for t in self._trace_inflight:
            tracing.stamp(t, tracing.STAGE_SCAN_CONSUME, "end")
        # The scan consume IS the commit signal of every in-flight boxcar.
        self._flush_journal_commits()
        self._consume_scan(scans, newly)

    def _consume_scan(
        self, scans: Dict[int, np.ndarray],
        newly_errored: List[ChannelKey],
    ) -> None:
        """Run the health consequences of one (count, err) pool scan: tier
        promotion and demotion, and sticky-err collection."""
        if self._trace_inflight:
            for t in self._trace_inflight:
                tracing.stamp(t, tracing.STAGE_DEVICE_COMMIT, "end")
            self._trace_inflight = []
        counts = {cap: s[0] for cap, s in scans.items()}
        errs = {cap: s[1] for cap, s in scans.items()}
        self.fleet.check_and_migrate(counts)
        # Demotion rides the same one-boxcar-stale scan counts.
        self.fleet.check_and_demote(counts)
        if self.sharded_overflow:
            self._promote_overflow()
        newly_errored.extend(self._collect_errors(errs))

    def collect_now(self) -> List[ChannelKey]:
        """Barrier the in-flight health scan: errors reflect every
        dispatched boxcar (the scan began after the final dispatch)."""
        if self._scan_token is None:
            return []
        newly: List[ChannelKey] = []
        self._consume_pending_scan(newly)
        self._unreported.extend(newly)
        return newly

    def _promote_overflow(self) -> None:
        """Re-home docs that outgrew the top fleet tier into ShardedDocs
        (the segment table spread over the device list, positions resolved
        by the per-op offset exchange, ``parallel/sharded_doc.py``)."""
        over = [i for i in self.fleet.overflowing_docs()
                if i not in self._promotion_refused]
        if not over:
            return
        # Total sharded capacity is 8x the top fleet tier whatever the
        # device count (one device must still grow the document: on one
        # card a shard of 8 x max_capacity rows, on the kernels' split
        # tier). Checked before anything moves: on a card a shard cap past
        # the kernels' largest tier (2**30 rows) is refused, and the docs
        # run on in their top-tier slots until they trip ERR_CAPACITY.
        devs = mesh_devices()
        shard_cap = -(-8 * self.fleet.max_capacity // len(devs))
        try:
            check_shard_cap(shard_cap, self.fleet.kernel, devs)
        except ValueError:
            self._promotion_refused.update(over)
            return
        # Promotion is irreversible and takes every device for one
        # document: reclaim tombstones first so only live growth promotes.
        self.fleet.compact()
        for idx in self.fleet.overflowing_docs():
            if idx in self._promotion_refused:
                continue
            state = self.fleet.evict_doc(idx)
            doc = ShardedDoc(shard_cap=shard_cap, kernel=self.fleet.kernel)
            doc.load_single(state)
            self._sharded[idx] = doc

    def _collect_errors(
        self, errs: Optional[Dict[int, np.ndarray]] = None
    ) -> List[ChannelKey]:
        out: List[ChannelKey] = []
        for cap, pool in self.fleet.pools.items():
            err = errs.get(cap) if errs is not None else None
            if err is None:
                # A pool the scan did not cover: a synchronous copy.
                err = _host(pool.scalars[:, SC_ERR])  # (gathered on a mesh)
            if len(err) < pool.n_slots:
                err = np.concatenate(
                    [err, np.zeros(pool.n_slots - len(err), np.int32)]
                )
            live = pool.live_slots()
            for slot in live[err[live] != 0]:
                idx = int(pool.doc_of_slot[slot])
                if idx not in self._errored:
                    self._errored.add(idx)
                    out.append(self._keys[idx])
        for idx, doc in self._sharded.items():
            if doc.err != 0 and idx not in self._errored:
                self._errored.add(idx)
                out.append(self._keys[idx])
        if out and journal._ON:
            # One journal event per newly errored channel and one
            # auto-dump with the lineage of the ops that tripped it.
            for doc_id, address in out:
                journal.record("device.err", doc=doc_id, addr=address)
            journal.auto_dump("err_lane")
        return out

    def _doc_state(self, idx: int):
        if idx in self._sharded:
            return self._sharded[idx].to_single()
        key = self._keys[idx]
        if key in self._cold:
            return self._cold[key][0]
        return self.fleet.doc_state(idx)

    # -- the read path ---------------------------------------------------------

    def read_start(self, keys: List[ChannelKey]) -> dict:
        """The serving-thread half of one batched snapshot read: resolve
        channel keys to fleet slots, read sharded-overflow docs whole
        (they live outside the pools) and start the fleet's batched device
        gather. Returns a token whose ``dev`` vector may be transferred
        off the serving thread (:meth:`read_transfer`) before
        :meth:`read_finish`. A faulted gather (the ``read.gather`` site)
        falls back to per-doc gathers here, counted, never silent."""
        order: List[Tuple[ChannelKey, int]] = [
            (key, self._index[key]) for key in keys
        ]
        sharded = {
            idx: self._sharded[idx].to_single()
            for _key, idx in order if idx in self._sharded
        }
        # COLD channels serve straight from their cold records — a read
        # never wakes a doc.
        cold = {
            idx: self._cold[key][0]
            for key, idx in order if key in self._cold
        }
        fleet_idxs = [idx for _key, idx in order
                      if idx not in sharded and idx not in cold]
        dev = layout = fallback = None
        if fleet_idxs:
            try:
                dev, layout = self._gather_start(fleet_idxs)
            except faults.InjectedFault:
                retry.retry_counter().inc(
                    site="read.gather", outcome="fallback"
                )
                if journal._ON:
                    journal.record(
                        "retry.outcome", site="read.gather",
                        outcome="fallback",
                    )
                self.read_gather_fallbacks += 1
                self.read_gathers += len(fleet_idxs)
                fallback = {
                    idx: self.fleet.doc_state(idx) for idx in fleet_idxs
                }
            else:
                self.read_gathers += 1
        return {
            "order": order, "sharded": sharded, "cold": cold,
            "dev": dev, "layout": layout, "fallback": fallback,
        }

    @inject_fault("read.gather")
    def _gather_start(self, idxs: List[int]):
        """The injected device half of one batched gather (no readback)."""
        return self.fleet.doc_states_start(idxs)

    @staticmethod
    def read_transfer(dev) -> np.ndarray:
        """The blocking device→host half of one read batch (a copy), safe
        off the serving thread."""
        return DocFleet.doc_states_transfer(dev)

    def read_finish(
        self, token: dict, host: Optional[np.ndarray] = None
    ) -> Dict[ChannelKey, "object"]:
        """Split one read batch into per-channel states and advance the
        amortization counters."""
        states: Dict[int, object] = {}
        if token["fallback"] is not None:
            states.update(token["fallback"])
        elif token["dev"] is not None:
            if host is None:
                host = self.read_transfer(token["dev"])
            states.update(
                DocFleet.doc_states_finish(host, token["layout"])
            )
        states.update(token["sharded"])
        states.update(token["cold"])
        self.reads_served += len(token["order"])
        return {key: states[idx] for key, idx in token["order"]}

    def doc_states(
        self, keys: List[ChannelKey]
    ) -> Dict[ChannelKey, "object"]:
        """N channels' device states with ONE batched readback; a faulted
        device gather falls back to per-doc gathers (the ``read.gather``
        recovery contract)."""
        if not keys:
            return {}
        return self.read_finish(self.read_start(keys))

    @property
    def reads_per_device_dispatch(self) -> float:
        """Snapshot reads served per device gather dispatch."""
        return self.reads_served / max(1, self.read_gathers)

    def text_from_state(self, key: ChannelKey, state) -> str:
        """Materialize one gathered state against the channel's payloads."""
        return materialize(state, self.payloads[key])

    def summary_from_state(self, key: ChannelKey, h) -> dict:
        """One gathered state in the client ``summarize_core`` lane
        format."""
        n = int(h.count)
        self._since_a[self._index[key]] = 0
        return {
            "lanes": {
                lane: np.asarray(getattr(h, lane))[:n].tolist()
                for lane in SEGMENT_LANES
            },
            "count": n,
            "min_seq": int(h.min_seq),
            "cur_seq": int(h.cur_seq),
            "payloads": dict(self.payloads[key]),
            "intervals": {},
        }

    def text(self, doc_id: str, address: str) -> str:
        """Serve the channel's current text from device state (a batch of
        one through the batched read path)."""
        key = (doc_id, address)
        if key not in self._index:
            return ""
        self.flush()
        return self.text_from_state(key, self.doc_states([key])[key])

    def channel_summary(self, doc_id: str, address: str) -> Optional[dict]:
        """Channel summary in the client ``summarize_core`` lane format,
        read back from the device. None for unknown channels."""
        key = (doc_id, address)
        if key not in self._index:
            return None
        self.flush()
        return self.summary_from_state(key, self.doc_states([key])[key])

    def dirty_channels(self, threshold: int = 1) -> List[ChannelKey]:
        """Channels with >= threshold ops applied (or buffered) since their
        last summary readback — the device scribe's work list."""
        n = len(self._keys)
        pending = np.zeros(n, np.int64)
        for idx, chunks in self._buffers.items():
            pending[idx] = sum(c.shape[0] for c in chunks)
        hot = np.flatnonzero(self._since_a[:n] + pending >= threshold)
        return [self._keys[i] for i in hot]

    def _telemetry_start(self):
        """The serving-thread half of one scrape: the device telemetry
        vector — the fleet's pools plus a ``"sharded"`` row per device-list
        shard covering every sharded-overflow doc — and a snapshot of the
        host-side totals."""
        dev, layout = self.fleet._telemetry_device()
        if self._sharded:
            docs = [self._sharded[i] for i in sorted(self._sharded)]
            # The doc axis pads to pow2 with dead rows, as the reference's.
            pad = _pow2_at_least(len(docs))
            sc = torch.stack([d.device_scalars().to(self.device)
                              for d in docs])
            sc = torch.cat([sc, torch.zeros(
                (pad - len(docs),) + tuple(sc.shape[1:]), dtype=sc.dtype,
                device=sc.device)])
            live = torch.arange(pad, device=sc.device) < len(docs)
            sh = _stacked_docs_telemetry(
                live, sc[..., SC_COUNT], sc[..., SC_ERR],
                sc[..., SC_MIN_SEQ], sc[..., SC_CUR_SEQ],
            )
            layout = layout + [("sharded", sh.shape[0])]
            dev = torch.cat([dev, sh.reshape(-1)])
        totals = {
            "ops_applied": self.ops_applied,
            "flushes": self._flushes,
            "buffered_rows": self._buffered_rows,
            "channels": len(self._keys),
            "sharded_docs": len(self._sharded),
            "reads_served": self.reads_served,
            "read_gathers": self.read_gathers,
        }
        return dev, layout, totals

    @staticmethod
    def _telemetry_readback(dev) -> np.ndarray:
        """The blocking device→host copy of one scrape."""
        return _host(dev)

    @staticmethod
    def _telemetry_finish(host: np.ndarray, layout, totals: dict) -> dict:
        """Split one scrape's readback into the telemetry dict."""
        return {
            "shards": {
                str(cap): arr
                for cap, arr in split_telemetry(host, layout).items()
            },
            "cols": TELEMETRY_COLS,
            **totals,
        }

    def telemetry(self) -> dict:
        """One scrape's worth of device telemetry (the fleet's per-pool
        lanes) in ONE batched readback, plus the host-side totals."""
        dev, layout, totals = self._telemetry_start()
        return self._telemetry_finish(
            self._telemetry_readback(dev), layout, totals
        )

    def publish_metrics(self, registry=None, scrape: Optional[dict] = None) -> dict:
        """Fold one :meth:`telemetry` scrape into per-pool registry gauges.
        ``scrape`` lets a caller pass a scrape it already read back."""
        reg = registry or metrics.REGISTRY
        tel = scrape if scrape is not None else self.telemetry()
        shard_g = reg.gauge(
            "device_shard_telemetry",
            "per-pool/per-mesh-shard device lanes (one readback/scrape)",
            labelnames=("pool", "shard", "col"),
        )
        for cap, arr in tel["shards"].items():
            for shard in range(arr.shape[0]):
                for i, col in enumerate(tel["cols"]):
                    shard_g.set(
                        int(arr[shard, i]),
                        pool=str(cap), shard=str(shard), col=col,
                    )
        totals = reg.gauge(
            "device_backend_totals",
            "host-side device-backend commit totals",
            labelnames=("key",),
        )
        for key in ("ops_applied", "flushes", "buffered_rows", "channels",
                    "sharded_docs", "reads_served", "read_gathers"):
            totals.set(tel[key], key=key)
        reg.gauge(
            "reads_per_device_dispatch",
            "snapshot reads served per batched device gather dispatch",
        ).set(round(self.reads_per_device_dispatch, 3))
        self.residency.publish_metrics(reg)
        return tel

    def stats(self) -> dict:
        s = self.fleet.stats()
        s["docs_with_errors"] += sum(
            1 for d in self._sharded.values() if d.err != 0
        )
        s.update(
            channels=len(self._keys),
            ops_applied=self.ops_applied,
            buffered=self._buffered_rows,
            flushes=self._flushes,
            sharded_docs=len(self._sharded),
            sharded_rows=sum(
                d.rows_in_use() for d in self._sharded.values()
            ),
            promotions_refused=len(self._promotion_refused),
            pump_mode=self.pump_mode,
            ring_staged=len(self._ring),
            pump_dispatches=self.pump_dispatches,
            pump_backpressure=self.pump_backpressure,
            feed_size_triggers=self.feed_triggers["size"],
            feed_deadline_triggers=self.feed_triggers["deadline"],
            reads_served=self.reads_served,
            read_gathers=self.read_gathers,
            read_gather_fallbacks=self.read_gather_fallbacks,
            reads_per_device_dispatch=round(
                self.reads_per_device_dispatch, 3
            ),
            hibernations=self.hibernations,
            cold_channels=len(self._cold),
            parked_rows=self._parked_rows,
            residency=self.residency.stats(),
        )
        return s
