"""TpuFleetService — the fleet-scale serving path, on PyTorch + CUDA.

Counterpart of ``fluidframework_tpu/service/fleet_service.py`` (the name is
kept so each module's counterpart is easy to find). One service owns
``n_docs`` documents whose merge state lives on the card as packed int32
tables ``[15, D, S]`` and scalars ``[D, 8]``:

- **ticketing**: the native C++ batch ticket loop (``FleetSequencer``)
  stamps seq/msn for every document in one call; per-doc failures surface
  as nacks, never as silent drops;
- **apply**: each sequenced round crosses to the device as one flat int8
  buffer (the width-adaptive op wire), is inflated to kernel rows on the
  device, and is applied by the hand-written CUDA kernels — K3 (apply +
  compact in one launch) on compact rounds, K1 otherwise, K2 for a
  compaction outside the cadence — which update the tables in place;
- **scribe**: summaries come from device state — dirtiness is one [D, 2]
  scalar readback, then only dirty documents' table slices come back,
  affine-encoded to int8 per document, and are serialized into ONE
  content-addressed pack blob per sweep.

Device-to-host copies start on pinned buffers with ``non_blocking=True``
and a CUDA event that the reader waits on. Pass ``device="cpu"`` to run
every kernel's plain PyTorch version (the tests do).
"""

from __future__ import annotations

import json
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fluidframework_tpu_torch.ops.apply_kernel import (
    SC_COUNT,
    SC_CUR_SEQ,
    SC_ERR,
    SC_MIN_SEQ,
    apply_ops_packed,
    pack_state,
)
from fluidframework_tpu_torch.ops.compact_kernel import (
    apply_compact_packed,
    compact_packed,
)
from fluidframework_tpu_torch.ops.segment_state import (
    SEGMENT_LANES,
    SegmentState,
    make_batched_state,
    materialize,
)
from fluidframework_tpu_torch.parallel.fleet import (
    TELEMETRY_COLS,
    _scalars_telemetry,
)
from fluidframework_tpu_torch.parallel.mesh import unpack_packed_doc_states
from fluidframework_tpu_torch.protocol.constants import (
    F_ARG,
    F_CLIENT,
    F_LEN,
    F_LSEQ,
    F_MSN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    NO_CLIENT,
    RSEQ_NONE,
)
from fluidframework_tpu_torch.service.fleet_sequencer import FleetSequencer
from fluidframework_tpu_torch.service.summary_store import SummaryStore
from fluidframework_tpu_torch.utils import pow2_at_least, resolve_device

_I32 = torch.int32

# Canonical background per lane: a live row whose lane equals this value
# carries no information — such lanes are dropped from the scribe transfer
# and reconstructed at load time.
_LANE_DEFAULTS_HOST = np.asarray(
    [RSEQ_NONE if name == "rseq" else 0 for name in SEGMENT_LANES],
    np.int32,
)

# Bitmask lanes carry full 31-bit removed-by sets and ship verbatim int32;
# every other lane affine-encodes into the int8 window.
_MASK_LANE_IDX = frozenset(
    i for i, name in enumerate(SEGMENT_LANES) if name.startswith("rbits")
)
_RSEQ_IDX = SEGMENT_LANES.index("rseq")


def _split_lane_set(lane_set):
    """Partition a shipped-lane tuple into (int8 affine lanes, int32
    verbatim lanes)."""
    u8 = tuple(i for i in lane_set if i not in _MASK_LANE_IDX)
    m32 = tuple(i for i in lane_set if i in _MASK_LANE_IDX)
    return u8, m32


def _pick_width(lo: int, hi: int) -> int:
    if -128 <= lo and hi <= 127:
        return 1
    if -32768 <= lo and hi <= 32767:
        return 2
    return 4


class _HostCopy:
    """A device tensor's copy to the host, started now and waited on later:
    a pinned buffer filled with ``non_blocking=True`` and a CUDA event on
    the current stream. On the CPU the tensor is already on the host."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array (pinned + non-blocking on CUDA; a private copy
    on the CPU, so the caller may reuse its array)."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _expand_wire(buf: torch.Tensor, widths, d: int, k: int) -> torch.Tensor:
    """Inflate the width-adaptive op wire back to kernel rows [D, K, 10]
    ON DEVICE. ``buf`` is ONE flat int8 upload: eight planar field segments
    — (type, pos1, pos2, arg, len, client, ref_delta, msn_delta), each at the
    narrowest of int8/int16/int32 that held the round's range — followed by
    a [D, 2] int32 (seq0, alive) block. Seq is synthesized from each doc's
    first stamped seq (consecutive seqs per doc per round), ref/msn rebased
    off the same base, lseq 0. A refused doc's ``alive`` = 0 zeroes its
    stamps. Segments at odd byte offsets are cloned before their dtype
    view (a view needs an aligned storage offset)."""
    cols = []
    o = 0
    for w in widths:
        n = d * k * w
        seg = buf[o: o + n]
        o += n
        if w == 1:
            v = seg.to(_I32)
        elif w == 2:
            v = seg.clone().view(torch.int16).to(_I32)
        else:
            v = seg.clone().view(_I32)
        cols.append(v.reshape(d, k))
    base = buf[o: o + d * 8].clone().view(_I32).reshape(d, 2)
    ty, pos1, pos2, arg, ln, client, ref_d, msn_d = cols
    seq0 = base[:, 0:1]
    alive = base[:, 1:2]
    seq = (seq0 + torch.arange(k, dtype=_I32, device=buf.device)[None]) * alive
    z = torch.zeros((d, k), dtype=_I32, device=buf.device)
    out = [
        ty,                         # F_TYPE
        pos1,                       # F_POS1
        pos2,                       # F_POS2
        seq,                        # F_SEQ
        (seq0 + ref_d) * alive,     # F_REF
        client,                     # F_CLIENT
        z,                          # F_LSEQ
        arg,                        # F_ARG
        ln,                         # F_LEN
        (seq0 + msn_d) * alive,     # F_MSN
    ]
    return torch.stack(out, dim=-1)


def _scan_slim(scalars: torch.Tensor) -> torch.Tensor:
    """The scribe's [D, 2] (count, cur_seq) dirtiness scan."""
    return torch.stack([scalars[:, SC_COUNT], scalars[:, SC_CUR_SEQ]], dim=1)


def _scribe_gather(tables, scalars, idx, u8, m32, rows) -> torch.Tensor:
    """Device half of one scribe bucket: gathers the dirty docs' tables,
    truncates rows to the bucket, and produces the ONE flat int8 buffer
    that crosses to the host:

    - the ``u8`` lanes affine-encode as ``value - doc_lane_base - 128``
      int8 with per-document bases (rseq's RSEQ_NONE sentinel maps to code
      254);
    - the ``m32`` (bitmask) lanes ride verbatim int32, followed by the
      bases, the [L] lane-occupancy witness, the range-fit flag, and the
      gathered scalar rows, bitcast into the int8 stream.

    The fit flag guards the affine encoding (a failed check re-gathers
    that bucket verbatim)."""
    dev = tables.device
    sub = tables.index_select(1, idx)[:, :, :rows]  # [L, nb, rows]
    counts = scalars[:, SC_COUNT].index_select(0, idx)
    live = torch.arange(rows, device=dev)[None, :] < counts[:, None]
    defaults = torch.from_numpy(_LANE_DEFAULTS_HOST).to(dev)
    occ = ((sub != defaults[:, None, None]) & live[None]).flatten(1).any(1)
    scal_sub = scalars.index_select(0, idx)  # [nb, N_SCALARS]
    big = 2**31 - 1
    if u8:
        su = sub[list(u8)]  # [L8, nb, rows]
        is_rseq = torch.tensor(
            [SEGMENT_LANES[i] == "rseq" for i in u8], device=dev
        )[:, None, None]
        sent = (su == RSEQ_NONE) & is_rseq
        val_ok = live[None] & ~sent
        lo = torch.where(val_ok, su, big).amin(dim=2)  # [L8, nb]
        hi = torch.where(val_ok, su, -big).amax(dim=2)
        base = torch.where(hi >= lo, lo, 0)
        fits = (torch.where(hi >= lo, hi - base, 0) < 254).all()
        u = torch.where(sent, 254, su - base[:, :, None])
        enc8 = (u - 128).to(torch.int8).reshape(-1)
    else:
        base = torch.zeros((0, idx.shape[0]), dtype=_I32, device=dev)
        fits = torch.ones((), dtype=torch.bool, device=dev)
        enc8 = torch.zeros((0,), dtype=torch.int8, device=dev)
    masks = (
        sub[list(m32)].reshape(-1) if m32
        else torch.zeros((0,), dtype=_I32, device=dev)
    )
    i32 = torch.cat([
        masks,
        base.reshape(-1).to(_I32),
        occ.to(_I32),
        fits.to(_I32).reshape(1),
        scal_sub.reshape(-1).to(_I32),
    ])
    return torch.cat([enc8, i32.view(torch.int8)])


class TpuFleetService:
    """Serve ``n_docs`` documents from device-resident merge state with
    native batch ticketing and device-scribe summaries."""

    def __init__(
        self,
        n_docs: int,
        capacity: int = 128,
        store: Optional[SummaryStore] = None,
        compact_every: int = 1,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.capacity = capacity
        self.compact_every = compact_every
        self.fseq = FleetSequencer(n_docs)
        self.tables, self.scalars = pack_state(
            make_batched_state(n_docs, capacity, NO_CLIENT, device=self.device)
        )
        self.store = store or SummaryStore()
        self.rounds_applied = 0
        self.summary_writes = 0
        self.last_ticket_s = 0.0  # host ticket-loop time of the last round
        self.wire16_rounds = 0  # rounds shipped on the packed op wire
        self.wire32_rounds = 0  # rounds that fell back to verbatim int32
        # Sticky per-field wire widths (monotone widening).
        self._wire_widths = (1,) * 8
        # Device-scribe watermark: last summarized seq per doc (host [D]).
        self._summarized_seq = np.zeros(n_docs, np.int64)
        # doc -> (bucket record, index in bucket): the pack-blob index.
        self._summary_handles: Dict[int, tuple] = {}
        # Adaptive lane set shipped per sweep: grows the moment the
        # occupancy witness shows a lane outside the set went live (that
        # sweep re-gathers in full); shrinks only after a lane has read
        # unoccupied for 3 consecutive sweeps.
        self._lane_set: Tuple[int, ...] = tuple(range(len(SEGMENT_LANES)))
        self._lane_idle = np.zeros(len(SEGMENT_LANES), np.int32)
        self.last_summary_breakdown: Dict[str, float] = {}
        # Scribe sweeps still reading the current tables: while any is
        # open, a commit writes fresh buffers instead of updating in place
        # (copy-on-write), so the sweep keeps describing the state at its
        # begin.
        self._sweeps = weakref.WeakSet()

    # -- front door ------------------------------------------------------------

    def join_writer(self, slot: int = 0) -> np.ndarray:
        """Admit writer ``slot`` on every document; returns join seqs."""
        return self.fseq.join_all(slot=slot)

    def submit_round(
        self, intents: np.ndarray, rows: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One sequenced boxcar: ``intents [D, K, 3]`` = (client, cseq,
        ref) tickets, ``rows [D, K, OP_WIDTH]`` the matching kernel ops
        with seq fields unstamped (the input is never mutated). Returns
        ``(err, stamped)``: the per-doc ticket error lane (nonzero = that
        document's round was refused and NOT applied; the caller nacks it)
        and the sequenced rows as applied (refused docs zeroed to NOOPs)."""
        return self.commit_round(self.stage_round(intents, rows))

    def stage_round(
        self, intents: np.ndarray, rows: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
        """Ticket + stamp one boxcar and START its device upload (async).
        Returns an opaque token for :meth:`commit_round`."""
        t0 = time.perf_counter()
        out, err = self.fseq.ticket_batch(intents)
        self.last_ticket_s = time.perf_counter() - t0
        rows = np.array(rows, np.int32)  # private stamped copy
        rows[:, :, F_SEQ] = out[:, :, 0]
        rows[:, :, F_REF] = intents[:, :, 2]
        rows[:, :, F_MSN] = out[:, :, 1]
        rows[:, :, F_CLIENT] = intents[:, :, 0]
        if err.any():
            rows[err != 0] = 0  # refused documents apply nothing (NOOPs)
        ops = self._upload_round(rows, out, err)
        return (err, rows, ops)

    def commit_round(self, token) -> Tuple[np.ndarray, np.ndarray]:
        """Apply the staged boxcar: K3 (apply + compact, one launch) when
        this round is due a compaction, else K1. The tables update in place
        unless an open scribe sweep still reads them."""
        err, rows, ops = token
        compact_due = (self.rounds_applied + 1) % self.compact_every == 0
        fn = apply_compact_packed if compact_due else apply_ops_packed
        self.tables, self.scalars = fn(self.tables, self.scalars, ops,
                                       out=self._commit_buffers())
        self.rounds_applied += 1
        return err, rows

    def compact(self) -> None:
        """Compact every document now with K2, outside the round cadence:
        reclaim tombstones at or below each doc's collab window, squeeze
        the live rows and re-merge split siblings (a service running
        ``compact_every > 1`` calls it before a pause or a cadence
        change, so the tables do not carry tombstones across)."""
        self.tables, self.scalars = compact_packed(
            self.tables, self.scalars, out=self._commit_buffers()
        )

    def _commit_buffers(self):
        """Where a state update writes: in place (None), or fresh buffers
        while an open scribe sweep still reads the current ones."""
        if not len(self._sweeps):
            return None
        return torch.empty_like(self.tables), torch.empty_like(self.scalars)

    def _upload_round(self, rows: np.ndarray, out: np.ndarray,
                      err: np.ndarray) -> torch.Tensor:
        """Ship one stamped boxcar to the device. Fast path: the width-
        adaptive planar wire (one flat int8 buffer, each field at the
        narrowest dtype holding the round's range) with seq stamps
        synthesized on device; any structural mismatch falls back to the
        verbatim int32 upload for the whole round (counted)."""
        d, k = rows.shape[0], rows.shape[1]
        seq0 = out[:, 0, 0].astype(np.int64)
        alive = (err == 0).astype(np.int64)
        ref_d = (
            rows[:, :, F_REF].astype(np.int64) - seq0[:, None]
        ) * alive[:, None]
        msn_d = (
            rows[:, :, F_MSN].astype(np.int64) - seq0[:, None]
        ) * alive[:, None]
        seq_ok = (
            rows[:, :, F_SEQ]
            == (seq0[:, None] + np.arange(k)) * alive[:, None]
        ).all()
        if not (
            seq_ok
            and (rows[:, :, F_LSEQ] == 0).all()
            and seq0.max() < 2**31 - k
        ):
            self.wire32_rounds += 1
            return _to_device(rows, self.device)
        self.wire16_rounds += 1
        fields = [
            rows[:, :, F_TYPE], rows[:, :, F_POS1], rows[:, :, F_POS2],
            rows[:, :, F_ARG], rows[:, :, F_LEN], rows[:, :, F_CLIENT],
            ref_d, msn_d,
        ]
        segs: List[np.ndarray] = []
        widths: List[int] = []
        dts = {1: np.int8, 2: np.int16, 4: np.int32}
        for i, f in enumerate(fields):
            # Sticky monotone widths: widening only.
            w = max(
                _pick_width(int(f.min()), int(f.max())),
                self._wire_widths[i],
            )
            widths.append(w)
            segs.append(
                np.ascontiguousarray(f.astype(dts[w])).view(np.int8).ravel()
            )
        self._wire_widths = tuple(widths)
        base = np.stack([seq0, alive], axis=1).astype(np.int32)
        segs.append(base.view(np.int8).ravel())
        buf = np.concatenate(segs)
        return _expand_wire(_to_device(buf, self.device), tuple(widths), d, k)

    # -- error / read surface --------------------------------------------------

    def device_errors(self) -> np.ndarray:
        """Sticky per-doc kernel err lane ([D] readback — the barrier)."""
        return self.scalars[:, SC_ERR].cpu().numpy()

    def telemetry_slice(self, n_shards: int = 1) -> np.ndarray:
        """Per-shard occupancy/err-bit/watermark lanes in ONE batched
        readback: the reduction folds the whole packed fleet to
        [n_shards, len(TELEMETRY_COLS)] on device. A doc count that
        doesn't divide over ``n_shards`` degrades to one aggregate row."""
        if int(self.scalars.shape[0]) % n_shards != 0:
            n_shards = 1
        dev = _scalars_telemetry(self.scalars, n_shards)
        if dev.shape[1] != len(TELEMETRY_COLS):
            raise RuntimeError("telemetry layout drifted from TELEMETRY_COLS")
        return dev.cpu().numpy()

    def doc_state(self, doc: int) -> SegmentState:
        """One document's merge state read back to host numpy."""
        return self.doc_states([doc])[doc]

    def doc_states(self, docs) -> Dict[int, SegmentState]:
        """N documents' merge states in ONE batched device->host readback
        (one device gather, one flat transfer). The index pads to a power
        of two (padding re-gathers the first doc, discarded at unpack)."""
        docs = [int(d) for d in docs]
        if not docs:
            return {}
        pad = pow2_at_least(len(docs))
        idx = np.full(pad, docs[0], np.int64)
        idx[: len(docs)] = docs
        ix = _to_device(idx, self.device)
        flat = torch.cat([
            self.tables.index_select(1, ix).reshape(-1),
            self.scalars.index_select(0, ix).reshape(-1),
        ])
        return unpack_packed_doc_states(
            flat.cpu().numpy(), docs, int(self.tables.shape[-1]), pad=pad
        )

    def text(self, doc: int, payloads: dict) -> str:
        return materialize(self.doc_state(doc), payloads)

    # -- the device scribe -----------------------------------------------------

    def begin_summarize_dirty(
        self, threshold: int = 1, max_docs: Optional[int] = None
    ) -> "_PendingSummary":
        """Start a scribe sweep without blocking: the [D, 2] (count,
        cur_seq) scan streams to host in the background. Follow with
        ``stage()`` then ``finish()`` on the returned token."""
        return _PendingSummary(self, threshold, max_docs)

    def summarize_dirty(
        self, threshold: int = 1, max_docs: Optional[int] = None
    ) -> Tuple[int, int]:
        """Summarize every document whose device state advanced >=
        ``threshold`` seqs past its last summary into ONE content-addressed
        pack blob. Returns (docs_summarized, total_bytes)."""
        pend = self.begin_summarize_dirty(threshold, max_docs)
        pend.stage()
        return pend.finish()

    def latest_summary(self, doc: int) -> Optional[dict]:
        """Load a document's latest device-produced summary: one slice out
        of its sweep's pack blob, re-inflated to the client lane format
        (dropped lanes reconstruct as their canonical background)."""
        entry = self._summary_handles.get(doc)
        if entry is None:
            return None
        rec, j = entry
        handle, u8, m32, rows, o8b, o32b, obb, meta = rec
        o8 = o8b + j * len(u8) * rows
        o32 = o32b + j * len(m32) * rows * 4
        ob = obb + j * len(u8) * 4
        count, min_seq, cur_seq = (int(x) for x in meta[j])
        pack = self.store.get_blob(handle)
        lanes = {
            name: [int(_LANE_DEFAULTS_HOST[i])] * count
            for i, name in enumerate(SEGMENT_LANES)
        }
        if u8:
            b8 = np.frombuffer(
                pack, np.int8, count=len(u8) * rows, offset=o8
            ).reshape(len(u8), rows)[:, :count]
            bases = np.frombuffer(pack, np.int32, count=len(u8), offset=ob)
            u = b8.astype(np.int64) + 128
            for i, li in enumerate(u8):
                vals = u[i] + bases[i]
                if li == _RSEQ_IDX:
                    vals = np.where(u[i] == 254, RSEQ_NONE, vals)
                lanes[SEGMENT_LANES[li]] = vals.astype(int).tolist()
        if m32:
            b32 = np.frombuffer(
                pack, np.int32, count=len(m32) * rows, offset=o32
            ).reshape(len(m32), rows)[:, :count]
            for i, li in enumerate(m32):
                lanes[SEGMENT_LANES[li]] = b32[i].tolist()
        return {
            "lanes": lanes,
            "count": count,
            "min_seq": min_seq,
            "cur_seq": cur_seq,
            "payloads": {},
            "intervals": {},
        }


class _PendingSummary:
    """One in-flight scribe sweep: ``begin`` starts the dirtiness readback,
    ``stage()`` dispatches the bucket gathers and starts their
    device->host copies, ``finish()`` waits, serializes the pack blob, and
    commits the watermark. The sweep describes the state at ``begin``:
    until ``finish`` it holds the service's tables, and a commit in between
    writes fresh buffers rather than updating these in place."""

    def __init__(self, svc: TpuFleetService, threshold: int,
                 max_docs: Optional[int]):
        self.svc = svc
        self.threshold = threshold
        self.max_docs = max_docs
        self.t_begin = time.perf_counter()
        self._staged = False
        self._buckets: List[tuple] = []  # (rows, docs, padded, host copy)
        self._dirty = None
        self._cur = None
        self._tables = svc.tables
        self._scalars = svc.scalars
        svc._sweeps.add(self)
        self._scan = _HostCopy(_scan_slim(svc.scalars))
        self.breakdown: Dict[str, float] = {}

    def _gather(self, docs, padded, u8, m32, rows) -> torch.Tensor:
        idx = np.full(padded, docs[0], np.int64)
        idx[: docs.size] = docs
        return _scribe_gather(
            self._tables, self._scalars, _to_device(idx, self.svc.device),
            u8, m32, rows,
        )

    def stage(self) -> None:
        svc = self.svc
        t0 = time.perf_counter()
        scan = self._scan.wait()
        t1 = time.perf_counter()
        cur = scan[:, 1].astype(np.int64)
        backlog = cur - svc._summarized_seq
        dirty = np.flatnonzero(backlog >= self.threshold)
        if self.max_docs is not None and dirty.size > self.max_docs:
            # Most-behind-first: a capped cadence still rotates the whole
            # fleet instead of re-summarizing whichever docs sort first.
            top = np.argpartition(-backlog[dirty], self.max_docs - 1)
            dirty = dirty[np.sort(top[: self.max_docs])]
        self._dirty = dirty
        self._cur = cur
        self._staged = True
        if dirty.size == 0:
            self.breakdown = {"scan_ms": (t1 - t0) * 1e3}
            return
        # Bucket dirty docs by pow2(exact live rows), floor 16, capped at
        # the capacity: each bucket transfers at its own row width.
        buckets: Dict[int, np.ndarray] = {}
        c = np.maximum(scan[dirty, 0].astype(np.int64), 1)
        rb = (1 << np.ceil(np.log2(c)).astype(np.int64))
        rb = np.minimum(np.maximum(rb, 16), svc.capacity)
        for r in np.unique(rb):
            buckets[int(r)] = dirty[rb == r]
        u8, m32 = _split_lane_set(svc._lane_set)
        for rows, docs in sorted(buckets.items()):
            padded = pow2_at_least(docs.size)
            if docs.size > 4096:
                padded = ((docs.size + 4095) // 4096) * 4096
            dev = self._gather(docs, padded, u8, m32, rows)
            self._buckets.append((rows, docs, padded, _HostCopy(dev)))
        self._u8, self._m32 = u8, m32
        t2 = time.perf_counter()
        self.breakdown = {
            "scan_ms": (t1 - t0) * 1e3,
            "dispatch_ms": (t2 - t1) * 1e3,
        }

    def finish(self) -> Tuple[int, int]:
        try:
            return self._finish()
        finally:
            self.svc._sweeps.discard(self)

    def _finish(self) -> Tuple[int, int]:
        if not self._staged:
            self.stage()
        svc = self.svc
        dirty = self._dirty
        if dirty.size == 0:
            return 0, 0
        u8, m32 = self._u8, self._m32
        L = len(SEGMENT_LANES)
        S = int(self._scalars.shape[1])
        t0 = time.perf_counter()

        def parse(buf, rows, padded, nb, u8, m32):
            """Split one bucket's flat int8 transfer back into
            (enc8, masks, base, occ, fits, scal)."""
            n8 = len(u8) * padded * rows
            enc8 = (
                buf[:n8].reshape(len(u8), padded, rows)[:, :nb]
                if u8 else np.zeros((0, nb, rows), np.int8)
            )
            i32 = np.ascontiguousarray(buf[n8:]).view(np.int32)
            o = len(m32) * padded * rows
            masks = i32[:o].reshape(len(m32), padded, rows)[:, :nb]
            base = i32[o: o + len(u8) * padded].reshape(
                len(u8), padded
            )[:, :nb]
            o += len(u8) * padded
            occ = i32[o: o + L].astype(bool)
            fits = bool(i32[o + L])
            scal = i32[o + L + 1:].reshape(padded, S)[:nb]
            return enc8, masks, base, occ, fits, scal

        def regather(rows, docs, padded, u8, m32):
            """Synchronous verbatim re-gather of one bucket."""
            dev = self._gather(docs, padded, u8, m32, rows)
            return parse(dev.cpu().numpy(), rows, padded, docs.size, u8, m32)

        # host_buckets: (rows, docs, lanes=(u8, m32), enc8 [L8,nb,rows],
        #                masks [L32,nb,rows], base [L8,nb], scal [nb,S])
        host_buckets = []
        occ_union = np.zeros(L, bool)
        regathers = 0
        full = tuple(range(L))
        for rows, docs, padded, copy in self._buckets:
            enc8, masks, base, occ, f, scal = parse(
                copy.wait(), rows, padded, docs.size, u8, m32
            )
            occ_union |= occ
            if not f:
                # This bucket's live range overflowed the int8 window:
                # re-gather IT verbatim; other buckets keep the fast path.
                enc8, masks, base, _occ, _f, scal = regather(
                    rows, docs, padded, (), full
                )
                regathers += 1
                host_buckets.append(
                    (rows, docs, ((), full), enc8, masks, base, scal)
                )
            else:
                host_buckets.append(
                    (rows, docs, (u8, m32), enc8, masks, base, scal)
                )
        t1 = time.perf_counter()
        needed = np.flatnonzero(occ_union)
        missing = [li for li in needed if li not in svc._lane_set]
        if missing:
            # A lane outside the shipped set went live: re-gather the sweep
            # with every lane verbatim and reset the adaptive state.
            host_buckets = []
            for rows, docs, padded, _copy in self._buckets:
                enc8, masks, base, _occ, _f, scal = regather(
                    rows, docs, padded, (), full
                )
                regathers += 1
                host_buckets.append(
                    (rows, docs, ((), full), enc8, masks, base, scal)
                )
            svc._lane_set = full
            svc._lane_idle[:] = 0
        else:
            # Shrink lanes idle for 3 consecutive sweeps; grow is handled
            # by the regather branch.
            svc._lane_idle[~occ_union] += 1
            svc._lane_idle[occ_union] = 0
            keep = tuple(
                li for li in svc._lane_set
                if occ_union[li] or svc._lane_idle[li] < 3
            )
            svc._lane_set = keep if keep else (0,)
        # Serialize ONE pack blob for the whole sweep. Layout per bucket:
        # int64 [n, 4] doc meta, int32 [n, L8] per-doc bases, int8
        # [n, L8, rows] encoded lanes, int32 [n, L32, rows] verbatim lanes.
        t2 = time.perf_counter()
        parts: List[bytes] = []
        bucket_meta = []
        off = 0
        for rows, docs, (bu8, bm32), enc8, masks, base, scal in host_buckets:
            nb = docs.size
            meta = np.empty((nb, 4), np.int64)
            meta[:, 0] = docs
            meta[:, 1] = scal[:, SC_COUNT]
            meta[:, 2] = scal[:, SC_MIN_SEQ]
            meta[:, 3] = scal[:, SC_CUR_SEQ]
            bb = np.ascontiguousarray(base.T)  # [nb, L8] int32
            b8 = np.ascontiguousarray(enc8.transpose(1, 0, 2))
            b32 = np.ascontiguousarray(masks.transpose(1, 0, 2))
            ob = off + meta.nbytes
            o8 = ob + bb.nbytes
            o32 = o8 + b8.nbytes
            bucket_meta.append(
                {"rows": rows, "n": nb, "u8": list(bu8),
                 "m32": list(bm32), "offb": ob, "off8": o8, "off32": o32}
            )
            parts += [meta.tobytes(), bb.tobytes(), b8.tobytes(),
                      b32.tobytes()]
            off = o32 + b32.nbytes
        head = json.dumps(
            {"v": 4, "buckets": bucket_meta}, separators=(",", ":"),
        ).encode() + b"\n"
        pack = head + b"".join(parts)
        t3 = time.perf_counter()
        handle = svc.store.put_blob(pack)
        t4 = time.perf_counter()
        hb = len(head)
        for (rows, docs, (bu8, bm32), enc8, masks, base, scal), bm in zip(
            host_buckets, bucket_meta
        ):
            # ONE shared bucket record; per-doc entries are (record, j).
            meta = np.ascontiguousarray(
                scal[:, [SC_COUNT, SC_MIN_SEQ, SC_CUR_SEQ]]
            )
            rec = (
                handle, bu8, bm32, rows, hb + bm["off8"],
                hb + bm["off32"], hb + bm["offb"], meta,
            )
            svc._summary_handles.update(
                zip(docs.tolist(), ((rec, j) for j in range(docs.size)))
            )
        svc._summarized_seq[dirty] = self._cur[dirty]
        svc.summary_writes += int(dirty.size)
        t5 = time.perf_counter()
        self.breakdown.update(
            transfer_ms=(t1 - t0) * 1e3,
            regathers=regathers,
            serialize_ms=(t3 - t2) * 1e3,
            store_ms=(t4 - t3) * 1e3,
            index_ms=(t5 - t4) * 1e3,
            lanes_shipped=len(u8) + len(m32),
            pack_bytes=len(pack),
        )
        svc.last_summary_breakdown = dict(self.breakdown)
        return int(dirty.size), len(pack)

