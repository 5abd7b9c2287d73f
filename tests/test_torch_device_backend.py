"""Parity: the port's serving stage (``DeviceFleetBackend(device="cpu")``
behind ``TpuDeliLambda``, plain PyTorch kernels) against the JAX reference
(``DeviceFleetBackend(kernel="xla")``, and ``kernel="pallas"`` in interpret
mode at one small shape), fed the same seeded ``SeqFrame``s and JSON wire
messages through each package's own lambda, frame classes and message
types, in lockstep.

After every call both must agree exactly (int32 lanes, so the tolerance is
0): every pool's 15 lanes and 5 scalars, slot bookkeeping, placement, the
``_applied_a`` / ``_buffseq_a`` / ``_since_a`` watermarks, buffered and
parked rows, the ring, the counters, and the call's return value (or the
injected fault it raised). Each scenario ends with ``doc_states``,
``telemetry()``, ``stats()``, ``pressure()``, ``text`` and
``channel_summary`` of every channel, and runs in both pump modes.
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.protocol import opframe as ref_opframe
from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.runtime import op_lifecycle as ref_lifecycle
from fluidframework_tpu.service.device_backend import (
    DeviceFleetBackend as RefBackend,
)
from fluidframework_tpu.service.device_lambda import TpuDeliLambda as RefLambda
from fluidframework_tpu.testing import faults as ref_faults
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops.segment_state import SEGMENT_LANES
from fluidframework_tpu_torch.parallel.fleet import _SCALARS
from fluidframework_tpu_torch.protocol import opframe as port_opframe
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.protocol.constants import OP_WIDTH
from fluidframework_tpu_torch.runtime import op_lifecycle as port_lifecycle
from fluidframework_tpu_torch.service.device_backend import (
    DeviceFleetBackend as PortBackend,
)
from fluidframework_tpu_torch.service.device_lambda import (
    TpuDeliLambda as PortLambda,
)
from fluidframework_tpu_torch.testing import faults as port_faults

SIDES = {
    "ref": dict(lam=RefLambda, opframe=ref_opframe, types=ref_types,
                lifecycle=ref_lifecycle, faults=ref_faults),
    "port": dict(lam=PortLambda, opframe=port_opframe, types=port_types,
                 lifecycle=port_lifecycle, faults=port_faults),
}
INJECTED = (ref_faults.InjectedFault, port_faults.InjectedFault)


@pytest.fixture(autouse=True)
def _clean_fault_registries():
    for side in SIDES.values():
        side["faults"].REGISTRY.reset()
    yield
    for side in SIDES.values():
        side["faults"].REGISTRY.reset()


class Ops:
    """Seeded sequenced traffic per document, kept as history so any
    contiguous seq run can be re-framed (redelivery, overlap): inserts of
    1-3 letters at random positions and (with ``remove_p``) removes of
    1-2 characters, each from one of 4 writers that has seen every
    earlier op; the collab window trails by ``msn_lag`` seqs (None: 0).
    ``model`` is each document's expected text."""

    def __init__(self, seed=0, remove_p=0.0, msn_lag=None):
        self.rng = np.random.default_rng(seed)
        self.remove_p = remove_p
        self.msn_lag = msn_lag
        self.hist = {}  # doc -> [(row, text or None)], index = seq - 1
        self.model = {}
        self.orig = 1

    def head(self, doc):
        return len(self.hist.get(doc, ()))

    def advance(self, doc, n):
        """n new ops for ``doc``; returns their (first, last) seq."""
        hist = self.hist.setdefault(doc, [])
        text = self.model.setdefault(doc, [])
        rng = self.rng
        first = len(hist) + 1
        for _ in range(n):
            s = len(hist) + 1
            msn = 0 if self.msn_lag is None else max(0, s - self.msn_lag)
            client = int(rng.integers(4))
            if len(text) > 4 and rng.random() < self.remove_p:
                a = int(rng.integers(0, len(text) - 2))
                b = a + int(rng.integers(1, 3))
                hist.append((E.remove(a, b, seq=s, ref=s - 1, client=client,
                                      msn=msn), None))
                del text[a:b]
                continue
            t = "".join(chr(97 + int(c)) for c in
                        rng.integers(0, 26, int(rng.integers(1, 4))))
            pos = int(rng.integers(0, len(text) + 1))
            hist.append((E.insert(pos, self.orig, len(t), seq=s, ref=s - 1,
                                  client=client, msn=msn), t))
            text[pos:pos] = list(t)
            self.orig += 1
        return first, len(hist)

    def rows(self, doc, first, last):
        """The rows and insert texts of seqs first..last of ``doc``."""
        run = self.hist[doc][first - 1: last]
        rows = np.stack([r for r, _t in run]).astype(np.int32)
        return rows, tuple(t for _r, t in run if t is not None)


def _same(a, b):
    """Deep equality of results on both sides (dicts, sequences,
    SegmentStates, numpy arrays, dataclasses)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (a, b)
        for k in a:
            _same(a[k], b[k])
    elif hasattr(a, "_fields"):  # SegmentState
        assert a._fields == b._fields
        for f, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b, (a, b)


def _ref_lanes(pool):
    st = pool.state
    return (np.stack([np.asarray(getattr(st, k)) for k in SEGMENT_LANES]),
            np.stack([np.asarray(getattr(st, s)) for s in _SCALARS], 1))


class Pair:
    """A reference backend and a port backend, each behind its own
    per-document ``TpuDeliLambda``s, driven in lockstep."""

    def __init__(self, kernel="xla", **kw):
        self.be = {"ref": RefBackend(kernel=kernel, **kw),
                   "port": PortBackend(device="cpu", **kw)}
        self.lams = {"ref": {}, "port": {}}
        self.check()

    @property
    def ref(self):
        return self.be["ref"]

    @property
    def port(self):
        return self.be["port"]

    def _lam(self, side, doc):
        lams = self.lams[side]
        if doc not in lams:
            lams[doc] = SIDES[side]["lam"](doc, self.be[side])
        return lams[doc]

    def _both(self, fn):
        """fn(side, backend) on both sides; returns (ref, port) results,
        an injected fault standing as ("raised", kind, site, completed)."""
        out = []
        for side in ("ref", "port"):
            try:
                out.append(fn(side, self.be[side]))
            except INJECTED as e:
                out.append(("raised", type(e).__name__, e.site, e.kind,
                            e.completed))
        self.check()
        return out

    def same(self, name, *args, **kw):
        """One backend method on both sides; results must be equal."""
        want, got = self._both(lambda _s, be: getattr(be, name)(*args, **kw))
        _same(want, got)
        return got

    def frame(self, doc, ops, first, last, address="s", client=0):
        """Seqs first..last of ``ops`` as one SeqFrame through the lambda
        (``{"t": "seqframe"}``), on both sides."""
        rows, texts = ops.rows(doc, first, last)

        def go(side, _be):
            f = SIDES[side]["opframe"].SeqFrame(
                address, client, first, rows.copy(), texts, 0.0)
            return self._lam(side, doc).handler(
                doc, {"t": "seqframe", "frame": f})

        _same(*self._both(go))

    def wire(self, doc, envelopes, seq0, ref, client, msn=0, **pack):
        """A batch of op envelopes packed on the JSON wire (compression and
        chunking per ``pack``), stamped seq0, seq0+1, ... one per wire
        message, through the lambda (``{"t": "seq"}``) on both sides.
        Returns the next free seq."""
        n = 0

        def go(side, _be):
            nonlocal n
            mod = SIDES[side]
            types = mod["types"]
            wire = mod["lifecycle"].pack_batch(envelopes, **pack)
            n = len(wire)
            out = []
            for i, w in enumerate(wire):
                msg = types.SequencedDocumentMessage(
                    client_id=client, sequence_number=seq0 + i,
                    client_sequence_number=i + 1,
                    reference_sequence_number=ref,
                    minimum_sequence_number=msn,
                    type=types.MessageType.OPERATION,
                    contents=w.contents, metadata=w.metadata,
                )
                out.append(self._lam(side, doc).handler(
                    doc, {"t": "seq", "msg": msg}))
            return out

        _same(*self._both(go))
        return seq0 + n

    def message(self, doc, type_name, seq, contents=None, client=0):
        """One non-operation (or odd) message through the lambda."""
        def go(side, _be):
            types = SIDES[side]["types"]
            msg = types.SequencedDocumentMessage(
                client_id=client, sequence_number=seq,
                client_sequence_number=0, reference_sequence_number=seq - 1,
                minimum_sequence_number=0,
                type=types.MessageType[type_name], contents=contents,
            )
            return self._lam(side, doc).handler(doc, {"t": "seq", "msg": msg})

        _same(*self._both(go))

    def arm(self, site, policy, *args):
        for side in SIDES.values():
            mod = side["faults"]
            mod.REGISTRY.arm(site, getattr(mod, policy)(*args))

    def check(self):
        """Every pool, the placement, the watermarks, the buffers, the
        ring and the counters agree."""
        ref, port = self.ref, self.port
        rf, pf = ref.fleet, port.fleet
        assert list(rf.pools) == list(pf.pools)
        for cap, rp in rf.pools.items():
            pp = pf.pools[cap]
            assert (rp.capacity, rp.n_slots) == (pp.capacity, pp.n_slots)
            lanes, scal = _ref_lanes(rp)
            np.testing.assert_array_equal(lanes, pp.tables.numpy(),
                                          err_msg=f"pool {cap} lanes")
            np.testing.assert_array_equal(scal, pp.scalars[:, :5].numpy(),
                                          err_msg=f"pool {cap} scalars")
            np.testing.assert_array_equal(rp.doc_of_slot, pp.doc_of_slot)
            np.testing.assert_array_equal(rp.slot_gen, pp.slot_gen)
            assert [int(s) for s in rp._free] == pp._free
        assert rf.placement == pf.placement
        assert (rf.migrations, rf.demotions) == (pf.migrations, pf.demotions)
        for name in ("_applied_a", "_buffseq_a", "_since_a"):
            a, b = getattr(ref, name), getattr(port, name)
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert b.dtype == np.int64
        assert list(ref._buffers) == list(port._buffers)
        for idx, chunks in ref._buffers.items():
            np.testing.assert_array_equal(np.concatenate(chunks),
                                          np.concatenate(port._buffers[idx]))
        assert sorted(ref._parked) == sorted(port._parked)
        for name in ("_buffered_rows", "_parked_rows", "_flushes",
                     "ops_applied", "pump_dispatches", "pump_backpressure",
                     "hibernations", "reads_served", "read_gathers",
                     "read_gather_fallbacks", "_keys", "_unreported",
                     "_errored", "payloads", "feed_triggers"):
            assert getattr(ref, name) == getattr(port, name), name
        assert len(ref._ring) == len(port._ring)
        assert [list(s.docs) for s in ref._ring.staged] == \
            [list(s.docs) for s in port._ring.staged]
        assert sorted(ref._cold) == sorted(port._cold)
        assert (ref._scan_token is None) == (port._scan_token is None)
        assert ref.residency.counts() == port.residency.counts()
        assert ref_faults.REGISTRY.stats() == port_faults.REGISTRY.stats()

    def reads(self):
        """The read and scrape surface, then text and summaries (which
        flush) of every channel."""
        keys = self.port.channels()
        assert keys == self.ref.channels()
        self.same("doc_states", keys)
        want, got = self._both(lambda _s, be: be.telemetry())
        _same(want, got)
        want, got = self._both(lambda _s, be: be.stats())
        for s in (want, got):
            s["residency"].pop("wake_p99_ms")  # a wall-clock latency
        # The port's own count: no promotion is refused on the CPU.
        assert got.pop("promotions_refused") == 0
        _same(want, got)
        want, got = self._both(lambda _s, be: be.pressure())
        assert (want.ring_frac, want.queue_frac, want.scan_inflight,
                want.feed_lag_ms > 0) == (got.ring_frac, got.queue_frac,
                                          got.scan_inflight,
                                          got.feed_lag_ms > 0)
        for doc, addr in keys:
            self.same("text", doc, addr)
            self.same("channel_summary", doc, addr)
        self.same("dirty_channels")
        self.same("take_errors")


def _texts(p, ops):
    for doc, text in ops.model.items():
        assert p.port.text(doc, "s") == "".join(text)


# -- scenarios -----------------------------------------------------------------

MODES = [pytest.param(True, id="pump"), pytest.param(False, id="oneshot")]


@pytest.mark.parametrize("pump", MODES)
def test_growth_through_promotion(pump):
    """Four documents grow from the 64-row tier through 128 into 256 rows
    and more:
    every boxcar, scan and promotion lands identically, with zero
    errors; frames go through the continuous feed (deadline 0) and the
    quiescence flush in turns."""
    p = Pair(capacity=64, pump_mode=pump, feed_deadline_ms=0.0)
    ops = Ops(seed=1)
    docs = [f"d{i}" for i in range(4)]
    for r in range(16):
        for d in docs:
            p.frame(d, ops, *ops.advance(d, 8))
        p.same("pump_feed" if r % 2 else "flush")
    p.same("pump_drain")
    assert p.port.fleet.migrations >= 8
    assert max(p.port.fleet.pools) >= 256
    assert p.port.stats()["docs_with_errors"] == 0
    p.reads()
    _texts(p, ops)


@pytest.mark.parametrize("pump", MODES)
def test_capacity_error_reported_once(pump):
    """With no tier to promote into (max_capacity = capacity = 64), the
    document that outgrows its table trips ERR_CAPACITY; the channel is
    reported exactly once (one boxcar stale through flush, or through
    collect_now), never again, and take_errors drains it once."""
    p = Pair(capacity=64, max_capacity=64, pump_mode=pump)
    ops = Ops(seed=2)
    reported = []
    for _ in range(11):
        p.frame("big", ops, *ops.advance("big", 8))
        p.frame("small", ops, *ops.advance("small", 1))
        reported += p.same("flush")
    reported += p.same("collect_now")
    assert reported == [("big", "s")]
    assert p.same("take_errors") == [("big", "s")]
    assert p.same("take_errors") == []
    p.frame("big", ops, *ops.advance("big", 8))
    assert p.same("pump_drain") == []
    assert p.port.stats()["docs_with_errors"] == 1
    p.reads()


@pytest.mark.parametrize("pump", MODES)
def test_redelivered_and_overlapping_frames(pump):
    """At-least-once delivery: a frame redelivered while still buffered,
    one redelivered after it applied, and frames that straddle the
    watermark (part applied, part new) all apply each op exactly once."""
    p = Pair(capacity=64, pump_mode=pump)
    ops = Ops(seed=3)
    for d in ("a", "b"):
        p.frame(d, ops, *ops.advance(d, 6))
    p.frame("a", ops, 1, 6)  # live redelivery of a buffered frame
    p.same("flush")
    p.frame("b", ops, 1, 6)  # redelivery of an applied frame
    lo, hi = ops.advance("a", 5)
    p.frame("a", ops, lo - 3, hi)  # straddles the applied watermark
    lo, hi = ops.advance("b", 4)
    p.frame("b", ops, lo, hi - 2)
    p.frame("b", ops, lo - 1, hi)  # straddles the buffered watermark
    p.same("flush")
    p.frame("a", ops, 2, 4)  # wholly below the watermark
    assert p.same("pump_drain") == []
    assert p.port.ops_applied == ops.head("a") + ops.head("b")
    p.reads()
    _texts(p, ops)


@pytest.mark.parametrize("pump", MODES)
def test_removes_with_compaction(pump):
    """Remove-heavy traffic with a trailing collab window: the cadence
    compaction (compact_every=2) reclaims removed rows, and a document
    that grew into the 128-row tier and then shrank steps back down."""
    p = Pair(capacity=64, pump_mode=pump, compact_every=2)
    ops = Ops(seed=4, remove_p=0.0, msn_lag=3)
    docs = ("x", "y", "z")
    for _ in range(7):
        for d in docs:
            p.frame(d, ops, *ops.advance(d, 8))
        p.same("flush")
    assert 128 in p.port.fleet.pools
    peak = p.port.stats()["rows_in_use"]
    ops.remove_p = 0.95
    for _ in range(14):
        for d in docs:
            p.frame(d, ops, *ops.advance(d, 8))
        p.same("flush")
    p.same("pump_drain")
    assert p.port.stats()["rows_in_use"] < peak
    assert p.port.fleet.demotions >= 1
    p.reads()
    _texts(p, ops)


@pytest.mark.parametrize("pump", MODES)
def test_hibernate_park_wake(pump):
    """Residency: an idle document hibernates (its slot evicted, its
    state kept cold and served to reads without a wake); one with
    buffered rows may not; rows for the cold document park while an
    injected wake failure holds, and the quiescence flush wakes it and
    applies them in order."""
    p = Pair(capacity=64, pump_mode=pump, max_resident=2)
    ops = Ops(seed=5)
    docs = ("h0", "h1", "h2")
    for d in docs:
        p.frame(d, ops, *ops.advance(d, 6))
    assert p.same("hibernate_doc", "h1") is False  # rows still buffered
    p.same("pump_drain")
    assert p.same("hibernate_eligible", "h1") is True
    assert p.same("hibernate_doc", "h1") is True
    assert p.port.fleet.placement[1] is None
    p.same("doc_states", [("h1", "s"), ("h0", "s")])  # cold read
    p.arm("doc.wake", "FailN", 1)
    p.frame("h1", ops, *ops.advance("h1", 4))  # parks, wake fails
    assert p.port._parked_rows == 4
    p.frame("h1", ops, *ops.advance("h1", 3))  # wakes, unparks both
    assert p.port._parked_rows == 0
    p.same("flush")
    assert p.same("hibernate_doc", "h2") is True
    p.arm("doc.wake", "FailN", 1)
    p.frame("h2", ops, *ops.advance("h2", 2))
    assert p.port._parked_rows == 2
    p.same("needs_flush")
    p.same("flush")  # retries the parked wake
    p.same("pump_drain")
    assert p.port._parked_rows == 0 and not p.port._cold
    p.reads()
    _texts(p, ops)


@pytest.mark.parametrize("pump", MODES)
def test_faults_at_the_pump_and_read_sites(pump):
    """Faults armed identically in both registries: pump.stage (fail),
    pump.dispatch (fail → host-copy fallback, crash before → requeue,
    crash after → applied, the ack lost) and read.gather (fail → per-doc
    gathers); after each, pump_drain replays exactly what was buffered
    or staged. The one-shot path meets only read.gather."""
    p = Pair(capacity=64, pump_mode=pump)
    ops = Ops(seed=6)
    docs = ("f0", "f1", "f2")

    def feed():
        for d in docs:
            p.frame(d, ops, *ops.advance(d, 5))

    for site, policy, args in (
        ("pump.stage", "FailN", (1,)),
        ("pump.dispatch", "FailN", (1,)),
        ("pump.dispatch", "CrashAt", ("before",)),
        ("pump.dispatch", "CrashAt", ("after",)),
    ):
        feed()
        p.arm(site, policy, *args)
        p.same("flush")
        p.same("pump_drain")
        for side in SIDES.values():
            side["faults"].REGISTRY.disarm()
    feed()
    p.arm("read.gather", "FailN", 1)
    p.same("doc_states", [(d, "s") for d in docs])
    assert p.port.read_gather_fallbacks == 1
    if pump:
        assert port_faults.REGISTRY.injected_total() == 5
    p.reads()
    _texts(p, ops)


@pytest.mark.parametrize("pump", MODES)
def test_json_wire_with_chunked_compressed_message(pump):
    """The per-op JSON wire: plain envelopes, a compressed batch (one head
    plus placeholders), a chunked oversize op, a compressed batch that is
    itself chunked, then a non-string op, an op on a second channel and a
    client leave — each message lowered by ``row_from_wire`` alike."""
    p = Pair(capacity=64, pump_mode=pump)
    rng = np.random.default_rng(7)
    orig = [100]

    def ins(pos, n, address="s"):
        orig[0] += 1
        text = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))
        return {"address": address, "contents": {
            "k": "ins", "pos": pos, "text": text, "orig": orig[0]}}

    seq = 1
    seq = p.wire("j", [ins(0, 3), ins(1, 2)], seq, ref=0, client=1,
                 compression_threshold=None)
    seq = p.wire("j", [ins(0, 40) for _ in range(6)], seq, ref=seq - 1,
                 client=1, compression_threshold=100)
    seq = p.wire("j", [ins(2, 300)], seq, ref=seq - 1, client=1,
                 compression_threshold=None, chunk_size=64)
    seq = p.wire("j", [ins(1, 90) for _ in range(5)], seq, ref=seq - 1,
                 client=1, compression_threshold=10, chunk_size=48)
    p.same("flush")
    seq = p.wire("j", [{"address": "s", "contents": {
        "k": "rem", "start": 1, "end": 30}}, {"address": "s", "contents": {
            "k": "ann", "start": 0, "end": 4, "val": 3}}],
        seq, ref=seq - 1, client=1, compression_threshold=None)
    seq = p.wire("j", [{"address": "s", "contents": {"k": "interval"}},
                       ins(0, 2, address="t")], seq, ref=seq - 1, client=1,
                 compression_threshold=None)
    p.message("j", "CLIENT_LEAVE", seq, contents=1)
    p.message("j", "NOOP", seq + 1)
    assert p.port.channels() == [("j", "s"), ("j", "t")]
    p.same("pump_drain")
    p.reads()


def test_pallas_reference_at_a_small_shape():
    """The same lockstep against the reference's Pallas kernel (interpret
    mode): two documents through promotion with a compaction."""
    p = Pair(kernel="pallas", capacity=32, compact_every=2)
    ops = Ops(seed=8, remove_p=0.2, msn_lag=2)
    for _ in range(7):
        for d in ("p0", "p1"):
            p.frame(d, ops, *ops.advance(d, 4))
        p.same("flush")
    p.same("pump_drain")
    assert 64 in p.port.fleet.pools
    p.reads()
    _texts(p, ops)


def test_mesh_and_sharded_overflow_raise_and_default_needs_a_card(
        monkeypatch):
    with pytest.raises(TypeError, match="Mesh"):
        PortBackend(mesh=object(), device="cpu")
    assert PortBackend(sharded_overflow=True, device="cpu").sharded_overflow
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortBackend()
    assert PortBackend(device="cpu").fleet.device.type == "cpu"


def test_refused_promotion_keeps_the_document(monkeypatch):
    """Sharded overflow on a one-card device list: a shard would need 8 x
    the top tier's rows, past the kernels' largest tier (stubbed here as
    the card would see it: the list reports one card and the top tier is
    64 rows). The promotion is refused before anything moves: the
    document keeps its top-tier slot and its lanes, is not sharded, and
    a later scan neither compacts again nor counts it again. It then runs
    on exactly as a backend without sharded overflow, trips ERR_CAPACITY
    and is reported once."""
    from fluidframework_tpu_torch.ops import _cuda
    from fluidframework_tpu_torch.service import device_backend as DBK

    monkeypatch.setattr(DBK, "mesh_devices",
                        lambda: [torch.device("cuda", 0)])
    monkeypatch.setattr(_cuda, "MAX_CAPACITY", 64)  # shard cap 8 x 16 = 128
    kw = dict(capacity=8, max_capacity=16, device="cpu")
    on = PortBackend(sharded_overflow=True, **kw)
    off = PortBackend(**kw)
    lams = [PortLambda("big", on), PortLambda("big", off)]
    ops = Ops(seed=12)

    def round_(n=2):
        lo, hi = ops.advance("big", n)
        rows, texts = ops.rows("big", lo, hi)
        out = []
        for lam in lams:
            f = port_opframe.SeqFrame("s", 0, lo, rows.copy(), texts, 0.0)
            lam.handler("big", {"t": "seqframe", "frame": f})
            out.append(lam.backend.flush() + lam.backend.collect_now())
        return out

    def lanes(be):
        st = be.fleet.doc_state(be._index[("big", "s")])
        return [np.asarray(x).copy() for x in st]

    while not on._promotion_refused:
        assert round_() == [[], []]
    idx = on._index[("big", "s")]
    place = on.fleet.placement[idx]
    assert place[0] == 16 and idx in on.fleet.overflowing_docs()
    before = lanes(on)
    compacts = []
    real = on.fleet.compact
    monkeypatch.setattr(on.fleet, "compact",
                        lambda: (compacts.append(1), real())[1])
    for _ in range(2):
        on._promote_overflow()
        assert on.fleet.placement[idx] == place
        for x, y in zip(lanes(on), before):
            np.testing.assert_array_equal(x, y)
        assert idx not in on._sharded and compacts == []
    assert on.stats()["promotions_refused"] == 1
    reported = []
    for _ in range(40):
        got = round_()
        assert got[0] == got[1]
        reported += got[0]
        for x, y in zip(lanes(on), lanes(off)):
            np.testing.assert_array_equal(x, y)
        if reported:
            break
    assert reported == [("big", "s")]
    assert on.fleet.placement[idx] == place
    st = on.stats()
    assert st["docs_with_errors"] == 1 and st["sharded_docs"] == 0
    assert st["promotions_refused"] == 1
    assert round_() == [[], []]  # reported once


def test_a_real_dispatch_failure_propagates(monkeypatch):
    """A non-injected exception from the device dispatch is counted as
    fatal and raised; the slot is neither requeued nor re-applied."""
    from fluidframework_tpu_torch.service import retry
    from fluidframework_tpu_torch.telemetry import metrics

    be = PortBackend(capacity=64, device="cpu")
    ops = Ops(seed=9)
    lam = PortLambda("r", be)
    lo, hi = ops.advance("r", 4)
    rows, texts = ops.rows("r", lo, hi)
    lam.handler("r", {"t": "seqframe", "frame": port_opframe.SeqFrame(
        "s", 0, lo, rows, texts, 0.0)})

    def boom(*_a):
        raise RuntimeError("merge_apply: CUDA error 700")

    monkeypatch.setattr(be.fleet, "dispatch_staged", boom)
    fatal = retry.retry_counter(metrics.REGISTRY)
    before = fatal.value(site="pump.dispatch", outcome="fatal")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        be.flush()
    assert fatal.value(site="pump.dispatch", outcome="fatal") == before + 1
    assert len(be._ring) == 0 and be.pump_dispatches == 0
    assert int(be.fleet.pools[64].scalars[:, 0].sum()) == 0


@pytest.mark.parametrize("exc", [KeyboardInterrupt, SystemExit,
                                 GeneratorExit])
def test_a_non_exception_dispatch_failure_is_not_counted(exc):
    """A ``BaseException`` that is not an ``Exception`` (an interrupt, an
    exit) raised from the device dispatch propagates on both backends and
    is not counted: the ``pump.dispatch`` fatal counter and the journal
    stay as they were, as the reference's ``except Exception`` has it."""
    from fluidframework_tpu.service import retry as ref_retry
    from fluidframework_tpu.telemetry import journal as ref_journal
    from fluidframework_tpu_torch.service import retry as port_retry
    from fluidframework_tpu_torch.telemetry import journal as port_journal

    sides = {"ref": (RefBackend(kernel="xla", capacity=64), ref_retry,
                     ref_journal),
             "port": (PortBackend(capacity=64, device="cpu"), port_retry,
                      port_journal)}
    marks = {"ref": ref_journal.JOURNAL._next,
             "port": port_journal.JOURNAL._next}
    recs = {}
    ops = Ops(seed=10)
    lo, hi = ops.advance("k", 4)
    rows, texts = ops.rows("k", lo, hi)
    for side, (be, retry_mod, journal_mod) in sides.items():
        SIDES[side]["lam"]("k", be).handler("k", {
            "t": "seqframe", "frame": SIDES[side]["opframe"].SeqFrame(
                "s", 0, lo, rows.copy(), texts, 0.0)})

        def interrupt(*_a):
            raise exc()

        be._dispatch_device = interrupt
        fatal = retry_mod.retry_counter()
        before = fatal.value(site="pump.dispatch", outcome="fatal")
        with pytest.raises(exc):
            be.flush()
        assert fatal.value(site="pump.dispatch", outcome="fatal") == before, \
            side
        recs[side] = [e.kind for e in journal_mod.JOURNAL._ring
                      if e.eid >= marks[side]]
    assert recs["ref"] == recs["port"]
    assert "retry.outcome" not in recs["port"]
