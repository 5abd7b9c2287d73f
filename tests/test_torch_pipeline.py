"""Parity: the port's ordering pipeline (``PipelineFluidService(
device_torch="cpu")``: front door, deli, the partitioned deltas log,
scribe, scriptorium, broadcaster, signals, foreman, moira and the device
stage on plain PyTorch kernels) against the JAX reference
(``PipelineFluidService(device_kernel="xla")``), driven in lockstep
through each package's own ``PipelineConnection``, ``OpFrame``,
``DocumentMessage`` and front-door calls.

After every call both services must agree exactly (the tolerance is 0):
every connection's inbox, nacks and signals; every record of every topic
and every committed offset; every ``DocOpLog``; the checkpoints and each
runner's offsets; each deli sequencer and scribe document; ``doc_head``
and ``latest_summary_pointer``; admission and overload state; every
device pool's lanes and scalars, the placement and the watermarks; and
the call's return value or the exception it raised. Scenarios end with
``get_deltas``, ``ops_range``, ``log_entries``, ``device_text``,
``device_summary`` and the backend's ``stats()``.

The two sources of nondeterminism are patched the same way in both
packages: connection tokens (``uuid.uuid4``) come from one counter per
service, and the sequencers' ``time.time()`` reads one fake clock, so
no field is left out of the comparison. The device stage's feed deadline
is 0 (every tick feeds) and the overload controller's lag reference is
unbounded, so no wall-clock reading decides a boxcar or a tier.
"""

import dataclasses
import enum
import types as pytypes

import numpy as np
import pytest
import torch

from fluidframework_tpu.protocol import opframe as ref_opframe
from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.service import admission as ref_admission
from fluidframework_tpu.service import moira as ref_moira
from fluidframework_tpu.service import pipeline as ref_pipeline
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.service import summary_store as ref_summary_store
from fluidframework_tpu.testing import faults as ref_faults
from fluidframework_tpu_torch.ops.segment_state import SEGMENT_LANES
from fluidframework_tpu_torch.parallel.fleet import _SCALARS
from fluidframework_tpu_torch.protocol import opframe as port_opframe
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.protocol.constants import (
    F_ARG,
    F_LEN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
)
from fluidframework_tpu_torch.service import admission as port_admission
from fluidframework_tpu_torch.service import moira as port_moira
from fluidframework_tpu_torch.service import pipeline as port_pipeline
from fluidframework_tpu_torch.service import sequencer as port_sequencer
from fluidframework_tpu_torch.service import (
    summary_store as port_summary_store,
)
from fluidframework_tpu_torch.testing import faults as port_faults

SIDES = {
    "ref": dict(pipeline=ref_pipeline, opframe=ref_opframe, types=ref_types,
                sequencer=ref_sequencer, admission=ref_admission,
                moira=ref_moira, faults=ref_faults),
    "port": dict(pipeline=port_pipeline, opframe=port_opframe,
                 types=port_types, sequencer=port_sequencer,
                 admission=port_admission, moira=port_moira,
                 faults=port_faults),
}
MINT = 1 << 14  # content ids scope to the connection ordinal


@pytest.fixture(autouse=True)
def _clean_fault_registries():
    for side in SIDES.values():
        side["faults"].REGISTRY.reset()
    yield
    for side in SIDES.values():
        side["faults"].REGISTRY.reset()


class FakeClock:
    """One clock for both packages: it moves only when a test moves it."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeUuid:
    """``uuid.uuid4`` from a counter: each service draws the same tokens."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return pytypes.SimpleNamespace(hex=f"{self.n:032x}")


# -- comparison ---------------------------------------------------------------


def _norm(x):
    """A package-free form of a value: classes by name, arrays by dtype,
    shape and contents, containers in their own order."""
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name, x.value)
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.item())
    if isinstance(x, torch.Tensor):
        return _norm(x.cpu().numpy())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, [(f.name, _norm(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)])
    if isinstance(x, dict):
        return ("dict", [(_norm(k), _norm(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_norm(v) for v in x])
    if isinstance(x, (set, frozenset)):
        return ("set", sorted((_norm(v) for v in x), key=repr))
    slots = getattr(type(x), "__slots__", None)
    if slots:
        return (type(x).__name__, [(s, _norm(getattr(x, s))) for s in slots])
    if hasattr(x, "__dict__"):
        return (type(x).__name__, [(k, _norm(v))
                                   for k, v in vars(x).items()])
    raise TypeError(f"cannot compare {type(x)!r}")


def _first_diff(a, b, path):
    if type(a) is not type(b):
        return path, a, b
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path} (length {len(a)} vs {len(b)})", a, b
        for i, (x, y) in enumerate(zip(a, b)):
            d = _first_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else (path, a, b)


def _eq(a, b, what):
    na, nb = _norm(a), _norm(b)
    if na != nb:
        path, x, y = _first_diff(na, nb, what)
        raise AssertionError(f"{path}: ref {x!r} != port {y!r}")


def _ref_lanes(pool):
    st = pool.state
    return (np.stack([np.asarray(getattr(st, k)) for k in SEGMENT_LANES]),
            np.stack([np.asarray(getattr(st, s)) for s in _SCALARS], 1))


def _conn_view(c):
    return dict(doc=c.doc_id, token=c.token, tenant=c.tenant,
                client=c.client_id, join_seq=c.join_seq, conn_no=c.conn_no,
                delivered=c.delivered_seq, signal=c.delivered_signal,
                inbox=c.inbox, nacks=c.nacks, signals=c.signals,
                initial_summary=c.initial_summary)


def _runners(svc):
    out = {"deli": svc._deli, "scribe": svc._scribe,
           "scriptorium": svc._scriptorium, "broadcaster": svc._broadcaster,
           "signals": svc._signals, "foreman": svc._foreman,
           "moira": svc._moira, "device": svc._device_runner}
    return {k: v for k, v in out.items() if v is not None}


def _service_view(svc):
    """Everything host-side that the comparison covers."""
    view = dict(
        rooms={d: [_conn_view(c) for c in cs] for d, cs in svc.rooms.items()},
        log=svc.log._logs,
        commits=svc.log._commits,
        ops_store={d: (log.ops, log.frames, log._starts, log.head)
                   for d, log in svc.ops_store.items()},
        checkpoints=svc.checkpoints._data,
        offsets={k: (r._offsets, r._since_checkpoint)
                 for k, r in _runners(svc).items()},
        admission=(svc.admission.denied, svc.admission._tenants,
                   svc.admission._docs),
        overload=(svc.overload.tier, svc.overload.transitions),
        store=svc.store._backend._blobs,
    )
    deli, scribe = {}, {}
    for p, lam in svc._deli._lambdas.items():
        for d, dl in lam._docs.items():
            deli[d] = (p, dl.sequencer.checkpoint_dict(), dl.sequencer.seq,
                       dl.sequencer.min_seq, dl._signal_counter,
                       dl._signal_basis)
    for p, lam in svc._scribe._lambdas.items():
        for d, sl in lam._docs.items():
            scribe[d] = (p, sl.protocol_head, sl.latest_summary, sl._decided)
    view.update(deli=deli, scribe=scribe,
                heads={d: svc.doc_head(d) for d in svc.ops_store},
                pointers={d: svc.latest_summary_pointer(d) for d in deli})
    if svc._foreman is not None:
        view["foreman"] = {
            p: {d: fl.state() for d, fl in lam._docs.items()}
            for p, lam in svc._foreman._lambdas.items()}
    if svc._moira is not None:
        view["moira"] = {p: lam.state()
                         for p, lam in svc._moira._lambdas.items()}
        view["sink"] = vars(svc.index_sink)
    return view


class Pipe:
    """A reference and a port ``PipelineFluidService`` in lockstep, with
    seeded writers (one ``PipelineConnection`` per side each)."""

    def __init__(self, monkeypatch, seed=0, clock=None, admission=None,
                 index_sink=False, **kw):
        kw.setdefault("n_partitions", 4)
        kw.setdefault("checkpoint_every", 3)
        kw.setdefault("device_capacity", 64)
        kw.setdefault("device_feed_deadline_ms", 0.0)
        self.clock = clock or FakeClock()
        self.svc = {}
        for side, m in SIDES.items():
            monkeypatch.setattr(m["pipeline"], "uuid", FakeUuid())
            monkeypatch.setattr(m["sequencer"], "time",
                                pytypes.SimpleNamespace(time=self.clock))
            extra = dict(overload=m["admission"].OverloadController(
                lag_ref_ms=float("inf")))
            if admission is not None:
                extra["admission"] = m["admission"].AdmissionController(
                    clock=self.clock, **admission)
            if index_sink:
                extra["index_sink"] = m["moira"].MaterializedIndexSink()
            if side == "ref":
                extra["device_kernel"] = "xla"
            else:
                extra["device_torch"] = "cpu"
            self.svc[side] = m["pipeline"].PipelineFluidService(**kw, **extra)
        self.rng = np.random.default_rng(seed)
        self.writers = []  # [{"ref": conn, "port": conn, "csn": int, ...}]
        self.check()

    # -- driving -----------------------------------------------------------

    def both(self, fn, check=True):
        """fn(side, svc) on both sides; the results (or the exceptions
        raised, by type and message) must be equal."""
        out = []
        for side in ("ref", "port"):
            try:
                out.append(("ok", fn(side, self.svc[side])))
            except Exception as e:  # compared, then re-raised below
                out.append(("raised", type(e).__name__, str(e)))
        _eq(out[0], out[1], "result")
        if check:
            self.check()
        return out[1]

    def same(self, name, *args, **kw):
        res = self.both(lambda _s, svc: getattr(svc, name)(*args, **kw))
        assert res[0] == "ok", res
        return res[1]

    def connect(self, doc, mode="write"):
        conns = {}

        def go(side, svc):
            conns[side] = svc.connect(doc, mode=mode)
            return _conn_view(conns[side])

        self.both(go)
        w = dict(doc=doc, csn=0, orig=0, **conns)
        self.writers.append(w)
        return w

    def disconnect(self, w):
        self.both(lambda side, _svc: w[side].disconnect())
        self.writers.remove(w)

    def text(self, doc):
        return self.same("device_text", doc, "s")

    def frame_rows(self, w, n, ref, length=None, mix=(1.0, 0.0, 0.0),
                   csn0=None):
        """n kernel rows of writer ``w`` at refSeq ``ref``: inserts (with
        content ids scoped to its connection), and with ``length`` (the
        visible length at ``ref``) removes and annotates in that view."""
        rows = np.zeros((n, OP_WIDTH), np.int32)
        texts = []
        cur = length or 0
        for i in range(n):
            kind = self.rng.choice(3, p=mix) if cur > 1 else 0
            if kind == 0:
                t = "".join(chr(97 + int(c)) for c in
                            self.rng.integers(0, 26, self.rng.integers(1, 4)))
                w["orig"] += 1
                rows[i, F_TYPE] = OP_INSERT
                rows[i, F_POS1] = self.rng.integers(0, cur + 1)
                rows[i, F_ARG] = w["ref"].conn_no * MINT + w["orig"]
                rows[i, F_LEN] = len(t)
                texts.append(t)
                cur += len(t)
            else:
                a = int(self.rng.integers(0, cur - 1))
                rows[i, F_POS1] = a
                rows[i, F_POS2] = a + 1
                if kind == 1:
                    rows[i, F_TYPE] = OP_REMOVE
                    cur -= 1
                else:
                    rows[i, F_TYPE] = OP_ANNOTATE
                    rows[i, F_ARG] = int(self.rng.integers(1, 5))
        if csn0 is None:
            csn0 = w["csn"] + 1
            w["csn"] += n
        rows[:, F_SEQ] = csn0 + np.arange(n)
        rows[:, F_REF] = ref
        return rows, tuple(texts)

    def submit_frame(self, w, rows, texts):
        def go(side, _svc):
            f = SIDES[side]["opframe"].OpFrame("s", rows.copy(), texts)
            return w[side].submit_frame(f)

        self.both(go)

    def bulk(self, items, pump=True):
        """items: (writer, rows, texts) through ``submit_frames_bulk``."""
        def go(side, svc):
            of = SIDES[side]["opframe"].OpFrame
            return svc.submit_frames_bulk(
                [(w["doc"], w[side].client_id, of("s", r.copy(), t))
                 for w, r, t in items], pump=pump)

        self.both(go)

    def json_ops(self, w, ref, n=1, pos=0):
        """n JSON-wire inserts of writer ``w``, one ``submit`` each."""
        for _ in range(n):
            w["csn"] += 1
            w["orig"] += 1
            csn, orig = w["csn"], w["ref"].conn_no * MINT + w["orig"]
            text = chr(97 + orig % 26)

            def go(side, _svc):
                t = SIDES[side]["types"]
                return w[side].submit(t.DocumentMessage(
                    client_sequence_number=csn,
                    reference_sequence_number=ref,
                    type=t.MessageType.OPERATION,
                    contents={"address": "s", "contents": {
                        "k": "ins", "pos": pos, "text": text,
                        "orig": orig}},
                ))

            self.both(go)

    def message(self, w, type_name, contents, ref):
        w["csn"] += 1
        csn = w["csn"]

        def go(side, _svc):
            t = SIDES[side]["types"]
            return w[side].submit(t.DocumentMessage(
                client_sequence_number=csn, reference_sequence_number=ref,
                type=t.MessageType[type_name], contents=contents))

        self.both(go)

    def signal(self, w, content):
        self.both(lambda side, _svc: w[side].submit_signal(content))

    def take_inboxes(self):
        """Drain every writer's inbox on both sides (frames expanded)."""
        for w in self.writers:
            self.both(lambda side, _svc: w[side].take_inbox())

    def arm(self, site, policy, *args):
        for side in SIDES.values():
            mod = side["faults"]
            mod.REGISTRY.arm(site, getattr(mod, policy)(*args))

    def disarm(self):
        for side in SIDES.values():
            side["faults"].REGISTRY.disarm()

    # -- checking ----------------------------------------------------------

    def check(self):
        ref, port = self.svc["ref"], self.svc["port"]
        _eq(_service_view(ref), _service_view(port), "service")
        assert ref_faults.REGISTRY.stats() == port_faults.REGISTRY.stats()
        rb, pb = ref.device, port.device
        if rb is None:
            assert pb is None
            return
        rf, pf = rb.fleet, pb.fleet
        assert list(rf.pools) == list(pf.pools)
        for cap, rp in rf.pools.items():
            pp = pf.pools[cap]
            lanes, scal = _ref_lanes(rp)
            np.testing.assert_array_equal(lanes, pp.tables.numpy(),
                                          err_msg=f"pool {cap} lanes")
            np.testing.assert_array_equal(scal, pp.scalars[:, :5].numpy(),
                                          err_msg=f"pool {cap} scalars")
            np.testing.assert_array_equal(rp.doc_of_slot, pp.doc_of_slot)
            assert [int(s) for s in rp._free] == pp._free
        assert rf.placement == pf.placement
        for name in ("_applied_a", "_buffseq_a", "_since_a"):
            np.testing.assert_array_equal(getattr(rb, name),
                                          getattr(pb, name), err_msg=name)
        for name in ("_keys", "_buffered_rows", "_parked_rows", "_flushes",
                     "ops_applied", "pump_dispatches", "feed_triggers",
                     "payloads", "_unreported", "_errored", "hibernations"):
            _eq(getattr(rb, name), getattr(pb, name), name)
        assert sorted(rb._cold) == sorted(pb._cold)
        assert rb.residency.counts() == pb.residency.counts()

    def reads(self):
        """The read surface of every document: the durable log, device
        text and summaries, and the backend's stats."""
        docs = sorted(self.svc["port"].ops_store)
        for d in docs:
            head = self.same("doc_head", d)
            self.same("get_deltas", d)
            self.same("get_deltas", d, 2, max(2, head - 1))
            self.same("ops_range", d, 1, head)
            self.same("ops_range", d, max(1, head - 5), head + 3, pump=False)
            self.same("log_entries", d, 1, head)
            self.same("log_entries", d, max(1, head - 3), head)
            self.same("latest_summary_pointer", d)
        if self.svc["port"].device is not None:
            for d in docs:
                self.text(d)
                self.same("device_summary", d, "s")

            def stats(_side, svc):
                s = svc.device.stats()
                s["residency"].pop("wake_p99_ms")  # a wall-clock latency
                return s

            self.both(stats)


def _round(p, docs_writers, n=4, mix=(1.0, 0.0, 0.0), bulk=True,
           pump=True):
    """One round: a frame of n ops from every writer, each at the doc's
    current head, with removes/annotates in the view of that head."""
    items = []
    for w in docs_writers:
        head = p.same("doc_head", w["doc"])
        length = len(p.text(w["doc"])) if mix[0] < 1.0 else 0
        items.append((w, *p.frame_rows(w, n, head, length, mix)))
    if bulk:
        p.bulk(items, pump=pump)
        if not pump:
            p.same("pump")
    else:
        for w, rows, texts in items:
            p.submit_frame(w, rows, texts)


MODES = [pytest.param(True, id="pump"), pytest.param(False, id="oneshot")]


# -- scenarios ----------------------------------------------------------------


@pytest.mark.parametrize("device_pump", MODES)
def test_frames_json_and_signals(monkeypatch, device_pump):
    """Frames through the bulk front door (pumped and not) and one at a
    time, JSON-wire ops, signals and a second writer on one document,
    over 4 partitions and 8 documents."""
    p = Pipe(monkeypatch, seed=1, device_pump=device_pump)
    docs = [f"doc{i}" for i in range(8)]
    ws = [p.connect(d) for d in docs]
    ws.append(p.connect("doc3"))
    for r in range(4):
        _round(p, ws, n=4, mix=(0.6, 0.3, 0.1) if r else (1.0, 0, 0),
               bulk=r != 2, pump=r % 2 == 0)
    for w in ws[:3]:
        p.json_ops(w, p.same("doc_head", w["doc"]), n=3)
    p.signal(ws[0], {"presence": "here"})
    p.signal(ws[-1], {"cursor": 4})
    p.take_inboxes()
    _round(p, ws, n=8, mix=(0.7, 0.2, 0.1))
    p.same("flush_device")
    p.reads()
    assert p.svc["port"].device.stats()["docs_with_errors"] == 0


@pytest.mark.parametrize("device_pump", MODES)
def test_duplicate_gap_stale_and_redelivered_frames(monkeypatch,
                                                    device_pump):
    """A duplicate frame (dropped), a frame that straddles the client's
    last csn (its new tail sequenced), a csn gap and a stale refSeq
    (nacked), and a deli crash that redelivers uncheckpointed frames
    (re-produced, absorbed downstream)."""
    p = Pipe(monkeypatch, seed=2, device_pump=device_pump,
             checkpoint_every=4)
    a, b = p.connect("d0"), p.connect("d1")
    c = p.connect("d0")
    _round(p, [a, b, c], n=4)
    head = p.same("doc_head", "d0")
    rows, texts = p.frame_rows(a, 4, head)
    p.submit_frame(a, rows, texts)
    p.submit_frame(a, rows, texts)  # whole duplicate
    rows2, texts2 = p.frame_rows(a, 3, head, csn0=a["csn"] - 1)
    a["csn"] += 1
    p.submit_frame(a, rows2, texts2)  # two dups, one new op
    rows3, texts3 = p.frame_rows(a, 2, head, csn0=a["csn"] + 3)
    p.submit_frame(a, rows3, texts3)  # csn gap: nacked
    _round(p, [c], n=3)
    p.disconnect(c)  # c held the window back; now the msn moves
    _round(p, [a, b], n=2)
    _round(p, [a, b], n=2)
    rows4, texts4 = p.frame_rows(a, 2, 1)  # refSeq below the msn
    p.submit_frame(a, rows4, texts4)
    a["csn"] -= 2  # the nacked csns were not consumed
    assert any(n.error_type == port_types.NackErrorType.BAD_REQUEST
               for n in a["port"].nacks)
    _round(p, [a, b], n=3)
    p.same("crash_deli", checkpoint_every=4)
    p.same("pump")
    _round(p, [a, b], n=3)
    p.take_inboxes()
    p.reads()


@pytest.mark.parametrize("device_pump", MODES)
def test_disconnect_rejoin_and_summaries(monkeypatch, device_pump):
    """A writer leaves and a new one joins (its slot recycled once the
    leave falls under the msn); a summarize op accepted through
    ``scribe_decide`` and one naming a missing handle (nacked); a later
    connection starts from the acked summary."""
    p = Pipe(monkeypatch, seed=3, device_pump=device_pump)
    a, b = p.connect("s0"), p.connect("s0")
    _round(p, [a, b], n=4)
    p.disconnect(b)
    _round(p, [a], n=4)
    c = p.connect("s0")
    _round(p, [a, c], n=3, mix=(0.5, 0.4, 0.1))
    handle = p.both(lambda side, svc: svc.store.put_summary(
        {"channels": {"s": {"text": "x"}}, "doc_id": "s0"}))[1]
    head = p.same("doc_head", "s0")
    p.message(a, "SUMMARIZE", {"handle": handle, "head": head}, head)
    p.message(c, "SUMMARIZE", {"handle": "missing", "head": head}, head)
    p.take_inboxes()
    assert p.same("latest_summary_pointer", "s0")[1] == head
    d = p.connect("s0")
    assert d["port"].initial_summary is not None
    _round(p, [a, c, d], n=2)
    p.disconnect(a)
    p.reads()


def test_throttle_nack_on_a_shared_fake_clock(monkeypatch):
    """A finite per-document admission budget: writes past it are nacked
    with ThrottlingError and the same retry-after on both sides (the
    bulk front door's denial is sticky per client for the batch); after
    the fake clock refills the bucket, the resubmitted frames land."""
    clock = FakeClock()
    p = Pipe(monkeypatch, seed=4, clock=clock,
             admission=dict(doc_rate=8.0, doc_burst=8.0))
    a, b = p.connect("t0"), p.connect("t1")
    head = {w["doc"]: p.same("doc_head", w["doc"]) for w in (a, b)}
    first = [(w, *p.frame_rows(w, 6, head[w["doc"]])) for w in (a, b)]
    second = [(w, *p.frame_rows(w, 6, head[w["doc"]])) for w in (a, b)]
    p.bulk(first + second)  # the second frame of each doc is over budget
    assert [n.error_type for n in a["port"].nacks] == \
        [port_types.NackErrorType.THROTTLING]
    clock.t += 2.0
    p.bulk(second)
    p.json_ops(a, p.same("doc_head", "t0"), n=3)  # 2 tokens left
    assert len(a["port"].nacks) == 2
    assert a["port"].nacks[-1].client_sequence_number == a["csn"]
    a["csn"] -= 1  # a throttled op consumed no csn: resubmit it
    clock.t += 1.0
    p.json_ops(a, p.same("doc_head", "t0"), n=1)
    assert len(a["port"].nacks) == 2
    p.take_inboxes()
    p.reads()


@pytest.mark.parametrize("device_pump", MODES)
def test_crash_replays_and_checkpoints(monkeypatch, device_pump):
    """``checkpoint_all``, then deli, scribe and device crashes each
    followed by traffic: deli replays from its checkpoint, scribe keeps
    its acked summary, the device stage rebuilds every channel from the
    deltas log at offset zero."""
    p = Pipe(monkeypatch, seed=5, device_pump=device_pump,
             checkpoint_every=5)
    ws = [p.connect(f"c{i}") for i in range(5)]
    _round(p, ws, n=4)
    handle = p.both(lambda side, svc: svc.store.put_summary(
        {"channels": {}, "doc_id": "c0"}))[1]
    head = p.same("doc_head", "c0")
    p.message(ws[0], "SUMMARIZE", {"handle": handle, "head": head}, head)
    p.same("checkpoint_all")
    _round(p, ws, n=3, mix=(0.6, 0.3, 0.1))
    p.same("crash_deli", checkpoint_every=5)
    _round(p, ws, n=3)
    p.same("crash_scribe", checkpoint_every=5)
    _round(p, ws, n=2)
    p.same("crash_device")
    p.same("pump")
    _round(p, ws, n=2, mix=(0.6, 0.3, 0.1))
    p.take_inboxes()
    p.reads()


@pytest.mark.parametrize("device_pump", MODES)
def test_hibernate_sweep_and_wake(monkeypatch, device_pump):
    """Documents whose writers left go idle, cool and hibernate through
    ``hibernate_sweep`` (summary to the store, pointer to the read tier,
    slots evicted); a new writer's first frame wakes one."""
    p = Pipe(monkeypatch, seed=6, device_pump=device_pump)
    ws = [p.connect(f"h{i}") for i in range(4)]
    _round(p, ws, n=4)
    for w in ws[:2]:
        p.disconnect(w)
    p.same("flush_device")
    done = []
    for _ in range(12):
        done += p.same("hibernate_sweep", max_docs=2)
    assert sorted(done) == ["h0", "h1"]
    assert p.svc["port"].read_tier.latest.latest_handle("h0") is not None
    w = p.connect("h0")
    _round(p, [w, ws[2]], n=3)
    p.same("flush_device")
    assert p.svc["port"].device.residency.counts() == \
        p.svc["ref"].device.residency.counts()
    p.reads()


def test_moira_index_sink(monkeypatch):
    """An index sink behind the moira stage: every content op becomes a
    commit record; a moira crash replays from its checkpoint and the
    sink's guid upsert absorbs the duplicates."""
    p = Pipe(monkeypatch, seed=7, index_sink=True, checkpoint_every=4)
    ws = [p.connect(f"m{i}") for i in range(3)]
    for w in ws:
        p.json_ops(w, p.same("doc_head", w["doc"]), n=2)
    _round(p, ws, n=3)
    p.same("crash_moira", checkpoint_every=4)
    p.same("pump")
    for w in ws:
        p.json_ops(w, p.same("doc_head", w["doc"]), n=2)
    p.same("pump")
    assert p.svc["port"].index_sink.doc_seqs("m0")
    p.reads()


@pytest.mark.parametrize("device_pump", MODES)
def test_faults_at_dispatch_and_lambda_batches(monkeypatch, device_pump):
    """Faults armed in both registries: ``pump.dispatch`` (an injected
    failure re-applies the boxcar from its host copy; a crash before the
    dispatch requeues it), ``store.append`` inside scriptorium's batch
    handler (retried; exhausted, the pump raises and the next pump
    replays the chunk) and ``queue.send`` at a runner's boxcar emit."""
    p = Pipe(monkeypatch, seed=8, device_pump=device_pump)
    ws = [p.connect(f"f{i}") for i in range(3)]
    for site, policy, args in (
        ("pump.dispatch", "FailN", (1,)),
        ("pump.dispatch", "CrashAt", ("before",)),
        ("store.append", "FailN", (2,)),
        ("queue.send", "FailN", (1,)),
        ("store.append", "FailN", (6,)),
    ):
        p.arm(site, policy, *args)
        items = [(w, *p.frame_rows(w, 3, p.same("doc_head", w["doc"])))
                 for w in ws]
        p.bulk(items, pump=False)
        res = p.both(lambda _s, svc: svc.pump())
        if res[0] == "raised":
            p.disarm()
            p.same("pump")
        p.same("flush_device")
        p.disarm()
    assert port_faults.REGISTRY.injected_total() >= 5
    p.take_inboxes()
    p.reads()


# -- the refusals and the default device --------------------------------------


def test_refusals_and_the_default_device(monkeypatch):
    P = port_pipeline.PipelineFluidService
    with pytest.raises(TypeError, match="Mesh"):
        P(device_torch="cpu", device_mesh=object())
    assert P(device_torch="cpu",
             device_sharded_overflow=True).device.sharded_overflow
    for kernel in ("xla", "pallas"):
        with pytest.raises(ValueError, match="kernel"):
            P(device_torch="cpu", device_kernel=kernel)
    native = port_summary_store.SummaryStore(native=True)
    assert type(native._backend).__name__ == "NativeBlobStore"
    assert native.put_blob(b"native") == \
        ref_summary_store.SummaryStore().put_blob(b"native")
    assert ref_summary_store.SummaryStore(native=False).chunk_bytes == \
        port_summary_store.SummaryStore().chunk_bytes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P()
    assert P(device_torch="cpu").device.fleet.device.type == "cpu"
    assert P(device_torch="cpu", device_kernel="plain").device.fleet.kernel \
        == "plain"
    assert P(device_backend=False).device is None
