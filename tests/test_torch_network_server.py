"""Parity: the port's socket front door (``FluidNetworkServer`` over
``PipelineFluidService(device_torch="cpu")``, or over the default
``LocalFluidService``) against the JAX reference (``FluidNetworkServer``
over ``PipelineFluidService(device_kernel="xla")``).

The two servers are driven in lockstep in-process, without ``start()``:
fake sessions with a duck-typed writer go through ``_on_message``,
``_on_frame`` and ``_drain_all``, and REST requests and websocket
handshakes go through ``_handle`` with a fake reader that replays the raw
request bytes. Every byte a server writes must equal the other's (the
tolerance is 0), apart from ``/metrics``, whose sample values hold wall
times: there the families (name, type, help, label sets) are compared.
After every call the sessions, the servers' counters and, through
``test_torch_pipeline.Pipe``, every inbox, topic, ``DocOpLog``, checkpoint
and device pool are compared too.

Nondeterminism is patched alike in both packages: ``secrets`` (tenant
keys and document ids), the connection tokens (``uuid``), the
sequencers' ``time`` and the network server's ``time.monotonic`` (the
idle-flush gate) read counters or one fake clock; the feed deadline is 0,
so the read window is its 0.5 ms floor and every read issued in one
``asyncio`` run rides one batch. The real-socket case at the end starts
both servers and runs one script through each package's own network
driver; there the per-document sequenced streams (seq, csn, contents) and
the REST texts are compared.
"""

import asyncio
import copy
import json
import time
import types as pytypes

import numpy as np
import pytest
from test_torch_pipeline import SIDES, FakeUuid, Pipe, _eq

from fluidframework_tpu.drivers import network_driver as ref_driver
from fluidframework_tpu.service import admission as ref_admission
from fluidframework_tpu.service import local_server as ref_local
from fluidframework_tpu.service import network_server as ref_ns
from fluidframework_tpu.service import pipeline as ref_pipeline
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.service import wsproto as ref_wsproto
from fluidframework_tpu.telemetry import journal as ref_journal
from fluidframework_tpu.telemetry import metrics as ref_metrics
from fluidframework_tpu.testing import faults as ref_faults
from fluidframework_tpu_torch.drivers import network_driver as port_driver
from fluidframework_tpu_torch.service import admission as port_admission
from fluidframework_tpu_torch.service import local_server as port_local
from fluidframework_tpu_torch.service import network_server as port_ns
from fluidframework_tpu_torch.service import pipeline as port_pipeline
from fluidframework_tpu_torch.service import wsproto as port_wsproto
from fluidframework_tpu_torch.telemetry import journal as port_journal
from fluidframework_tpu_torch.telemetry import metrics as port_metrics
from fluidframework_tpu_torch.testing import faults as port_faults

NS = {
    "ref": dict(ns=ref_ns, local=ref_local, wsproto=ref_wsproto,
                admission=ref_admission, journal=ref_journal,
                metrics=ref_metrics, faults=ref_faults, driver=ref_driver,
                pipeline=ref_pipeline),
    "port": dict(ns=port_ns, local=port_local, wsproto=port_wsproto,
                 admission=port_admission, journal=port_journal,
                 metrics=port_metrics, faults=port_faults,
                 driver=port_driver, pipeline=port_pipeline),
}


@pytest.fixture(autouse=True)
def _clean_registries():
    for side in NS.values():
        side["faults"].REGISTRY.reset()
        side["metrics"].REGISTRY.reset()
        side["journal"].reset()
    yield
    for side in NS.values():
        side["faults"].REGISTRY.reset()


class FakeSecrets:
    """``secrets.token_hex`` from a counter: both servers draw the same."""

    def __init__(self):
        self.n = 0

    def token_hex(self, nbytes=32):
        self.n += 1
        return f"{self.n:0{2 * nbytes}x}"


class FakeWriter:
    """A duck-typed asyncio writer (no ``transport``: push writes stay
    inline) that keeps every byte written to it."""

    def __init__(self):
        self.buf = bytearray()
        self.closed = False

    def write(self, data):
        self.buf += data

    async def drain(self):
        pass

    def close(self):
        self.closed = True


class FakeReader:
    """Replays raw request bytes, then end of stream."""

    def __init__(self, data=b""):
        self.data = bytes(data)

    async def read(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


def _request(method, path, body=b"", headers=()):
    head = [f"{method} {path} HTTP/1.1", "Host: x",
            f"Content-Length: {len(body)}", *headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _metrics_families(text):
    """name -> (type, help, label-key sets) of a Prometheus exposition."""
    fam = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, help_ = line[7:].partition(" ")
            fam.setdefault(name, {})["help"] = help_
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            fam.setdefault(name, {})["type"] = kind
        elif line and not line.startswith("#"):
            name, _, rest = line.partition("{")
            labels = rest.split("}")[0] if rest else ""
            keys = tuple(sorted(kv.split("=")[0] for kv in labels.split(",")
                                if kv))
            base = name.split(" ")[0]
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix) and base[: -len(suffix)] in fam:
                    base = base[: -len(suffix)]
            fam.setdefault(base, {}).setdefault("labels", set()).add(keys)
    return fam


class Front:
    """A reference and a port ``FluidNetworkServer`` in lockstep over the
    services of a :class:`Pipe` (``service="pipeline"``) or over each
    package's default ``LocalFluidService`` (``service="local"``)."""

    def __init__(self, monkeypatch, service="pipeline", tenants=None,
                 **pipe_kw):
        self.p = Pipe(monkeypatch, **pipe_kw) if service == "pipeline" \
            else None
        self.clock = self.p.clock if self.p else _LocalClock(monkeypatch)
        self.rng = np.random.default_rng(pipe_kw.get("seed", 0))
        self.srv = {}
        for side, m in NS.items():
            monkeypatch.setattr(m["ns"], "secrets", FakeSecrets())
            monkeypatch.setattr(m["ns"], "time", pytypes.SimpleNamespace(
                monotonic=self.clock, perf_counter=time.perf_counter,
                sleep=time.sleep))
            tm = None
            if tenants is not None:
                tm = m["ns"].TenantManager()
                for tenant, key in tenants.items():
                    tm.register(tenant, key)
            svc = self.p.svc[side] if self.p else None
            self.srv[side] = m["ns"].FluidNetworkServer(svc, tenants=tm)
        self.sessions = []  # [{"ref": _Session, "port": _Session}]
        self.check()

    # -- driving -----------------------------------------------------------

    def both(self, fn):
        out = []
        for side in ("ref", "port"):
            try:
                out.append(("ok", fn(side, self.srv[side])))
            except Exception as e:  # compared, then the views are checked
                out.append(("raised", type(e).__name__, str(e)))
        _eq(out[0], out[1], "result")
        self.check()
        return out[1]

    def session(self):
        s = {}

        def go(side, srv):
            s[side] = NS[side]["ns"]._Session(FakeWriter())
            srv._sessions.append(s[side])

        self.both(go)
        self.sessions.append(s)
        return s

    def message(self, s, msg):
        self.both(lambda side, srv: srv._on_message(s[side], copy.deepcopy(msg)))

    def frame(self, s, rows, texts, address="s"):
        def go(side, srv):
            f = SIDES[side]["opframe"].OpFrame(address, rows.copy(), texts)
            srv._on_frame(s[side], f.encode())

        self.both(go)

    def drain(self):
        self.clock.t += 1.0  # past the idle-flush gate on both sides
        self.both(lambda side, srv: srv._drain_all())

    def handle(self, *requests):
        """Each raw request through ``_handle`` in ONE asyncio run (so
        channel reads share a batch); returns the bytes written for each."""
        def go(side, srv):
            writers = [FakeWriter() for _ in requests]

            async def run():
                await asyncio.gather(*[
                    srv._handle(FakeReader(r), w)
                    for r, w in zip(requests, writers)])

            asyncio.run(run())
            return [bytes(w.buf) for w in writers]

        return self.both(go)[1]

    def rest(self, method, path, body=b"", headers=()):
        return self.handle(_request(method, path, body, headers))[0]

    def metrics(self):
        def go(side, srv):
            w = FakeWriter()
            asyncio.run(srv._handle(
                FakeReader(_request("GET", "/metrics")), w))
            head, _, body = bytes(w.buf).partition(b"\r\n\r\n")
            head = [h for h in head.split(b"\r\n")
                    if not h.startswith(b"Content-Length")]
            return head, _metrics_families(body.decode())

        return self.both(go)[1]

    def arm(self, site, policy, *args):
        for m in NS.values():
            mod = m["faults"]
            mod.REGISTRY.arm(site, getattr(mod, policy)(*args))

    def disarm(self):
        for m in NS.values():
            m["faults"].REGISTRY.disarm()

    def rows(self, w, n, ref):
        """n seeded insert rows of writer ``w`` at refSeq ``ref``."""
        return Pipe.frame_rows(self, w, n, ref)

    def writer(self, s, doc):
        """A Pipe-style writer dict over the sessions' connections."""
        return dict(doc=doc, csn=0, orig=0, ref=s["ref"].conn,
                    port=s["port"].conn)

    # -- checking ----------------------------------------------------------

    def check(self):
        r, p = self.srv["ref"], self.srv["port"]
        for name in ("frames_received", "frames_expanded",
                     "frames_delivered", "connections_refused",
                     "reads_shed", "read_batches", "pump_ticks"):
            assert getattr(r, name) == getattr(p, name), name
        assert len(r._sessions) == len(p._sessions)
        for rs, ps in zip(r._sessions, p._sessions):
            _eq(_session_view(rs), _session_view(ps), "session")
        assert ref_faults.REGISTRY.stats() == port_faults.REGISTRY.stats()
        assert port_journal.render() == ref_journal.render()
        if self.p is not None:
            self.p.check()
        else:
            _eq(_local_view(r.service), _local_view(p.service), "local")


def _session_view(s):
    return dict(buf=bytes(s.writer.buf), doc=s.doc_id, push_doc=s.push_doc,
                push_seq=s.push_seq, push_tail=s.push_tail,
                frames_ok=s.frames_ok, push_busy=s.push_busy,
                sock=s.push_sock, conn=None if s.conn is None else dict(
                    client=s.conn.client_id, inbox=s.conn.inbox,
                    nacks=s.conn.nacks, signals=s.conn.signals))


def _local_view(svc):
    return {d: dict(ops=doc.op_log, seq=doc.sequencer.seq,
                    msn=doc.sequencer.min_seq, summary=doc.latest_summary,
                    service_summaries=doc.service_summaries,
                    conns={k: (c.client_id, c.inbox, c.nacks, c.signals)
                           for k, c in doc.connections.items()})
            for d, doc in svc.docs.items()}


class _LocalClock:
    """The fake clock of a ``LocalFluidService`` pair (their sequencers'
    ``time`` and the idle-flush gate)."""

    def __init__(self, monkeypatch, t=1000.0):
        self.t = t
        for mod in (ref_sequencer, SIDES["port"]["sequencer"]):
            monkeypatch.setattr(mod, "time",
                                pytypes.SimpleNamespace(time=self))

    def __call__(self):
        return self.t


def _connect(f, doc, frames=True, **extra):
    s = f.session()
    f.message(s, {"type": "connect_document", "doc": doc,
                  "frames": frames, **extra})
    return s


def _subscribe(f, doc, frames=True, from_seq=0, **extra):
    s = f.session()
    f.message(s, {"type": "subscribe_push", "doc": doc, "frames": frames,
                  "from_seq": from_seq, **extra})
    return s


def _json_op(csn, ref, orig, pos=0, text="j"):
    """A ``submitOp`` message as a client's JSON wire carries it."""
    return {"type": "submitOp", "op": {
        "client_sequence_number": csn, "reference_sequence_number": ref,
        "type": 1, "contents": {"address": "s", "contents": {
            "k": "ins", "pos": pos, "text": text, "orig": orig}},
        "metadata": None, "traces": [], "__proto__": "DocumentMessage"}}


def _json_frame_op(f, s, w, n=1):
    """n JSON-wire inserts from the writer behind session ``s``."""
    for _ in range(n):
        w["csn"] += 1
        w["orig"] += 1
        head = _head(f, w["doc"])
        f.message(s, _json_op(w["csn"], head,
                              w["ref"].conn_no * (1 << 14) + w["orig"]))


def _head(f, doc):
    if f.p is not None:
        return f.p.same("doc_head", doc)
    return f.both(lambda side, srv: srv.service.docs[doc].sequencer.seq)[1]


# -- scenarios ----------------------------------------------------------------


@pytest.mark.parametrize("service", ["pipeline", "local"])
def test_join_json_frames_push_and_signals(monkeypatch, service):
    """Joins (frame wire and JSON), JSON ``submitOp``s, ``OP_BINARY``
    frames, a duplicate frame and a stale one, push subscribers on both
    wires with fan-out, signals, repeat joins and subscribes (refused),
    and a disconnect; the pipeline case also reads every route of the
    device stage afterwards."""
    f = Front(monkeypatch, service=service, seed=3)
    p = f.p
    a = _connect(f, "d0")
    b = _connect(f, "d0", frames=False)
    c = _connect(f, "d1")
    push_f = _subscribe(f, "d0")
    push_j = _subscribe(f, "d0", frames=False)
    f.drain()
    wa, wb, wc = f.writer(a, "d0"), f.writer(b, "d0"), f.writer(c, "d1")
    f.message(a, {"type": "connect_document", "doc": "d0"})  # refused
    f.message(push_f, {"type": "subscribe_push", "doc": "d0"})  # refused
    f.message(push_f, {"type": "connect_document", "doc": "d0"})  # refused
    for r in range(3):
        for s, w in ((a, wa), (c, wc)):
            rows, texts = f.rows(w, 4, _head(f, w["doc"]))
            f.frame(s, rows, texts)
            if r == 1 and s is a:
                f.frame(s, rows, texts)  # a duplicate: dropped
        _json_frame_op(f, b, wb, n=2)
        f.drain()
    # A stale frame: refSeq below the document's minimum sequence number.
    rows, texts = f.rows(wc, 2, 0)
    f.frame(c, rows, texts)
    f.message(a, {"type": "submitSignal", "content": {"cursor": 3}})
    f.message(b, {"type": "submitSignal", "content": "hi"})
    f.drain()
    late = _subscribe(f, "d0", from_seq=2)
    f.drain()
    f.message(b, {"type": "disconnect"})
    f.drain()
    rows, texts = f.rows(wa, 3, _head(f, "d0"))
    f.frame(a, rows, texts)
    f.drain()
    assert late["port"].push_seq == _head(f, "d0")
    assert f.srv["port"].frames_received == 9
    if p is None:
        assert f.srv["port"].frames_expanded == 9
        return
    assert f.srv["port"].frames_delivered > 0
    out = f.handle(*[
        _request("GET", path) for path in (
            "/documents/d0/channels/s", "/documents/d1/channels/s",
            "/documents/d0/channels/s?view=summary",
            "/documents/d0/channels/s", "/documents/d9/channels/s",
            "/documents/d0/channels/zz")])
    assert out[0].startswith(b"HTTP/1.1 200") and out[4].startswith(
        b"HTTP/1.1 404")
    assert f.srv["port"].read_batches == 1
    assert json.loads(out[0].partition(b"\r\n\r\n")[2])["text"] == \
        p.text("d0")
    p.reads()


def test_throttle_nacks_on_a_shared_fake_clock(monkeypatch):
    """Finite admission budgets on the one fake clock: frames past the
    document's burst are nacked with the same retry-after on both sides,
    and admitted again once the clock refills the bucket."""
    f = Front(monkeypatch, seed=4, admission=dict(doc_rate=8.0,
                                                  doc_burst=10.0))
    a = _connect(f, "t0")
    f.drain()
    w = f.writer(a, "t0")
    for _ in range(4):
        rows, texts = f.rows(w, 4, _head(f, "t0"))
        f.frame(a, rows, texts)
    f.drain()
    assert f.srv["port"].service.admission.denied > 0
    assert b'"nack"' in a["port"].writer.buf
    f.p.clock.t += 5.0
    rows, texts = f.rows(w, 2, _head(f, "t0"))
    f.frame(a, rows, texts)
    f.drain()


def test_tenant_tokens(monkeypatch):
    """A good and a bad tenant token on the websocket and REST surfaces,
    a tenant registered without a key (drawn from ``secrets``), and a
    tenant-scoped admission budget."""
    f = Front(monkeypatch, seed=5, tenants={"t1": "key-1", "t2": None})
    tok = {side: m["ns"].TenantManager.mint("t1", "d0", "key-1")
           for side, m in NS.items()}
    assert tok["ref"] == tok["port"]
    good = _connect(f, "d0", tenant="t1", token=tok["port"])
    bad = _connect(f, "d0", tenant="t1", token="0" * 64)
    _subscribe(f, "d0", tenant="t1", token="bad")
    _subscribe(f, "d0", tenant="t2", token=tok["port"])
    f.drain()
    assert good["port"].conn is not None and bad["port"].conn is None
    w = f.writer(good, "d0")
    rows, texts = f.rows(w, 4, _head(f, "d0"))
    f.frame(good, rows, texts)
    f.drain()
    blob = NS["port"]["ns"].TenantManager.mint("t1", "", "key-1")
    f.rest("GET", f"/deltas/d0?tenant=t1&token={tok['port']}")
    f.rest("GET", "/deltas/d0?tenant=t1&token=nope")
    f.rest("POST", f"/blobs?tenant=t1&token={blob}", b"payload")
    f.rest("POST", "/blobs", b"payload")
    f.rest("GET", f"/documents/d0/channels/s?tenant=t1&token={tok['port']}")
    key2 = {side: srv.tenants._keys["t2"] for side, srv in f.srv.items()}
    assert key2["ref"] == key2["port"]


@pytest.mark.parametrize("service", ["pipeline", "local"])
def test_rest_routes(monkeypatch, service):
    """Every REST route (status, headers and body): blobs (POST, GET,
    HEAD, missing), deltas with and without bounds, the document summary,
    document create (with an id, drawn from ``secrets``, malformed),
    document metadata, channel reads, ``/debugz``, ``/metrics``, a
    malformed ``/profilez``, an oversized body and an unknown route."""
    f = Front(monkeypatch, service=service, seed=6)
    a = _connect(f, "r0")
    f.drain()
    if f.p is not None:
        w = f.writer(a, "r0")
        for _ in range(2):
            rows, texts = f.rows(w, 5, _head(f, "r0"))
            f.frame(a, rows, texts)
            f.drain()
    else:
        w = f.writer(a, "r0")
        _json_frame_op(f, a, w, n=4)
        f.drain()
    put = f.rest("POST", "/blobs", b"blob-bytes")
    handle = json.loads(put.partition(b"\r\n\r\n")[2])["handle"]
    for method, path in (
        ("GET", f"/blobs/{handle}"), ("HEAD", f"/blobs/{handle}"),
        ("GET", "/blobs/" + "0" * 64), ("GET", "/deltas/r0"),
        ("GET", "/deltas/r0?from=2&to=5"), ("GET", "/deltas/none"),
        ("GET", "/documents/r0/summary"), ("GET", "/documents/r0"),
        ("GET", "/documents/none"), ("GET", "/documents/r0/channels/s"),
        ("GET", "/debugz"), ("GET", "/profilez?duration_ms=nan"),
        ("GET", "/nowhere"), ("DELETE", "/blobs"),
    ):
        f.rest(method, path)
    f.rest("POST", "/documents", json.dumps({"id": "made"}).encode())
    f.rest("POST", "/documents", b"{}")
    f.rest("POST", "/documents", b"{not json")
    f.handle(_request("POST", "/blobs", headers=(
        f"Content-Length: {(16 << 20) + 1}",)))
    head, fam = f.metrics()
    assert head[0].startswith(b"HTTP/1.1 200")
    assert fam or f.p is None  # the local service publishes no family
    f.rest("GET", "/debugz")


def test_websocket_handshake_through_handle(monkeypatch):
    """A whole websocket session through ``_handle``: the upgrade reply,
    a join, a JSON op and a frame, a ping, then the socket closes (the
    session leaves the room)."""
    f = Front(monkeypatch, seed=7)
    hs = (b"GET /socket HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
          b"Connection: Upgrade\r\nSec-WebSocket-Key: "
          b"dGhlIHNhbXBsZSBub25jZQ==\r\nSec-WebSocket-Version: 13\r\n\r\n")
    ws = port_wsproto.encode_frame
    join = ws(1, json.dumps({"type": "connect_document", "doc": "h0",
                             "frames": True}).encode(), mask=True)
    op = ws(1, json.dumps(_json_op(1, 1, (1 << 14) + 1)).encode(),
            mask=True)
    ping = ws(port_wsproto.OP_PING, b"p", mask=True)
    out = f.handle(hs + join + op + ping)
    assert out[0].startswith(b"HTTP/1.1 101")
    assert port_wsproto.accept_key("dGhlIHNhbXBsZSBub25jZQ==").encode() \
        in out[0]
    assert _head(f, "h0") >= 2


def test_overload_tiers(monkeypatch):
    """``SHED_READS`` sheds REST reads (503 + Retry-After) and new push
    subscriptions but lets writes, ``/metrics`` and ``/debugz`` through;
    ``REFUSE_CONNECTIONS`` turns new sockets away before any session
    state, ``/metrics`` and ``/debugz`` exempt; stepping back down serves
    again."""
    f = Front(monkeypatch, seed=8)
    Tier = {side: m["admission"].Tier for side, m in NS.items()}
    for svc in f.p.svc.values():
        svc.overload.lag_ref_ms = 250.0
    a = _connect(f, "o0")
    f.drain()
    w = f.writer(a, "o0")
    rows, texts = f.rows(w, 4, _head(f, "o0"))
    f.frame(a, rows, texts)
    f.drain()

    def force(name):
        f.both(lambda side, srv: srv.service.overload.force(
            None if name is None else Tier[side][name]))

    force("SHED_READS")
    _subscribe(f, "o0")
    for path in ("/deltas/o0", "/documents/o0/channels/s", "/blobs/ab",
                 "/profilez"):
        f.rest("GET", path)
    f.rest("POST", "/blobs", b"write passes")
    f.rest("GET", "/debugz")
    f.metrics()
    assert f.srv["port"].reads_shed == 5
    force("REFUSE_CONNECTIONS")
    f.rest("GET", "/deltas/o0")
    f.handle(b"GET /socket HTTP/1.1\r\nUpgrade: websocket\r\n"
             b"Sec-WebSocket-Key: eA==\r\n\r\n")
    f.rest("GET", "/debugz")
    f.metrics()
    assert f.srv["port"].connections_refused == 2
    force("NORMAL")
    force(None)
    f.rest("GET", "/deltas/o0")


def test_faults_at_the_push_and_read_sites(monkeypatch):
    """``push.fanout`` FailN requeues only the failed subscriber's
    already-encoded tail, a crash after the write is exactly-once,
    ``ws.deliver`` requeues an op-channel tail, and a faulted
    ``read.gather`` falls back to per-document gathers (counted) — each
    the same on both sides, every byte."""
    f = Front(monkeypatch, seed=9)
    a = _connect(f, "f0")
    subs = [_subscribe(f, "f0"), _subscribe(f, "f0", frames=False)]
    f.drain()
    w = f.writer(a, "f0")

    def burst(n=3):
        rows, texts = f.rows(w, n, _head(f, "f0"))
        f.frame(a, rows, texts)

    burst()
    f.arm("push.fanout", "FailN", 1)
    f.drain()
    assert any(s["port"].push_tail for s in subs)
    f.disarm()
    f.drain()
    assert not any(s["port"].push_tail for s in subs)
    burst()
    f.arm("push.fanout", "CrashAt", "after")
    f.drain()
    f.disarm()
    f.drain()
    burst()
    f.arm("ws.deliver", "FailN", 1)
    f.drain()
    f.disarm()
    f.drain()
    f.arm("read.gather", "FailN", 1)
    f.handle(*[_request("GET", "/documents/f0/channels/s")] * 3)
    f.disarm()
    assert f.srv["port"].service.device.read_gather_fallbacks == 1
    for s in subs:
        assert s["port"].push_seq == _head(f, "f0")
    f.p.reads()


# -- the real-socket case -------------------------------------------------------


def _socket_script(side, port_no, docs, frames=3, k=4):
    """One writer per document over the package's own network driver
    (frame wire, a push socket each), waiting for each frame's ops to
    come back sequenced; then one JSON op each. Returns the per-doc
    streams (seq, csn, contents) and texts read over REST."""
    m = NS[side]
    opframe = SIDES[side]["opframe"]
    types = SIDES[side]["types"]
    cli = m["driver"].NetworkFluidService("127.0.0.1", port_no, push=True)
    conns = {d: cli.connect(d) for d in docs}
    try:
        for r in range(frames):
            for d, c in conns.items():
                csn0 = r * k + 1
                origs = [c.conn_no * (1 << 14) + csn0 + j for j in range(k)]
                fr = opframe.OpFrame.build(
                    "s", ["ins"] * k, [0] * k, origs,
                    [chr(97 + r + j) for j in range(k)], csn0=csn0,
                    ref=c.join_seq)
                c.submit_frame(fr)
                want = csn0 + k - 1
                assert c.wait_for(lambda cc, want=want: any(
                    msg.client_id == cc.client_id
                    and msg.client_sequence_number == want
                    for msg in cc.inbox), 30), (side, d, r)
        for d, c in conns.items():
            c.submit(types.DocumentMessage(
                client_sequence_number=frames * k + 1,
                reference_sequence_number=c.join_seq,
                type=types.MessageType.OPERATION,
                contents={"address": "s", "contents": {
                    "k": "ins", "pos": 0, "text": "J",
                    "orig": c.conn_no * (1 << 14) + 999}}))
            assert c.wait_for(lambda cc: any(
                msg.client_sequence_number == frames * k + 1
                and msg.client_id == cc.client_id for msg in cc.inbox), 30)
        out = {}
        for d in docs:
            deltas = cli.get_deltas(d)
            out[d] = dict(
                stream=[(msg.sequence_number, msg.client_sequence_number,
                         msg.type.name, msg.contents) for msg in deltas],
                text=cli.get_channel_text(d, "s"),
                summary=cli.get_channel_summary(d, "s"))
        return out
    finally:
        for c in conns.values():
            c.disconnect()


def test_real_sockets_same_streams_and_texts(monkeypatch):
    """Both servers started on localhost; the same short script through
    each package's own network driver gives the same sequenced streams,
    device texts and summaries (connection tokens drawn from a counter
    per server, as in the lockstep cases)."""
    docs = ["s0", "s1", "s2"]
    got = {}
    for side, m in NS.items():
        monkeypatch.setattr(m["pipeline"], "uuid", FakeUuid())
        kw = dict(n_partitions=2, device_capacity=64)
        kw.update(device_kernel="xla") if side == "ref" else kw.update(
            device_torch="cpu")
        srv = m["ns"].FluidNetworkServer(m["pipeline"].PipelineFluidService(
            **kw))
        srv.start()
        try:
            got[side] = _socket_script(side, srv.port, docs)
            assert srv.frames_received == 3 * len(docs)
        finally:
            srv.stop()
    _eq(got["ref"], got["port"], "socket")
    for d in docs:
        assert len(got["port"][d]["text"]) == 13


# -- the writer-loop offload, without the race --------------------------------


def _push_socket(port, doc):
    """A raw websocket subscribed to ``doc``'s push stream (frames off),
    returned once ``subscribe_push_success`` has arrived, with the frames
    decoded after it in the same read (the server may push the first ops
    right behind the reply)."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    req, _exp = port_wsproto.client_handshake(f"127.0.0.1:{port}", "/socket")
    sock.sendall(req)
    buf = b""
    while port_wsproto.read_http_head(buf) is None:
        buf += sock.recv(65536)
    dec = port_wsproto.FrameDecoder()
    pending = list(dec.feed(port_wsproto.read_http_head(buf)[2]))
    sock.sendall(port_wsproto.encode_frame(port_wsproto.OP_TEXT, json.dumps(
        {"type": "subscribe_push", "doc": doc, "from_seq": 0}).encode(),
        mask=True))
    while True:
        for i, (op, p) in enumerate(pending):
            if (op == port_wsproto.OP_TEXT
                    and json.loads(p)["type"] == "subscribe_push_success"):
                return sock, dec, pending[i + 1:]
        pending = list(dec.feed(sock.recv(65536)))


def _wait(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def test_push_writes_run_on_drainer_thread():
    """The port's counterpart of the reference's ``TestWriterLoopOffload::
    test_push_writes_run_on_drainer_thread``: once a push subscriber's raw
    socket is attached, its byte writes run on the drainer thread, not
    the loop's, and delivery is complete and in order. The drainer counts
    a batch after its write, so its counters can trail the bytes the
    subscriber already holds: they are awaited with a deadline, never
    read right after the bytes arrive. The frame goes in over the writer's
    own websocket, so only the loop thread drives the service."""
    svc = port_pipeline.PipelineFluidService(n_partitions=1,
                                             device_backend=False)
    srv = port_ns.FluidNetworkServer(svc)
    srv.start()
    sock = writer = None
    try:
        writer = port_driver.NetworkFluidService(
            "127.0.0.1", srv.port).connect("off")
        sock, dec, early = _push_socket(srv.port, "off")
        frame = SIDES["port"]["opframe"].OpFrame.build(
            "s", ["ins"] * 4, [0] * 4,
            [writer.conn_no * (1 << 14) + 1 + j for j in range(4)],
            list("abcd"), csn0=1, ref=writer.join_seq)
        writer.submit_frame(frame)
        assert writer.wait_for(lambda c: any(
            m.client_sequence_number == 4 and m.client_id == c.client_id
            for m in c.inbox), 15)
        head = max(m.sequence_number for m in writer.inbox)
        got = []

        def take(frames):
            for opcode, payload in frames:
                if opcode == port_wsproto.OP_TEXT:
                    m = json.loads(payload.decode())
                    if m.get("type") == "op":
                        got.append(m["msg"]["sequence_number"])

        take(early)
        sock.settimeout(0.2)
        deadline = time.monotonic() + 15
        while (not got or max(got) < head) and time.monotonic() < deadline:
            try:
                data = sock.recv(65536)
            except TimeoutError:  # a ping nudges a fan-out sweep
                sock.sendall(port_wsproto.encode_frame(
                    port_wsproto.OP_PING, b"", mask=True))
                continue
            take(dec.feed(data))
        assert got == list(range(1, head + 1)), got
        dr = srv._push_drainer
        assert _wait(lambda: dr.batches >= 1 and dr.threads), \
            "no write ran on the drainer"
        assert srv._thread.ident not in dr.threads
        sess = [s for s in srv._sessions if s.push_doc == "off"]
        assert sess and sess[0].push_sock is not None
    finally:
        if writer is not None:
            writer.disconnect()
        if sock is not None:
            sock.close()
        srv.stop()


def test_a_blocked_loop_is_seen_as_a_stall():
    """The loop-lag sentinel of the port's server: a call that blocks the
    loop thread for 0.2 s (as a blocking device readback there would) is
    counted in ``stalls_seen`` and journaled as ``loop.stall``."""
    srv = port_ns.FluidNetworkServer()
    srv.start()
    try:
        async def block():
            time.sleep(0.2)

        asyncio.run_coroutine_threadsafe(block(), srv._loop).result(10)
        assert _wait(lambda: srv.stalls_seen >= 1)
        assert "loop.stall" in port_journal.render()
    finally:
        srv.stop()
