"""The port's out-of-process store node (``service/store_server.py``) and
its native log and blob store (``utils/native.py``) against the JAX
reference's.

The reference store tests in the port's form: blobs and protocol objects
round-trip over the wire (each package's client against each package's
node), a replaced front door keeps its documents, the replay is
idempotent downstream, and a restarted store node keeps its logs and
blobs. Beside them, state carried across: the port's
``NativeBlobStore`` / ``NativePartitionLog`` and the reference's receive
the same inputs and must give the same handles, offsets and records, and
a directory written by one package's store node must be served by the
other's. The replacement cases run each package's ``PipelineFluidService``
(the port's on the CPU, the reference's on XLA) over its own store node
and compare the sequenced streams, texts and summaries exactly.
"""

import json
import os
import subprocess
import sys
import types as pytypes

import numpy as np
import pytest
from test_torch_pipeline import FakeClock, _eq

from fluidframework_tpu.protocol import opframe as ref_opframe
from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.service import pipeline as ref_pipeline
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.service import store_server as ref_store
from fluidframework_tpu.service import summary_store as ref_summary
from fluidframework_tpu.utils import native as ref_native
from fluidframework_tpu_torch.protocol import opframe as port_opframe
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.service import pipeline as port_pipeline
from fluidframework_tpu_torch.service import sequencer as port_sequencer
from fluidframework_tpu_torch.service import store_server as port_store
from fluidframework_tpu_torch.service import summary_store as port_summary
from fluidframework_tpu_torch.utils import native as port_native

SIDES = {
    "ref": dict(store=ref_store, pipeline=ref_pipeline, summary=ref_summary,
                opframe=ref_opframe, types=ref_types, native=ref_native,
                sequencer=ref_sequencer, kw=dict(device_kernel="xla")),
    "port": dict(store=port_store, pipeline=port_pipeline,
                 summary=port_summary, opframe=port_opframe,
                 types=port_types, native=port_native,
                 sequencer=port_sequencer, kw=dict(device_torch="cpu")),
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def nodes():
    out = {side: m["store"].StoreServer(port=0, n_partitions=4)
           .serve_background() for side, m in SIDES.items()}
    yield out
    for n in out.values():
        n.close()


class _Uuid:
    """``uuid.uuid4`` from a counter in the digits a connection token
    keeps, so a replacement service never reissues a replayed token."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return pytypes.SimpleNamespace(hex=f"{self.n:010x}" + "0" * 22)


@pytest.fixture()
def patched(monkeypatch):
    """Connection tokens and sequencer clocks alike in both packages."""
    clock = FakeClock()
    for m in SIDES.values():
        monkeypatch.setattr(m["pipeline"], "uuid", _Uuid())
        monkeypatch.setattr(m["sequencer"], "time",
                            pytypes.SimpleNamespace(time=clock))
    return clock


def _service(side, node):
    m = SIDES[side]
    st = m["store"]
    return m["pipeline"].PipelineFluidService(
        n_partitions=4, device_capacity=64,
        log=st.RemotePartitionedLog(node.host, node.port),
        store=m["summary"].SummaryStore(
            backend=st.RemoteBlobBackend(node.host, node.port)),
        **m["kw"])


def _write(side, svc, doc, text, frame=False):
    """One writer joins ``doc`` and inserts ``text`` one character per op
    from position 0, on the JSON wire (one ``submit`` each) or as one
    frame; the service is pumped and flushed."""
    c = svc.connect(doc)
    svc.pump()
    k, ref = len(text), svc.doc_head(doc)
    origs = [c.conn_no * (1 << 14) + 1 + j for j in range(k)]
    if frame:
        c.submit_frame(SIDES[side]["opframe"].OpFrame.build(
            "s", ["ins"] * k, list(range(k)), origs, list(text), csn0=1,
            ref=ref))
    else:
        t = SIDES[side]["types"]
        for j in range(k):
            c.submit(t.DocumentMessage(
                client_sequence_number=1 + j, reference_sequence_number=ref,
                type=t.MessageType.OPERATION,
                contents={"address": "s", "contents": {
                    "k": "ins", "pos": j, "text": text[j],
                    "orig": origs[j]}}))
    svc.pump()
    svc.flush_device()
    return c


def _stream(svc, doc):
    """(seq, csn, type, contents) of every sequenced message; contents
    with sorted keys (a record that crossed a store node comes back from
    the codec's sorted JSON)."""
    return [(m.sequence_number, m.client_sequence_number, m.type.name,
             json.dumps(m.contents, sort_keys=True))
            for m in svc.get_deltas(doc)]


# -- over the wire --------------------------------------------------------------


@pytest.mark.parametrize("client", ["ref", "port"])
@pytest.mark.parametrize("server", ["ref", "port"])
def test_blobs_round_trip_over_the_wire(nodes, client, server):
    node = nodes[server]
    be = SIDES[client]["store"].RemoteBlobBackend(node.host, node.port)
    h = be.put_blob(b"hello blob")
    assert be.has(h) and not be.has("0" * 64)
    assert be.get_blob(h) == b"hello blob"
    # Content addressing holds across the wire and across packages.
    assert be.put_blob(b"hello blob") == h
    assert h == ref_summary.SummaryStore().put_blob(b"hello blob")


@pytest.mark.parametrize("client", ["ref", "port"])
@pytest.mark.parametrize("server", ["ref", "port"])
def test_log_round_trips_protocol_objects(nodes, client, server):
    node = nodes[server]
    t = SIDES[client]["types"]
    log = SIDES[client]["store"].RemotePartitionedLog(node.host, node.port)
    msg = t.DocumentMessage(
        client_sequence_number=1, reference_sequence_number=0,
        type=t.MessageType.OPERATION, contents={"x": 1})
    p, off = log.send("rawdeltas", "doc", {"t": "raw", "msg": msg})
    recs = log.read("rawdeltas", p, off)
    assert recs[0].value["msg"] == msg  # dataclass round-trip via codec
    log.commit("g", "rawdeltas", p, off + 1)
    assert log.committed("g", "rawdeltas", p) == off + 1
    assert log.end_offset("rawdeltas", p) == off + 1
    assert log.n_partitions == 4


def test_service_replacement_documents_survive(nodes, patched):
    """Write, let the front door die, build a replacement over the same
    store node: it replays the log from offset 0 and serves the same
    documents, then keeps serving writes — the same in both packages."""
    got = {}
    for side in SIDES:
        svc1 = _service(side, nodes[side])
        _write(side, svc1, "doc", "durable ")
        _write(side, svc1, "doc2", "other")
        before = (svc1.device_text("doc", "s"), _stream(svc1, "doc"))
        del svc1  # the service container dies
        svc2 = _service(side, nodes[side])
        after = (svc2.device_text("doc", "s"), _stream(svc2, "doc"))
        assert after == before
        _write(side, svc2, "doc", "still ")
        got[side] = dict(
            before=before, text=svc2.device_text("doc", "s"),
            other=svc2.device_text("doc2", "s"),
            summary=svc2.device_summary("doc", "s"),
            stream=_stream(svc2, "doc"))
    _eq(got["ref"], got["port"], "replacement")
    assert got["port"]["text"] == "still durable "
    assert got["port"]["other"] == "other"


def test_replacement_replay_is_idempotent_downstream(nodes, patched):
    """The replacement re-pumps deli from offset zero, re-producing the
    sequenced stream into the shared remote log; scriptorium's by-seq
    upsert absorbs the duplicates."""
    got = {}
    for side in SIDES:
        svc1 = _service(side, nodes[side])
        _write(side, svc1, "doc", "abc")
        seqs1 = sorted(svc1.ops_store["doc"].ops)
        del svc1
        svc2 = _service(side, nodes[side])
        svc2.pump()
        seqs2 = sorted(svc2.ops_store["doc"].ops)
        assert seqs2[: len(seqs1)] == seqs1  # no gaps, no dup seq keys
        assert len(seqs2) == len(set(seqs2))
        got[side] = (seqs2, svc2.device_text("doc", "s"))
    _eq(got["ref"], got["port"], "replay")
    assert got["port"][1] == "abc"


def _restart_script(side, d):
    st = SIDES[side]["store"]
    node = st.StoreServer(port=0, n_partitions=4, directory=d)
    node.serve_background()
    try:
        log = st.RemotePartitionedLog(node.host, node.port)
        blobs = st.RemoteBlobBackend(node.host, node.port)
        h = blobs.put_blob(b"durable blob")
        sent = [log.send("deltas", f"doc{i % 3}", {"t": "op", "i": i})
                for i in range(10)]
        log.commit("scribe", "deltas", sent[0][0], sent[0][1] + 1)
    finally:
        node.close()
    return h, sent


def test_frames_ride_the_store_node(nodes, patched):
    """The binary frame wire over a store node: the port's codec carries
    ``OpFrame`` and ``SeqFrame`` records (the reference's raises
    ``TypeError`` on them), and the port's service over its store node
    serves what the reference serves over its in-process log."""
    svc = {"port": _service("port", nodes["port"]),
           "ref": ref_pipeline.PipelineFluidService(
               n_partitions=4, device_capacity=64, device_kernel="xla")}
    got = {}
    for side in ("ref", "port"):
        _write(side, svc[side], "fd", "frames", frame=True)
        _write(side, svc[side], "fd", "json ")
        got[side] = (svc[side].device_text("fd", "s"), _stream(svc[side], "fd"),
                     svc[side].device_summary("fd", "s"))
    _eq(got["ref"], got["port"], "frames")
    assert got["port"][0] == "json frames"
    # A replacement front door replays the frames from the store node.
    again = _service("port", nodes["port"])
    assert (again.device_text("fd", "s"), _stream(again, "fd")) == \
        got["port"][:2]
    frame = ref_opframe.OpFrame.build("s", ["ins"], [0], [1], ["x"],
                                      csn0=1, ref=0)
    with pytest.raises(TypeError):
        ref_store.encode_value({"t": "opframe", "frame": frame})


def _read_back(side, d, h, sent):
    st = SIDES[side]["store"]
    node = st.StoreServer(port=0, n_partitions=4, directory=d)
    node.serve_background()
    try:
        assert st.RemoteBlobBackend(node.host, node.port).get_blob(h) == \
            b"durable blob"
        log = st.RemotePartitionedLog(node.host, node.port)
        seen = []
        for p in range(4):
            off = 0
            while True:
                recs = log.read("deltas", p, off)
                if not recs:
                    break
                for r in recs:
                    seen.append((p, r.offset, r.key, r.value["i"]))
                    off = r.offset + 1
        assert sorted(i for *_x, i in seen) == list(range(10))
        assert log.committed("scribe", "deltas", sent[0][0]) == \
            sent[0][1] + 1
        return seen
    finally:
        node.close()


def test_store_node_restart_keeps_logs_and_blobs(tmp_path):
    """Kill the store node itself: with a directory, blobs ride the native
    blob store and the partition logs and consumer offsets the native
    disk log, so a replacement node serves the full history."""
    d = str(tmp_path / "store")
    h, sent = _restart_script("port", d)
    assert os.path.isdir(os.path.join(d, "plog"))
    assert _read_back("port", d, h, sent)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_directory_is_served_by_the_other_package(tmp_path, writer,
                                                    reader):
    """A directory written by one package's store node is served by the
    other's, record for record and blob for blob."""
    d = str(tmp_path / "store")
    h, sent = _restart_script(writer, d)
    assert _read_back(reader, d, h, sent) == _read_back(writer, d, h, sent)


# -- the native store and log ---------------------------------------------------


@pytest.mark.parametrize("on_disk", [False, True])
def test_native_store_and_log_match_the_reference(tmp_path, on_disk):
    """The same inputs through the port's and the reference's native
    blob store and partition log give the same handles, partitions,
    offsets, records and commits."""
    rng = np.random.default_rng(11)
    blobs = [b"", b"x", bytes(range(256)) * 33,
             *(rng.bytes(int(n)) for n in rng.integers(1, 5000, 6))]
    records = [(f"topic{i % 2}", f"key-{int(k)}", rng.bytes(int(n)))
               for i, (k, n) in enumerate(zip(rng.integers(0, 40, 48),
                                              rng.integers(0, 300, 48)))]
    out = {}
    for side, m in SIDES.items():
        nat = m["native"]
        d = str(tmp_path / side) if on_disk else None
        if d:
            os.makedirs(os.path.join(d, "plog"))
        store = nat.NativeBlobStore(d)
        handles = [store.put_blob(b) for b in blobs]
        assert [store.get_blob(h) for h in handles] == blobs
        log = nat.NativePartitionLog(d and os.path.join(d, "plog"), 8)
        sent = [log.send(t, k, v) for t, k, v in records]
        log.commit("g", "topic0", 3, 5)
        log.commit("g", "topic0", 3, 2)  # never moves back
        back = [log.read(t, p, off)
                for (t, _k, _v), (p, off) in zip(records, sent)]
        assert back == [(k, v) for _t, k, v in records]
        ends = {(t, p): log.end_offset(t, p)
                for t in ("topic0", "topic1") for p in range(8)}
        out[side] = (handles, sent, ends, log.committed("g", "topic0", 3),
                     log.read("topic0", 0, 10_000),
                     store.has("0" * 64))
        if d:  # reopened from disk
            del store, log
            log2 = nat.NativePartitionLog(os.path.join(d, "plog"), 8)
            assert [log2.read(t, p, off) for (t, _k, _v), (p, off)
                    in zip(records, sent)] == back
            assert nat.NativeBlobStore(d).get_blob(handles[2]) == blobs[2]
    _eq(out["ref"], out["port"], "native")
    assert out["port"][0][0] == ref_summary.SummaryStore().put_blob(b"")


def test_summary_store_over_the_native_backend():
    """``SummaryStore(native=True)`` stores summaries in the native blob
    store under the same handles as the reference's."""
    summary = {
        "sequence_number": 7, "quorum": [0, 1],
        "channels": {"text": {"lanes": {"kind": [1]}, "count": 1}},
    }
    handles = []
    for m in SIDES.values():
        store = m["summary"].SummaryStore(native=True)
        h = store.put_summary(summary)
        assert store.get_summary(h)["channels"]["text"]["count"] == 1
        handles.append(h)
    assert handles[0] == handles[1]


def test_the_native_libraries_build_outside_native(tmp_path, monkeypatch):
    """The port compiles the native sources into its own build directory,
    one library per source named by its hash, and never into
    ``native/``; a source that cannot be built makes the store node with
    a directory raise rather than fall back to memory."""
    monkeypatch.setattr(port_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(port_native, "_libs", {})
    before = sorted(os.listdir(port_native.NATIVE_DIR))
    assert port_native.native_store_available()
    assert port_native.native_plog_available()
    assert port_native.NativeTicketLoop().available
    built = sorted(os.listdir(tmp_path / "build"))
    assert [b.split("-")[0] for b in built] == \
        ["libcastore", "libplog", "libticket"]
    assert sorted(os.listdir(port_native.NATIVE_DIR)) == before
    monkeypatch.setattr(port_native, "_libs", {"libplog": None})
    assert not port_native.native_plog_available()
    with pytest.raises(RuntimeError, match="libplog"):
        port_store.StoreServer(port=0, directory=str(tmp_path / "d"))
    monkeypatch.setattr(port_native, "NATIVE_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(port_native, "_libs", {})
    assert not port_native.native_store_available()
    with pytest.raises(RuntimeError, match="libcastore"):
        port_store.StoreServer(port=0, directory=str(tmp_path / "d"))


def test_store_server_main_runs_a_store_node(tmp_path):
    """``python -m fluidframework_tpu_torch.service.store_server`` serves
    a disk-backed node that a client reaches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.store_server",
         "--host", "127.0.0.1", "--port", "0",
         "--dir", str(tmp_path / "node")],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("store node on "), line
        port = int(line.rsplit(":", 1)[1])
        be = port_store.RemoteBlobBackend("127.0.0.1", port)
        h = be.put_blob(b"node blob")
        assert be.get_blob(h) == b"node blob"
        assert os.path.exists(tmp_path / "node" / h[:2] / h[2:])
    finally:
        proc.terminate()
        proc.wait(timeout=15)
