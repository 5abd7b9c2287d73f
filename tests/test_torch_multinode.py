"""Parity: the port's multi-node ordering (``service/multinode.py``:
``FencedOpLog``, ``CheckpointTable``, ``OrderingNode``, ``NodeCluster``,
``MultiNodeConnection``, ``MultiNodeFluidService``) against the JAX
package's, each over its own container runtime and DDSes, over both
coordination backends (the pure-Python ``ReservationManager`` and the C++
``NativeCoordination`` built from ``native/coordination.cpp``).

Each case of tests/test_multinode.py runs once per package with the same
script, the same seeds and a fake clock at the same times; the two runs
must then agree exactly: every document's durable op log (sequence
numbers, clients, client sequence numbers, refs, MSNs, types, contents),
the log and checkpoint epochs, the lease holders and epochs, each node's
owned documents and load, the migrations and every replica's text.
"""

import types as pytypes

import numpy as np
import pytest

import test_torch_pipeline as TP
from fluidframework_tpu.models.shared_map import SharedMap as RefMap
from fluidframework_tpu.models.shared_string import SharedString as RefString
from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service import multinode as ref_multinode
from fluidframework_tpu.service import pipeline as ref_pipeline
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.utils import native as ref_native
from fluidframework_tpu_torch.models.shared_map import SharedMap as PortMap
from fluidframework_tpu_torch.models.shared_string import (
    SharedString as PortString,
)
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.runtime.container import (
    ContainerRuntime as PortRT,
)
from fluidframework_tpu_torch.service import multinode as port_multinode
from fluidframework_tpu_torch.service import pipeline as port_pipeline
from fluidframework_tpu_torch.service import sequencer as port_sequencer
from fluidframework_tpu_torch.utils import native as port_native

SIDES = {
    "ref": dict(mn=ref_multinode, rt=RefRT, types=ref_types,
                string=RefString, map=RefMap, pipeline=ref_pipeline,
                sequencer=ref_sequencer, native=ref_native),
    "port": dict(mn=port_multinode, rt=PortRT, types=port_types,
                 string=lambda cid: PortString(cid, device="cpu"),
                 map=PortMap, pipeline=port_pipeline,
                 sequencer=port_sequencer, native=port_native),
}
COORDS = ["python", "native"]


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class Side:
    """One package's cluster, runtimes and fake clock (which the
    package's sequencer and multinode modules also read for their
    ``time.time()`` stamps)."""

    def __init__(self, side, coord, monkeypatch, **kw):
        self.m = SIDES[side]
        self.clock = Clock()
        fake = pytypes.SimpleNamespace(time=self.clock, monotonic=self.clock)
        monkeypatch.setattr(self.m["sequencer"], "time", fake)
        monkeypatch.setattr(self.m["mn"], "time", fake)
        if coord == "native":
            if not self.m["native"].native_coordination_available():
                pytest.skip("native/coordination.cpp did not build")
            res = self.m["native"].NativeCoordination(self.clock)
        else:
            res = self.m["pipeline"].ReservationManager(self.clock)
        self.coord = res
        self.svc = self.m["mn"].MultiNodeFluidService(
            clock=self.clock, reservations=res, **kw)

    def rt(self, doc, kind="string", cid="t"):
        return self.m["rt"](self.svc, doc, channels=(self.m[kind](cid),))

    def node(self, name):
        return next(n for n in self.svc.cluster.nodes if n.name == name)

    def holder(self, doc):
        return self.svc.cluster.reservations.holder(doc)


def drain(rts):
    for rt in rts:
        rt.flush()
    busy = True
    while busy:
        busy = any(rt.process_incoming() for rt in rts)


def view(s: Side, rts=()):
    """Everything the two runs must agree on, package-free."""
    cl = s.svc.cluster
    logs = {
        d: [(m.sequence_number, m.client_id, m.client_sequence_number,
             m.reference_sequence_number, m.minimum_sequence_number,
             m.type.name, TP._norm(m.contents))
            for m in log]
        for d, log in sorted(cl.op_log._log.items())
    }
    return {
        "logs": logs,
        "log_epochs": dict(cl.op_log._epochs),
        "checkpoints": {
            d: (e, TP._norm(cp))
            for d, (e, cp) in sorted(cl.checkpoints._data.items())
        },
        "holders": {d: s.holder(d) for d in logs},
        "nodes": [(n.name, n.alive, sorted(n._docs), dict(n._epochs),
                   round(n.load(), 9)) for n in cl.nodes],
        "migrations": list(s.svc.migrations),
        "texts": [rt.get_channel("t").get_text() if hasattr(
            rt.get_channel("t"), "get_text") else
            sorted(rt.get_channel("t").keys()) for rt in rts],
    }


def lockstep(script, coord, monkeypatch, **kw):
    """Run ``script(side) -> runtimes`` on both packages; the two views
    must be equal. Returns the port's Side and runtimes."""
    out = {}
    for name in ("ref", "port"):
        s = Side(name, coord, monkeypatch, **kw)
        rts = script(s)
        out[name] = (s, rts, view(s, rts))
    TP._eq(out["ref"][2], out["port"][2], "multinode")
    return out["port"][0], out["port"][1]


@pytest.mark.parametrize("coord", COORDS)
def test_documents_spread_and_converge(coord, monkeypatch):
    def script(s):
        rts = []
        for d in ("doc-a", "doc-b", "doc-c", "doc-d"):
            pair = [s.rt(d), s.rt(d)]
            pair[0].get_channel("t").insert_text(0, d)
            drain(pair)
            assert pair[1].get_channel("t").get_text() == d
            rts += pair
        return rts

    s, _rts = lockstep(script, coord, monkeypatch, n_nodes=3)
    owners = {s.holder(d) for d in ("doc-a", "doc-b", "doc-c", "doc-d")}
    assert len(owners) > 1


@pytest.mark.parametrize("coord", COORDS)
def test_load_rebalance_dissipates_hotspot(coord, monkeypatch):
    docs = [f"hot-{i}" for i in range(6)]

    def script(s):
        node0 = s.svc.cluster.nodes[0]
        for d in docs:
            assert node0.try_own(d)
        rts = {d: [s.rt(d), s.rt(d)] for d in docs}
        for r in range(6):
            for d in docs:
                rts[d][r % 2].get_channel("t").insert_text(0, f"r{r}.")
                drain(rts[d])
        for d in docs:
            rts[d][0].get_channel("t").insert_text(0, "post.")
            drain(rts[d])
        return [rt for d in docs for rt in rts[d]]

    s, rts = lockstep(script, coord, monkeypatch, n_nodes=3,
                      rebalance_every=10)
    assert s.svc.migrations
    assert len({s.holder(d) for d in docs}) > 1
    for d in docs:
        seqs = [m.sequence_number for m in s.svc.cluster.op_log.read(d, 0)]
        assert seqs == sorted(set(seqs))
    assert {rt.get_channel("t").get_text() for rt in rts[:2]} == \
        {"post." + "".join(f"r{r}." for r in reversed(range(6)))}


@pytest.mark.parametrize("coord", COORDS)
def test_node_failure_migrates_documents(coord, monkeypatch):
    def script(s):
        a, b = s.rt("doc"), s.rt("doc")
        a.get_channel("t").insert_text(0, "before-crash ")
        drain([a, b])
        owner = s.holder("doc")
        s.node(owner).kill()
        s.clock.now += 10
        b.get_channel("t").insert_text(0, "after-crash ")
        drain([a, b])
        assert s.holder("doc") != owner
        return [a, b]

    s, (a, b) = lockstep(script, coord, monkeypatch, n_nodes=3,
                         lease_ttl_s=5.0)
    assert a.get_channel("t").get_text() == "after-crash before-crash "
    seqs = [m.sequence_number for m in s.svc.get_deltas("doc")]
    assert seqs == list(range(1, len(seqs) + 1))


@pytest.mark.parametrize("coord", COORDS)
def test_stale_owner_is_fenced(coord, monkeypatch):
    def script(s):
        a = s.rt("doc", kind="map", cid="t")
        a.get_channel("t").set("k", 1)
        drain([a])
        owner = s.holder("doc")
        stale = s.node(owner)
        s.clock.now += 10
        other = next(n for n in s.svc.cluster.nodes if n.name != owner)
        assert other.try_own("doc")
        zombie = stale._docs["doc"]
        t = s.m["types"]
        res = stale.ticket("doc", a.client_id, t.DocumentMessage(
            zombie.clients[a.client_id].client_seq + 1, zombie.seq,
            t.MessageType.OPERATION,
            contents={"address": "t", "contents": None}))
        assert isinstance(res, t.NackMessage)
        return [a]

    s, _rts = lockstep(script, coord, monkeypatch, n_nodes=2,
                       lease_ttl_s=5.0)
    assert s.svc.cluster.op_log._epochs["doc"] >= 2


@pytest.mark.parametrize("coord", COORDS)
def test_load_profile_over_cluster(coord, monkeypatch):
    """A seeded multi-writer load over three nodes (the counterpart of
    the reference's LoadRunner profile, which drives only its own
    package): random inserts and removes from four clients, offline
    stretches with reconnects, a node crash and a rebalance cadence; all
    replicas converge."""
    def script(s):
        rng = np.random.default_rng(11)
        rts = [s.rt("cluster-load") for _ in range(4)]
        drain(rts)
        for step in range(150):
            i = int(rng.integers(4))
            t = rts[i].get_channel("t")
            n = len(t.get_text())
            if n > 4 and rng.random() < 0.3:
                a = int(rng.integers(0, n - 2))
                t.remove_range(a, a + int(rng.integers(1, 3)))
            else:
                t.insert_text(int(rng.integers(0, n + 1)),
                              chr(97 + step % 26))
            if step == 60:
                rts[3].disconnect()
            if step == 72:
                rts[3].reconnect()
            if step == 100:
                s.node(s.holder("cluster-load")).kill()
                s.clock.now += 10
            if rng.random() < 0.5:
                drain(rts if step < 60 or step >= 72 else rts[:3])
        drain(rts)
        return rts

    _s, rts = lockstep(script, coord, monkeypatch, n_nodes=3,
                       rebalance_every=16)
    assert len({rt.get_channel("t").get_text() for rt in rts}) == 1


def test_native_coordination_backend(monkeypatch):
    """The C++ backend alone: voluntary release and takeover bump the
    epoch; a crash after it fails over."""
    def script(s):
        a, b = s.rt("doc"), s.rt("doc")
        a.get_channel("t").insert_text(0, "native")
        drain([a, b])
        owner = s.holder("doc")
        before = s.coord.epoch("doc")
        other = next(n for n in s.svc.cluster.nodes if n.name != owner)
        assert s.node(owner).release_doc("doc")
        assert other.try_own("doc")
        b.get_channel("t").insert_text(6, "-coord")
        drain([a, b])
        assert s.holder("doc") == other.name
        assert s.coord.epoch("doc") > before
        s.node(s.holder("doc")).kill()
        s.clock.now += 10
        b.get_channel("t").insert_text(0, "x")
        drain([a, b])
        return [a, b]

    _s, (a, _b) = lockstep(script, "native", monkeypatch, n_nodes=2)
    assert a.get_channel("t").get_text() == "xnative-coord"


@pytest.mark.parametrize("coord", COORDS)
def test_summary_gated_log_truncation(coord, monkeypatch):
    def script(s):
        a, b = s.rt("doc"), s.rt("doc")
        for i in range(6):
            a.get_channel("t").insert_text(0, f"{i}-")
            drain([a, b])
        before = len(s.svc.cluster.op_log.read("doc"))
        a.submit_summary()
        drain([a, b])
        a.send_noop()
        b.send_noop()
        drain([a, b])
        a.get_channel("t").insert_text(0, "post-")
        drain([a, b])
        a.submit_summary()
        drain([a, b])
        assert len(s.svc.cluster.op_log.read("doc")) < before
        late = s.rt("doc")
        drain([a, b, late])
        s.node(s.holder("doc")).kill()
        s.clock.now += 10
        b.get_channel("t").insert_text(0, "failover-")
        drain([a, b, late])
        return [a, b, late]

    _s, rts = lockstep(script, coord, monkeypatch, n_nodes=2)
    texts = {rt.get_channel("t").get_text() for rt in rts}
    assert len(texts) == 1 and texts.pop().startswith("failover-")


@pytest.mark.parametrize("coord", COORDS)
def test_reconnect_below_retained_window_fails_loudly(coord, monkeypatch):
    def script(s):
        a, b = s.rt("doc"), s.rt("doc")
        a.get_channel("t").insert_text(0, "early")
        drain([a, b])
        b.disconnect()
        for i in range(4):
            a.get_channel("t").insert_text(0, f"{i}-")
            drain([a])
        a.submit_summary()
        drain([a])
        a.send_noop()
        drain([a])
        a.get_channel("t").insert_text(0, "post-")
        drain([a])
        a.submit_summary()
        drain([a])
        first = s.svc.cluster.op_log.read("doc")[0].sequence_number
        assert b.ref_seq + 1 < first
        with pytest.raises(ConnectionError, match="retained op window"):
            b.reconnect()
        fresh = s.rt("doc")
        drain([a, fresh])
        return [a, fresh]

    _s, (a, fresh) = lockstep(script, coord, monkeypatch, n_nodes=2)
    assert fresh.get_channel("t").get_text() == a.get_channel("t").get_text()


def test_fenced_log_and_checkpoint_table():
    """The shared stores alone: epoch fencing, idempotent replay, fork
    rejection, truncation, checkpoint fencing — the same answers from
    both packages."""
    out = {}
    for name, m in SIDES.items():
        mn, t = m["mn"], m["types"]
        log, cps = mn.FencedOpLog(), mn.CheckpointTable()

        def msg(seq, client=1, csn=1):
            return t.SequencedDocumentMessage(
                client_id=client, sequence_number=seq,
                client_sequence_number=csn, reference_sequence_number=0,
                minimum_sequence_number=0, type=t.MessageType.OPERATION,
                contents=None)

        res = [log.append("d", 1, msg(1)), log.append("d", 1, msg(2, csn=2))]
        log.fence("d", 3)
        res += [log.append("d", 2, msg(3, csn=3)),
                log.append("d", 3, msg(2, csn=2)),
                log.append("d", 3, msg(2, client=9)),
                log.append("d", 3, msg(3, csn=3)),
                log.truncate("d", 1),
                [m.sequence_number for m in log.read("d")],
                log.read("x")]
        seq = m["mn"].DocumentSequencer("d", None)
        cps.fence("d", 2)
        res += [cps.save("d", 1, seq.checkpoint()),
                cps.save("d", 2, seq.checkpoint()),
                TP._norm(cps.load("d").__dict__), cps.load("y")]
        out[name] = res
    TP._eq(out["ref"], out["port"], "stores")
