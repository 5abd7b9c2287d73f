"""The port's SharedString over its ContainerRuntime against the reference.

Each test runs the same script on the reference (``ContainerRuntime`` +
``SharedString`` over ``LocalFluidService``, the XLA merge kernel on the
CPU) and on the port (the same classes, ``SharedString(device="cpu")``:
K1/K2's plain versions), and compares the texts, every lane of every
replica's segment table and the summaries' JSON bytes. Compaction and
growth are counted in both packages' modules and must fall at the same
ops. The :class:`Side` helper is shared with the other client-DDS tests.
"""

import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.drivers.replay_driver import (
    ReplayDocumentService as RefReplay,
)
from fluidframework_tpu.framework import undo_redo as ref_undo
from fluidframework_tpu.models import shared_matrix as ref_matrix_mod
from fluidframework_tpu.models import shared_string as ref_string_mod
from fluidframework_tpu.models.shared_map import SharedMap as RefMap
from fluidframework_tpu.models.sparse_matrix import SparseMatrix as RefSparse
from fluidframework_tpu.ops import segment_state as RS
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu.service.summary_store import SummaryStore as RefStore
from fluidframework_tpu_torch.drivers.replay_driver import (
    ReplayDocumentService,
)
from fluidframework_tpu_torch.framework import undo_redo as port_undo
from fluidframework_tpu_torch.interop import segment_state_to_numpy
from fluidframework_tpu_torch.models import shared_matrix as port_matrix_mod
from fluidframework_tpu_torch.models import shared_string as port_string_mod
from fluidframework_tpu_torch.models.shared_map import SharedMap
from fluidframework_tpu_torch.models.sparse_matrix import SparseMatrix
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from fluidframework_tpu_torch.service.summary_store import SummaryStore

REF = SimpleNamespace(
    port=False, RT=RefRT, Svc=RefSvc, Replay=RefReplay, Store=RefStore,
    SharedString=ref_string_mod.SharedString,
    SharedMatrix=ref_matrix_mod.SharedMatrix, SparseMatrix=RefSparse,
    SharedMap=RefMap, undo=ref_undo, string_mod=ref_string_mod,
    matrix_mod=ref_matrix_mod,
)
PORT = SimpleNamespace(
    port=True, RT=ContainerRuntime, Svc=LocalFluidService,
    Replay=ReplayDocumentService, Store=SummaryStore,
    SharedString=functools.partial(port_string_mod.SharedString,
                                   device="cpu"),
    SharedMatrix=functools.partial(port_matrix_mod.SharedMatrix,
                                   device="cpu"),
    SparseMatrix=functools.partial(SparseMatrix, device="cpu"),
    SharedMap=SharedMap, undo=port_undo, string_mod=port_string_mod,
    matrix_mod=port_matrix_mod,
)


def lanes(state, port: bool) -> tuple:
    if port:
        return segment_state_to_numpy(state)
    return tuple(np.array(x, np.int32) for x in RS.to_host(state))


class Side:
    """One package's service and runtimes; ``make(ns)`` gives each new
    runtime its channels."""

    def __init__(self, ns, n: int, make):
        self.ns = ns
        self.svc = ns.Svc()
        self._make = make
        self.rts = [self.new_rt() for _ in range(n)]

    def new_rt(self):
        return self.ns.RT(self.svc, "doc", channels=self._make(self.ns))

    def ch(self, i: int, cid: str):
        return self.rts[i].get_channel(cid)

    def drain(self):
        for rt in self.rts:
            if rt.connected:
                rt.flush()
        busy = True
        while busy:
            busy = any(rt.process_incoming() for rt in self.rts
                       if rt.connected)


def both(n: int, make):
    return Side(REF, n, make), Side(PORT, n, make)


def summary_bytes(channel) -> str:
    return json.dumps(channel.summarize_core())


def same_strings(ref: Side, port: Side, cid: str = "text", what=""):
    """Texts, annotations, every lane of every replica and the summary
    bytes equal across the packages."""
    for i, (a, b) in enumerate(zip(ref.rts, port.rts)):
        ra, pb = a.get_channel(cid), b.get_channel(cid)
        assert pb.get_text() == ra.get_text(), f"{what}: text of rt {i}"
        assert pb.annotations() == ra.annotations(), what
        assert pb.err_flags == ra.err_flags, what
        for name, x, y in zip(RS.SegmentState._fields,
                              lanes(pb._state, True),
                              lanes(ra._state, False)):
            assert np.array_equal(x, y), f"{what}: rt {i} lane {name}"
        assert summary_bytes(pb) == summary_bytes(ra), f"{what}: rt {i}"


class Counted:
    """Counts calls of ``compact`` and ``grow`` in one DDS module, with the
    op index at which each happened."""

    def __init__(self, monkeypatch, module, clock):
        self.compacts, self.grows = [], []
        for name, log in (("compact", self.compacts), ("grow", self.grows)):
            fn = getattr(module, name)

            def wrapped(*a, _fn=fn, _log=log, **kw):
                _log.append(clock[0])
                return _fn(*a, **kw)

            monkeypatch.setattr(module, name, wrapped)


def to_port_msg(m):
    """A reference sequenced message as the port's (same fields)."""
    kw = {f: getattr(m, f) for f in (
        "client_id", "sequence_number", "client_sequence_number",
        "reference_sequence_number", "minimum_sequence_number",
        "contents", "metadata", "timestamp")}
    kw["contents"] = json.loads(json.dumps(m.contents))
    return port_types.SequencedDocumentMessage(
        type=port_types.MessageType(m.type.value), **kw)


def config1_author(ns, n_ops: int, clock):
    """``bench_configs.config1_single_doc_replay``'s author script: seed 0,
    45% removes, flush and ``process_incoming`` every 16 ops."""
    rng = np.random.default_rng(0)
    svc = ns.Svc()
    author = ns.RT(svc, "doc", channels=(ns.SharedString("text"),))
    s = author.get_channel("text")
    for i in range(n_ops):
        clock[0] = i
        length = len(s.get_text())
        if length > 8 and rng.random() < 0.45:
            a = int(rng.integers(0, length - 2))
            s.remove_range(a, a + int(rng.integers(1, 3)))
        else:
            s.insert_text(int(rng.integers(0, length + 1)), "ab")
        if i % 16 == 0:
            author.flush()
            author.process_incoming()
    author.flush()
    author.process_incoming()
    return svc, author


def test_config1_replay_at_1000_ops(monkeypatch):
    """Config 1 at 1,000 ops: the author compacts and grows at the same
    ops in both packages and ends with the same table; a reader replaying
    the deltas log through each package's ``ReplayDocumentService`` equals
    the author's text and the reference reader's lanes and summary; a
    port reader fed the reference's own log equals it too."""
    clocks = {}
    counts = {}
    authors = {}
    for ns in (REF, PORT):
        clocks[ns.port] = [0]
        counts[ns.port] = Counted(monkeypatch, ns.string_mod,
                                  clocks[ns.port])
        authors[ns.port] = config1_author(ns, 1000, clocks[ns.port])
    assert counts[True].compacts == counts[False].compacts
    assert counts[True].grows == counts[False].grows
    assert counts[True].compacts and counts[True].grows
    (ref_svc, ref_author), (port_svc, port_author) = (authors[False],
                                                      authors[True])
    ra, pa = ref_author.get_channel("text"), port_author.get_channel("text")
    assert pa.get_text() == ra.get_text()
    assert summary_bytes(pa) == summary_bytes(ra)

    readers = {}
    for ns, svc in ((REF, ref_svc), (PORT, port_svc)):
        replay = ns.Replay(svc.get_deltas("doc"), doc_id="doc")
        rt = ns.RT(replay, "doc", channels=(ns.SharedString("text"),))
        rt.process_incoming()
        readers[ns.port] = rt.get_channel("text")
    assert readers[True].get_text() == ra.get_text()
    for x, y in zip(lanes(readers[True]._state, True),
                    lanes(readers[False]._state, False)):
        assert np.array_equal(x, y)
    assert summary_bytes(readers[True]) == summary_bytes(readers[False])

    cross = ReplayDocumentService(
        [to_port_msg(m) for m in ref_svc.get_deltas("doc")], doc_id="doc")
    rt = ContainerRuntime(cross, "doc",
                          channels=(PORT.SharedString("text"),))
    rt.process_incoming()
    assert summary_bytes(rt.get_channel("text")) == \
        summary_bytes(readers[False])


def string_script(sides, rng, steps: int, offline_at=()):
    """Concurrent edits on every runtime of both sides (decisions drawn
    once, from the reference's state), flushes and partial deliveries,
    and runtime 0 going offline with pending inserts, removes and
    annotates at the steps in ``offline_at``, back two steps later."""
    ref, port = sides
    for step in range(steps):
        i = int(rng.integers(0, len(ref.rts)))
        text = ref.ch(i, "text").get_text()
        r = rng.random()
        if len(text) > 4 and r < 0.35:
            a = int(rng.integers(0, len(text) - 1))
            b = min(len(text), a + int(rng.integers(1, 4)))
            op = ("remove_range", a, b)
        elif len(text) > 4 and r < 0.5:
            a = int(rng.integers(0, len(text) - 1))
            b = min(len(text), a + int(rng.integers(1, 5)))
            op = ("annotate", a, b, int(rng.integers(1, 9)))
        else:
            word = "".join(chr(97 + int(x)) for x in rng.integers(0, 26, 3))
            op = ("insert_text", int(rng.integers(0, len(text) + 1)), word)
        for side in sides:
            getattr(side.ch(i, "text"), op[0])(*op[1:])
        if step in offline_at:
            for side in sides:
                side.rts[0].disconnect()
        if step - 2 in offline_at:
            for side in sides:
                side.rts[0].reconnect()
        if rng.random() < 0.3:
            for side in sides:
                side.rts[i].flush()
        if rng.random() < 0.3:
            k = int(rng.integers(0, len(ref.rts)))
            n = int(rng.integers(1, 4))
            for side in sides:
                if side.rts[k].connected:
                    side.rts[k].process_incoming(n)
        same_strings(ref, port, what=f"step {step}")
    for side in sides:
        side.drain()
    same_strings(ref, port, what="drained")
    texts = {s.ch(i, "text").get_text() for s in sides
             for i in range(len(s.rts))}
    assert len(texts) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_concurrent_edits_with_reconnect_in_lockstep(seed):
    """Three runtimes with small tables (capacity 32, so compaction and
    growth run on states full of pending rows); runtime 0 disconnects
    twice with pending ops, which regenerate through ``begin_resubmit`` /
    ``resubmit_core`` and ``on_reconnect`` (``adopt_client_slot``). Every
    lane, text and summary equals the reference's after every step."""
    sides = both(3, lambda ns: (ns.SharedString("text", capacity=32),))
    string_script(sides, np.random.default_rng(seed), 90,
                  offline_at=(20, 55))


def test_stashed_state_rehydrates_in_lockstep():
    """``get_pending_local_state`` then ``rehydrate`` into a new runtime:
    ``adopt_stashed_slot`` and ``on_reconnect`` on a loaded table with
    pending rows, the same in both packages."""
    sides = both(2, lambda ns: (ns.SharedString("text"),))
    for side in sides:
        s = side.ch(0, "text")
        s.insert_text(0, "hello world")
        side.drain()
        side.rts[0].disconnect()
        s.insert_text(5, ",")
        s.remove_range(0, 2)
        s.annotate(3, 8, 4)
        side.ch(1, "text").insert_text(0, ">>")
        side.drain()
    stashes = [json.loads(json.dumps(s.rts[0].get_pending_local_state()))
               for s in sides]
    assert json.dumps(stashes[1]) == json.dumps(stashes[0])
    for side, stash in zip(sides, stashes):
        side.rts[0] = side.ns.RT.rehydrate(
            side.svc, "doc", stash,
            channels=(side.ns.SharedString("text"),))
        side.drain()
    same_strings(*sides, what="rehydrated")
    assert sides[1].ch(0, "text").get_text() == \
        sides[1].ch(1, "text").get_text()


def test_loaded_from_a_reference_summary_converges():
    """The reference container's summary (a JSON round trip) loads into a
    reference and a port runtime, which replay the rest of the
    reference's deltas log (the port's as port messages): both equal the
    reference replicas' text, and each other's lanes and summary."""
    ref = Side(REF, 2, lambda ns: (ns.SharedString("text"),))
    rng = np.random.default_rng(4)
    for step in range(40):
        s = ref.ch(step % 2, "text")
        n = len(s.get_text())
        if n > 3 and rng.random() < 0.4:
            a = int(rng.integers(0, n - 1))
            s.remove_range(a, a + 1)
        elif n > 3 and rng.random() < 0.3:
            s.annotate(0, 2, step)
        else:
            s.insert_text(int(rng.integers(0, n + 1)), "xy")
        if step == 25:
            ref.drain()
            seq = ref.rts[0].ref_seq
            summary = json.dumps(ref.rts[0].summarize())
    ref.drain()
    loaded = []
    for ns in (REF, PORT):
        store = ns.Store()
        handle = store.put_summary(json.loads(summary))
        msgs = ref.svc.get_deltas("doc")
        if ns.port:
            msgs = [to_port_msg(m) for m in msgs]
        replay = ns.Replay(msgs, doc_id="doc",
                           initial_summary=(handle, seq), store=store)
        rt = ns.RT(replay, "doc", channels=(ns.SharedString("text"),))
        rt.process_incoming()
        loaded.append(rt.get_channel("text"))
    want = ref.ch(1, "text")
    assert loaded[1].get_text() == loaded[0].get_text() == want.get_text()
    assert loaded[1].annotations() == want.annotations()
    for x, y in zip(lanes(loaded[1]._state, True),
                    lanes(loaded[0]._state, False)):
        assert np.array_equal(x, y)
    assert summary_bytes(loaded[1]) == summary_bytes(loaded[0])
