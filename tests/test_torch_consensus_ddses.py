"""Parity: the port's consensus-family DDSes (``models/shared_cell.py``,
``shared_counter.py``, ``consensus_register.py``,
``ordered_collection.py``, ``task_manager.py``, ``pact_map.py``) and the
quorum proposals of its ``ContainerRuntime``, against the reference's.

Each case of tests/test_consensus_ddses.py runs once per package
(reference classes over the reference's ``LocalFluidService``, port
classes over the port's): the reference test's assertions hold on both,
and each replica's observable state and summary (JSON bytes) must be
equal across the packages at every checkpoint of the script. The ordered
collection's item ids (``uuid``) come from one counter per package.
"""

import json
import types as pytypes

import pytest

import test_torch_pipeline as TP
from fluidframework_tpu.models import consensus_register as ref_register
from fluidframework_tpu.models import ordered_collection as ref_ordered
from fluidframework_tpu.models import pact_map as ref_pact
from fluidframework_tpu.models import shared_cell as ref_cell
from fluidframework_tpu.models import shared_counter as ref_counter
from fluidframework_tpu.models import task_manager as ref_task
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu_torch.models import consensus_register as register
from fluidframework_tpu_torch.models import ordered_collection as ordered
from fluidframework_tpu_torch.models import pact_map as pact
from fluidframework_tpu_torch.models import shared_cell as cell
from fluidframework_tpu_torch.models import shared_counter as counter
from fluidframework_tpu_torch.models import task_manager as task
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service.local_server import LocalFluidService

REF = pytypes.SimpleNamespace(
    RT=RefRT, Svc=RefSvc, SharedCell=ref_cell.SharedCell,
    SharedCounter=ref_counter.SharedCounter,
    ConsensusRegisterCollection=ref_register.ConsensusRegisterCollection,
    ConsensusOrderedCollection=ref_ordered.ConsensusOrderedCollection,
    TaskManager=ref_task.TaskManager, PactMap=ref_pact.PactMap,
    ordered_mod=ref_ordered,
)
PORT = pytypes.SimpleNamespace(
    RT=ContainerRuntime, Svc=LocalFluidService, SharedCell=cell.SharedCell,
    SharedCounter=counter.SharedCounter,
    ConsensusRegisterCollection=register.ConsensusRegisterCollection,
    ConsensusOrderedCollection=ordered.ConsensusOrderedCollection,
    TaskManager=task.TaskManager, PactMap=pact.PactMap,
    ordered_mod=ordered,
)


@pytest.fixture(autouse=True)
def _same_uuids(monkeypatch):
    for ns in (REF, PORT):
        monkeypatch.setattr(ns.ordered_mod, "uuid", TP.FakeUuid())


def pair(ns, name, cid):
    svc = ns.Svc()
    a = ns.RT(svc, "doc", channels=(getattr(ns, name)(cid),))
    b = ns.RT(svc, "doc", channels=(getattr(ns, name)(cid),))
    return svc, a, b


def drain(*rts):
    busy = True
    while busy:
        busy = any(rt.process_incoming() for rt in rts)


def state(ch) -> str:
    """A channel's summary as JSON bytes (its whole persisted state)."""
    return json.dumps(ch.summarize_core(), sort_keys=True)


def both_over(script, ref, port):
    """Run ``script(ns, log)`` with each package's namespace; ``log(x)``
    records an observation, and the two packages' records must be
    equal."""
    logs = {}
    for name, ns in (("ref", ref), ("port", port)):
        log = []
        script(ns, log.append)
        logs[name] = log
    assert logs["port"] == logs["ref"]
    assert logs["port"], "nothing was observed"


def both(script):
    both_over(script, REF, PORT)


def test_cell_lww_and_pending_wins():
    def script(ns, log):
        _, a, b = pair(ns, "SharedCell", "c")
        ca, cb = a.get_channel("c"), b.get_channel("c")
        ca.set(1)
        cb.set(2)
        log((ca.get(), cb.get(), state(ca), state(cb)))
        a.flush()
        b.flush()
        drain(a, b)
        assert ca.get() == cb.get() == 2
        log((ca.get(), state(ca), state(cb)))
        cb.delete()
        drain(a, b)
        assert ca.empty and cb.empty
        log((ca.empty, cb.empty, state(ca), state(cb)))
    both(script)


def test_counter_commutes():
    def script(ns, log):
        _, a, b = pair(ns, "SharedCounter", "n")
        na, nb = a.get_channel("n"), b.get_channel("n")
        na.increment(5)
        nb.increment(-2)
        na.increment(1)
        log((na.value, nb.value))
        drain(a, b)
        assert na.value == nb.value == 4
        log((na.value, nb.value, state(na), state(nb)))
    both(script)


def test_register_consensus_no_optimism():
    def script(ns, log):
        _, a, b = pair(ns, "ConsensusRegisterCollection", "r")
        ra, rb = a.get_channel("r"), b.get_channel("r")
        ra.write("k", "A")
        assert ra.read("k") is None  # not applied until sequenced
        drain(a, b)
        assert ra.read("k") == rb.read("k") == "A"
        log((ra.read("k"), sorted(rb.keys()), state(ra), state(rb)))
    both(script)


def test_register_concurrent_versions():
    def script(ns, log):
        _, a, b = pair(ns, "ConsensusRegisterCollection", "r")
        ra, rb = a.get_channel("r"), b.get_channel("r")
        ra.write("k", "A")
        rb.write("k", "B")  # concurrent: same refSeq
        a.flush()
        b.flush()
        drain(a, b)
        assert ra.read("k") == rb.read("k") == "B"
        assert set(ra.read_versions("k")) == {"A", "B"}
        log((ra.read_versions("k"), rb.read_versions("k"), state(ra)))
        ra.write("k", "C")
        drain(a, b)
        assert rb.read_versions("k") == ["C"]
        log((ra.read_versions("k"), state(ra), state(rb)))
    both(script)


def test_ordered_collection_single_acquirer():
    def script(ns, log):
        _, a, b = pair(ns, "ConsensusOrderedCollection", "q")
        qa, qb = a.get_channel("q"), b.get_channel("q")
        qa.add("job1")
        drain(a, b)
        log((qa.size(), qb.peek(), state(qa)))
        qa.acquire()
        qb.acquire()  # concurrent: only the first sequenced acquire wins
        a.flush()
        b.flush()
        drain(a, b)
        assert len(qa.acquired()) == 1 and len(qb.acquired()) == 0
        assert qa.size() == qb.size() == 0
        log((qa.acquired(), qb.acquired(), state(qa), state(qb)))
        item_id = next(iter(qa.acquired()))
        qa.release(item_id)
        drain(a, b)
        assert qa.size() == qb.size() == 1  # back at the front
        assert not qa.acquired()
        log((qa.size(), qb.peek(), state(qa), state(qb)))
    both(script)


def test_task_manager_queue_and_leave():
    def script(ns, log):
        _svc, a, b = pair(ns, "TaskManager", "t")
        ta, tb = a.get_channel("t"), b.get_channel("t")
        ta.volunteer("summarizer")
        drain(a, b)
        tb.volunteer("summarizer")
        drain(a, b)
        assert ta.assigned("summarizer") and not tb.assigned("summarizer")
        assert tb.queued("summarizer")
        log((ta.assigned_to("summarizer"), tb.assigned_to("summarizer"),
             state(ta)))
        a.connection.disconnect()
        drain(b)
        assert tb.assigned("summarizer")
        log((tb.assigned_to("summarizer"), tb.queued("summarizer")))
    both(script)


def test_pact_map_unanimous_consent():
    def script(ns, log):
        _svc, a, b = pair(ns, "PactMap", "p")
        pa, pb = a.get_channel("p"), b.get_channel("p")
        pa.set("mode", "strict")
        a.flush()
        a.process_incoming()
        assert pa.get("mode") is None and pa.get_pending("mode") == "strict"
        log((pa.get_pending("mode"), state(pa)))
        drain(a, b)
        assert pa.get("mode") == pb.get("mode") == "strict"
        log((pa.get("mode"), state(pa), state(pb)))
    both(script)


def test_pact_map_leave_counts_as_consent():
    def script(ns, log):
        _svc, a, b = pair(ns, "PactMap", "p")
        pa = a.get_channel("p")
        pa.set("mode", "loose")
        a.flush()
        a.process_incoming()
        assert pa.get("mode") is None
        log(state(pa))
        b.connection.disconnect()  # b never accepted; its departure consents
        drain(a)
        assert pa.get("mode") == "loose"
        log(state(pa))
    both(script)


def test_quorum_proposal_approval_via_msn():
    def script(ns, log):
        svc = ns.Svc()
        a = ns.RT(svc, "doc")
        b = ns.RT(svc, "doc")
        a.propose("code", "v2")
        drain(a, b)
        assert "code" not in a.approved_proposals
        log(dict(a.approved_proposals))
        a.send_noop()
        b.send_noop()
        drain(a, b)
        a.send_noop()
        b.send_noop()
        drain(a, b)
        assert a.approved_proposals.get("code") == "v2"
        assert b.approved_proposals.get("code") == "v2"
        log((dict(a.approved_proposals), dict(b.approved_proposals)))
    both(script)
