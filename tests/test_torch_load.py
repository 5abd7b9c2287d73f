"""Parity: the port's ``testing/load.py`` ``LoadRunner`` against the
reference's, each over its own package's services.

Each scenario of tests/test_load.py runs once per package with the same
profile and seed: the reference's runner over the reference's service,
the port's (``device="cpu"``: every replica's ``SharedString`` and
``SharedTree`` on K1/K2's and the tree scans' plain versions) over the
port's. The two reports must be equal in every field but the wall time:
convergence, op, fault, chaos, reconnect, nack, summary and GC counts,
every replica's text, annotations and tree, and the tree-ingest buckets.
The reference test's own assertions then run on the port's report.

Both packages draw the same tokens and stamps: ``uuid`` in the pipeline
modules comes from one counter per service and the sequencers read one
fake clock (the pipeline's device feed deadline is 0 and its overload
lag reference infinite, so no wall clock decides a boxcar or a nack).
The sockets scenario is not mirrored: it is flaky in the reference. The
service-chaos scenarios are in tests/test_torch_load_chaos.py.
"""

import dataclasses
import types as pytypes

import pytest

import test_torch_pipeline as TP
from fluidframework_tpu.models.shared_string import SharedString as RefString
from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service import admission as ref_admission
from fluidframework_tpu.service import local_server as ref_local
from fluidframework_tpu.service import pipeline as ref_pipeline
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.testing import faults as ref_faults
from fluidframework_tpu.testing import load as ref_load
from fluidframework_tpu_torch.models.shared_string import (
    SharedString as PortString,
)
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.runtime.container import (
    ContainerRuntime as PortRT,
)
from fluidframework_tpu_torch.service import admission as port_admission
from fluidframework_tpu_torch.service import local_server as port_local
from fluidframework_tpu_torch.service import pipeline as port_pipeline
from fluidframework_tpu_torch.service import sequencer as port_sequencer
from fluidframework_tpu_torch.testing import faults as port_faults
from fluidframework_tpu_torch.testing import load as port_load

SIDES = {
    "ref": dict(load=ref_load, local=ref_local, pipeline=ref_pipeline,
                sequencer=ref_sequencer, admission=ref_admission,
                faults=ref_faults, rt=RefRT, string=RefString,
                types=ref_types, runner={}),
    "port": dict(load=port_load, local=port_local, pipeline=port_pipeline,
                 sequencer=port_sequencer, admission=port_admission,
                 faults=port_faults, rt=PortRT,
                 string=lambda cid: PortString(cid, device="cpu"),
                 types=port_types, runner={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_fault_registries():
    for side in SIDES.values():
        side["faults"].REGISTRY.reset()
    yield
    for side in SIDES.values():
        side["faults"].REGISTRY.reset()


def _patch(m, monkeypatch):
    clock = TP.FakeClock()
    monkeypatch.setattr(m["pipeline"], "uuid", TP.FakeUuid())
    monkeypatch.setattr(m["sequencer"], "time",
                        pytypes.SimpleNamespace(time=clock))


def local(m, monkeypatch):
    _patch(m, monkeypatch)
    return m["local"].LocalFluidService()


def pipeline(n_partitions):
    def make(m, monkeypatch):
        _patch(m, monkeypatch)
        kw = dict(n_partitions=n_partitions, device_feed_deadline_ms=0.0,
                  overload=m["admission"].OverloadController(
                      lag_ref_ms=float("inf")))
        if m is SIDES["port"]:
            kw["device_torch"] = "cpu"
        return m["pipeline"].PipelineFluidService(**kw)
    return make


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    for k in ("elapsed_s", "journal_dump"):
        d.pop(k)
    return d


def run_both(monkeypatch, make_service, profile):
    """The profile through each package's runner over its own service;
    the reports must agree. Returns the port's report."""
    out = {}
    for side, m in SIDES.items():
        svc = make_service(m, monkeypatch)
        prof = m["load"].LoadProfile(**dataclasses.asdict(profile))
        out[side] = m["load"].LoadRunner(svc, prof, **m["runner"]).run()
    TP._eq(_fields(out["ref"]), _fields(out["port"]), "report")
    return out["port"]


def test_profiles_are_the_reference_profiles():
    for name in ("CHAOS_SMOKE_PROFILE", "CHAOS_STRESS_PROFILE",
                 "CHAOS_REFERENCE_PROFILE", "CHAOS_STRESS_FULL_PROFILE"):
        assert dataclasses.asdict(getattr(port_load, name)) == \
            dataclasses.asdict(getattr(ref_load, name)), name
    assert dataclasses.asdict(port_load.LoadProfile()) == \
        dataclasses.asdict(ref_load.LoadProfile())
    assert [f.name for f in dataclasses.fields(port_load.LoadReport)] == \
        [f.name for f in dataclasses.fields(ref_load.LoadReport)]


def test_runner_defaults_to_the_card_and_raises_without_it(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_load.LoadRunner(None, port_load.LoadProfile())
    assert port_load.LoadRunner(
        None, port_load.LoadProfile(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("seed", range(3))
def test_load_local_with_faults(seed, monkeypatch):
    profile = port_load.LoadProfile(
        n_clients=6, total_ops=400, seed=seed, fault_rate=0.02,
        offline_ops=25,
    )
    report = run_both(monkeypatch, local, profile)
    assert report.converged, f"divergence: {report}"
    assert report.ops_submitted == 400
    assert report.faults_injected > 0, "profile expected faults to fire"
    assert report.reconnects == report.faults_injected


def test_load_pipeline_service(monkeypatch):
    profile = port_load.LoadProfile(
        n_clients=4, total_ops=200, seed=7, fault_rate=0.015,
        offline_ops=15, doc_id="pipe-load",
    )
    report = run_both(monkeypatch, pipeline(2), profile)
    assert report.converged, f"divergence: {report}"


def test_load_with_move_bearing_tree_client(monkeypatch):
    profile = port_load.LoadProfile(
        n_clients=4, total_ops=220, seed=5, fault_rate=0.01,
        offline_ops=15, tree_weight=0.3, doc_id="tree-load",
    )
    report = run_both(monkeypatch, local, profile)
    assert report.converged, f"divergence: {report}"
    assert report.tree_ops_submitted > 0
    assert report.tree_moves_submitted > 0, "profile expected tree moves"


@pytest.mark.slow
def test_load_16_clients_2k_ops_with_moves(monkeypatch):
    profile = port_load.LoadProfile(
        n_clients=16, total_ops=2000, seed=11, fault_rate=0.004,
        offline_ops=40, tree_weight=0.25, doc_id="stress-moves",
    )
    report = run_both(monkeypatch, local, profile)
    assert report.converged, f"divergence: {report}"
    assert report.ops_submitted == 2000
    assert report.tree_moves_submitted >= 20
    assert report.faults_injected > 0
    assert report.reconnects == report.faults_injected


def test_slot_recycling_under_reconnect_churn(monkeypatch):
    """Reconnect churn far beyond MAX_WRITERS must not exhaust a
    document, on either package; the anchor's texts agree."""
    texts = {}
    for side, m in SIDES.items():
        svc = local(m, monkeypatch)
        anchor = m["rt"](svc, "churn", channels=(m["string"]("t"),))
        rt = m["rt"](svc, "churn", channels=(m["string"]("t"),))
        for _ in range(60):  # far beyond the 31-slot bitmask width
            rt.get_channel("t").insert_text(0, "x")
            rt.flush()
            rt.process_incoming()
            anchor.process_incoming()
            anchor.send_noop()  # keeps the floor advancing past leaves
            anchor.process_incoming()
            rt.disconnect()
            rt.reconnect()
        rt.get_channel("t").insert_text(0, "done-")
        rt.flush()
        rt.process_incoming()
        anchor.process_incoming()
        texts[side] = anchor.get_channel("t").get_text()
    assert texts["port"] == texts["ref"]
    assert texts["port"].startswith("done-")
    assert len(texts["port"]) == 65


def test_idle_client_expiry_severs_and_unpins(monkeypatch):
    """A client that vanishes without leave is expired by the service so
    the MSN can advance; both packages' sequencers read one fake clock,
    which the script moves, and agree on every step."""
    seen = {}
    for side, m in SIDES.items():
        clock = TP.FakeClock()
        monkeypatch.setattr(m["sequencer"], "time",
                            pytypes.SimpleNamespace(time=clock))
        t = m["types"]
        svc = m["local"].LocalFluidService()
        conn_a = svc.connect("doc")
        conn_b = svc.connect("doc")
        seq = svc.docs["doc"].sequencer
        conn_a.submit(t.DocumentMessage(
            1, conn_a.take_inbox()[-1].sequence_number,
            t.MessageType.OPERATION, contents=None))
        inside = svc.expire_idle(timeout_s=3600)
        clock.t += 0.3
        conn_a.submit(t.DocumentMessage(2, seq.seq, t.MessageType.OPERATION,
                                        contents=None))
        evicted = svc.expire_idle(timeout_s=0.2)
        with pytest.raises(ConnectionError):
            conn_b.submit(t.DocumentMessage(1, seq.seq,
                                            t.MessageType.OPERATION,
                                            contents=None))
        before = seq.min_seq
        conn_a.submit(t.DocumentMessage(3, seq.seq, t.MessageType.OPERATION,
                                        contents=None))
        seen[side] = (inside, evicted, conn_b.evicted, before, seq.min_seq,
                      conn_b.client_id in seq.clients, seq.seq)
    assert seen["port"] == seen["ref"]
    inside, evicted, b_evicted, before, after, b_in, _ = seen["port"]
    assert inside == 0 and evicted == 1 and b_evicted
    assert after >= before and not b_in
