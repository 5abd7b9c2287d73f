"""Parity: the port's ``framework/`` layer (``fluid_static.py``,
``client.py``, ``data_object.py``, ``attributor.py``, ``agent_scheduler.py``,
``interceptions.py``, ``synthesize.py``, ``helpers.py``) against the
reference's.

Each case of tests/test_framework.py, tests/test_framework_packages.py and
tests/test_framework_helpers.py runs once per package (reference classes
over the reference's ``LocalFluidService``, port classes over the port's,
the port's entry points with ``device="cpu"``): the reference test's
assertions hold on both, and what the script observes (texts, maps,
summaries as JSON bytes, attributor entries, holders, audiences) must be
equal across the packages, bit for bit. The sequencer's clock (the
attributor's timestamps) is one fake clock per package, and the client's
document counter starts at 1 in both.
"""

import functools
import itertools
import json
import types as pytypes

import pytest

from fluidframework_tpu.drivers import local_driver as ref_local_driver
from fluidframework_tpu.framework import agent_scheduler as ref_sched
from fluidframework_tpu.framework import attributor as ref_attr
from fluidframework_tpu.framework import client as ref_client
from fluidframework_tpu.framework import data_object as ref_do
from fluidframework_tpu.framework import fluid_static as ref_fs
from fluidframework_tpu.framework import helpers as ref_helpers
from fluidframework_tpu.framework import interceptions as ref_icpt
from fluidframework_tpu.framework import synthesize as ref_synth
from fluidframework_tpu.framework import undo_redo as ref_undo
from fluidframework_tpu.models import shared_cell as ref_cell
from fluidframework_tpu.models import shared_counter as ref_counter
from fluidframework_tpu.models import shared_map as ref_map
from fluidframework_tpu.models import shared_string as ref_string
from fluidframework_tpu.protocol import types as ref_types
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu_torch.drivers import local_driver
from fluidframework_tpu_torch.framework import agent_scheduler as sched
from fluidframework_tpu_torch.framework import attributor as attr
from fluidframework_tpu_torch.framework import client
from fluidframework_tpu_torch.framework import data_object as do
from fluidframework_tpu_torch.framework import fluid_static as fs
from fluidframework_tpu_torch.framework import helpers
from fluidframework_tpu_torch.framework import interceptions as icpt
from fluidframework_tpu_torch.framework import synthesize as synth
from fluidframework_tpu_torch.framework import undo_redo
from fluidframework_tpu_torch.models import shared_cell as cell
from fluidframework_tpu_torch.models import shared_counter as counter
from fluidframework_tpu_torch.models import shared_map as smap
from fluidframework_tpu_torch.models import shared_string as sstring
from fluidframework_tpu_torch.protocol import types as port_types
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service import sequencer as port_sequencer
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from test_torch_consensus_ddses import both_over


def _ns(port: bool, **mods):
    ns = pytypes.SimpleNamespace(port=port, **mods)
    ns.kw = {"device": "cpu"} if port else {}
    # Channels built directly (not through a schema) get the CPU by name.
    ns.String = (functools.partial(ns.string.SharedString, device="cpu")
                 if port else ns.string.SharedString)
    ns.schema = ns.fs.ContainerSchema(
        initial_objects={"map": ns.map.SharedMap,
                         "text": ns.string.SharedString,
                         "count": ns.counter.SharedCounter},
        dynamic_object_types=(ns.cell.SharedCell,),
    )
    return ns


REF = _ns(False, RT=RefRT, Svc=RefSvc, local=ref_local_driver,
          client=ref_client, do=ref_do, fs=ref_fs, sched=ref_sched,
          attr=ref_attr, icpt=ref_icpt, synth=ref_synth, helpers=ref_helpers,
          undo=ref_undo, cell=ref_cell, counter=ref_counter, map=ref_map,
          string=ref_string, types=ref_types, sequencer=ref_sequencer)
PORT = _ns(True, RT=ContainerRuntime, Svc=LocalFluidService,
           local=local_driver, client=client, do=do, fs=fs, sched=sched,
           attr=attr, icpt=icpt, synth=synth, helpers=helpers,
           undo=undo_redo, cell=cell, counter=counter, map=smap,
           string=sstring, types=port_types, sequencer=port_sequencer)


class FakeClock:
    """``time.time`` from a counter, the same in both packages."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 0.25
        return self.t


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    for ns in (REF, PORT):
        monkeypatch.setattr(ns.sequencer, "time", FakeClock())
        monkeypatch.setattr(ns.client, "_doc_counter", itertools.count(1))


def both(script):
    both_over(script, REF, PORT)


def state(ch) -> str:
    return json.dumps(ch.summarize_core(), sort_keys=True)


# ---------------------------------------------------------------------------
# fluid-static + client (tests/test_framework.py)


def make_client(ns):
    return ns.client.TpuFluidClient(
        ns.client.TpuClientProps(ns.local.LocalDocumentServiceFactory()),
        **ns.kw)


def pump(*containers):
    for c in containers:
        c.runtime.flush()
    for c in containers:
        c.runtime.process_incoming()


def objects(c) -> tuple:
    o = c.initial_objects
    return (sorted(o), o["text"].get_text(), dict(o["map"].items()),
            o["count"].value, state(o["text"]), state(o["map"]))


def test_create_container_initial_objects():
    def script(ns, log):
        container, doc_id = make_client(ns).create_container(ns.schema)
        objs = container.initial_objects
        assert set(objs) == {"map", "text", "count"}
        objs["map"].set("k", 1)
        objs["text"].insert_text(0, "hi")
        pump(container)
        assert objs["map"].get("k") == 1
        assert objs["text"].get_text() == "hi"
        log((doc_id, objects(container)))
        if ns.port:
            assert objs["text"]._device.type == "cpu"
            assert container.device.type == "cpu"
    both(script)


def test_two_clients_collaborate_via_schema():
    def script(ns, log):
        client_ = make_client(ns)
        c1, doc_id = client_.create_container(ns.schema)
        c1.initial_objects["map"].set("who", "c1")
        c1.initial_objects["text"].insert_text(0, "hello")
        pump(c1)
        c2 = client_.get_container(doc_id, ns.schema)
        assert c2.initial_objects["map"].get("who") == "c1"
        assert c2.initial_objects["text"].get_text() == "hello"
        c2.initial_objects["text"].insert_text(5, " world")
        pump(c2, c1)
        assert c1.initial_objects["text"].get_text() == "hello world"
        assert set(c1.audience) == set(c2.audience)
        assert len(c1.audience) == 2
        log((doc_id, objects(c1), objects(c2), sorted(c1.audience),
             json.dumps(c2.audience, sort_keys=True)))
    both(script)


def test_dynamic_object_create_and_handle_roundtrip():
    def script(ns, log):
        c1, _ = make_client(ns).create_container(ns.schema)
        cell_ = c1.create(ns.cell.SharedCell)
        cell_.set("payload")
        c1.initial_objects["map"].set("cell", c1.handle_of(cell_))
        pump(c1)
        resolved = c1.resolve_handle(c1.initial_objects["map"].get("cell"))
        assert resolved is cell_
        result = c1.runtime.run_gc()
        assert f"/{cell_.id}" not in result.unreferenced
        log((cell_.id, c1.handle_of(cell_), sorted(result.unreferenced)))
    both(script)


def test_dynamic_object_unreferenced_is_gc_candidate():
    def script(ns, log):
        c1, _ = make_client(ns).create_container(ns.schema)
        cell_ = c1.create(ns.cell.SharedCell)
        cell_.set("orphan")
        pump(c1)
        result = c1.runtime.run_gc()
        assert f"/{cell_.id}" in result.unreferenced
        log(sorted(result.unreferenced))
    both(script)


def test_schema_mismatch_create_rejected():
    def script(ns, log):
        c1, _ = make_client(ns).create_container(ns.schema)
        with pytest.raises(AssertionError) as e:
            c1.create(ns.map.SharedMap)
        log(str(e.value))
    both(script)


def test_unknown_container_id_rejected():
    def script(ns, log):
        with pytest.raises(AssertionError) as e:
            make_client(ns).get_container("no-such-doc", ns.schema)
        log(str(e.value))
    both(script)


def test_dynamic_object_replicates_to_other_clients():
    def script(ns, log):
        client_ = make_client(ns)
        c1, doc_id = client_.create_container(ns.schema)
        cell_ = c1.create(ns.cell.SharedCell)
        cell_.set("shared-payload")
        c1.initial_objects["map"].set("cell", c1.handle_of(cell_))
        pump(c1)
        c2 = client_.get_container(doc_id, ns.schema)
        remote = c2.resolve_handle(c2.initial_objects["map"].get("cell"))
        assert remote.get() == "shared-payload"
        remote.set("updated")
        pump(c2, c1)
        assert cell_.get() == "updated"
        log((remote.id, state(cell_), state(remote), objects(c2)))
    both(script)


def test_dynamic_object_created_while_disconnected_replicates():
    def script(ns, log):
        client_ = make_client(ns)
        c1, doc_id = client_.create_container(ns.schema)
        pump(c1)
        c1.disconnect()
        cell_ = c1.create(ns.cell.SharedCell)
        cell_.set("offline-made")
        c1.initial_objects["map"].set("cell", c1.handle_of(cell_))
        c1.runtime.flush()
        c1.connect()
        pump(c1)
        c2 = client_.get_container(doc_id, ns.schema)
        remote = c2.resolve_handle(c2.initial_objects["map"].get("cell"))
        assert remote.get() == "offline-made"
        log((cell_.id, state(remote), objects(c2)))
    both(script)


def test_dynamic_object_survives_summary_load():
    def script(ns, log):
        client_ = make_client(ns)
        c1, doc_id = client_.create_container(ns.schema)
        cell_ = c1.create(ns.cell.SharedCell)
        cell_.set("persisted")
        c1.initial_objects["map"].set("cell", c1.handle_of(cell_))
        pump(c1)
        c1.runtime.submit_summary()
        pump(c1)
        c3 = client_.get_container(doc_id, ns.schema)
        assert c3.runtime.ref_seq >= c1.runtime.last_summary_seq > 0
        cell3 = c3.resolve_handle(c3.initial_objects["map"].get("cell"))
        assert cell3.get() == "persisted"
        log((c3.runtime.ref_seq, c1.runtime.last_summary_seq, state(cell3),
             objects(c3)))
    both(script)


def test_dynamic_string_is_built_on_the_container_device():
    """A schema type that takes ``device`` is built on the client's device,
    by the creator and by every loader (the registry carries it)."""
    def script(ns, log):
        schema = ns.fs.ContainerSchema(
            initial_objects={"map": ns.map.SharedMap},
            dynamic_object_types=(ns.string.SharedString,),
        )
        client_ = make_client(ns)
        c1, doc_id = client_.create_container(schema)
        text = c1.create(ns.string.SharedString)
        text.insert_text(0, "dynamic")
        c1.initial_objects["map"].set("t", c1.handle_of(text))
        pump(c1)
        c2 = client_.get_container(doc_id, schema)
        remote = c2.resolve_handle(c2.initial_objects["map"].get("t"))
        remote.insert_text(7, "!")
        pump(c2, c1)
        assert text.get_text() == remote.get_text() == "dynamic!"
        log((text.id, state(text), state(remote)))
        if ns.port:
            assert text._device.type == remote._device.type == "cpu"
            reg = ns.fs.schema_type_registry(schema, device="cpu")
            assert isinstance(reg["SharedString"], functools.partial)
            assert ns.fs.schema_type_registry(ns.schema, device="cpu") == \
                {"SharedCell": ns.cell.SharedCell}
    both(script)


def _counter_type(ns):
    class Counter(ns.do.DataObject):
        """Tiny aqueduct-style data object."""

        def initializing_first_time(self, props=None) -> None:
            self.root.set("value", props or 0)

        def initializing_from_existing(self) -> None:
            assert self.root.has("value")

        def increment(self) -> None:
            self.root.set("value", self.value + 1)

        @property
        def value(self) -> int:
            return self.root.get("value")

    return Counter


def _factory(ns):
    return ns.do.ContainerRuntimeFactoryWithDefaultDataStore(
        ns.do.DataObjectFactory("counter", _counter_type(ns)), **ns.kw)


def test_data_object_lifecycle_and_collab():
    def script(ns, log):
        service = ns.Svc()
        factory = _factory(ns)
        rt1, obj1 = factory.instantiate(service, "doc-a", existing=False,
                                        props=10)
        assert obj1.value == 10
        obj1.increment()
        rt1.flush()
        rt1.process_incoming()
        rt2, obj2 = factory.instantiate(service, "doc-a", existing=True)
        assert obj2.value == 11
        obj2.increment()
        rt2.flush()
        rt2.process_incoming()
        rt1.process_incoming()
        assert obj1.value == 12 and obj2.value == 12
        log((obj1.value, state(obj1.root), state(obj2.root)))
    both(script)


def test_dynamic_data_object_via_registry():
    def script(ns, log):
        service = ns.Svc()
        factory = _factory(ns)
        rt1, _obj1 = factory.instantiate(service, "doc-b", existing=False,
                                         props=0)
        extra = factory.create_data_object(rt1, "counter", "extra",
                                           props=100)
        extra.increment()
        rt1.flush()
        rt1.process_incoming()
        rt2, _ = factory.instantiate(service, "doc-b", existing=True)
        remote = factory.get_data_object(rt2, "extra")
        assert remote.value == 101
        log((remote.value, state(extra.root), state(remote.root)))
    both(script)


def _notes_type(ns):
    """A data object holding a SharedString; the port's takes ``device``
    and builds the string there."""
    if ns.port:
        class Notes(ns.do.DataObject):
            def __init__(self, ds_id, device="cuda"):
                super().__init__(ds_id)
                self.device = device
                self.create_channel(
                    ns.string.SharedString("notes", device=device))
    else:
        class Notes(ns.do.DataObject):
            def __init__(self, ds_id):
                super().__init__(ds_id)
                self.create_channel(ns.string.SharedString("notes"))

    def initializing_first_time(self, props=None) -> None:
        self.get_channel("notes").insert_text(0, props or "")

    Notes.initializing_first_time = initializing_first_time
    return Notes


def test_data_object_with_a_string_is_built_on_the_factory_device():
    """The runtime factory hands its device to a data object whose
    constructor takes one, locally and on every loader."""
    def script(ns, log):
        Notes = _notes_type(ns)
        factory = ns.do.ContainerRuntimeFactoryWithDefaultDataStore(
            ns.do.DataObjectFactory("notes", Notes), **ns.kw)
        service = ns.Svc()
        rt1, n1 = factory.instantiate(service, "d", existing=False,
                                      props="abc")
        rt2, n2 = factory.instantiate(service, "d", existing=True)
        n2.get_channel("notes").insert_text(3, "d")
        rt2.flush()
        for rt in (rt1, rt2, rt1):
            rt.process_incoming()
        texts = [n.get_channel("notes").get_text() for n in (n1, n2)]
        assert texts == ["abcd", "abcd"]
        log((texts, state(n1.get_channel("notes"))))
        if ns.port:
            assert n1.device.type == n2.device.type == "cpu"
    both(script)


# ---------------------------------------------------------------------------
# framework packages (tests/test_framework_packages.py)


def make_pair(ns, service, doc="doc", channels=()):
    outs = []
    for _ in range(2):
        rt = ns.RT(service, doc,
                   channels=tuple(ctor(cid) for ctor, cid in channels))
        outs.append((rt, [rt.channels[cid] for _, cid in channels]))
    for rt, _ in outs:
        rt.process_incoming()
    return outs


def pump_rts(*runtimes):
    for _ in range(4):
        for rt in runtimes:
            rt.process_incoming()


def test_map_undo_redo_roundtrip():
    def script(ns, log):
        (rt_a, [map_a]), (rt_b, [map_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.map.SharedMap, "m")])
        stacks = ns.undo.UndoRedoStackManager()
        ns.undo.SharedMapUndoRedoHandler(stacks).attach(map_a)
        map_a.set("k", 1)
        stacks.close_current_operation()
        map_a.set("k", 2)
        stacks.close_current_operation()
        pump_rts(rt_a, rt_b)
        assert map_b.get("k") == 2
        for step in ("undo", "undo", "redo", "redo"):
            assert getattr(stacks, f"{step}_operation")()
            pump_rts(rt_a, rt_b)
            log((step, dict(map_a.items()), dict(map_b.items()),
                 state(map_b)))
        assert map_a.get("k") == 2 and map_b.get("k") == 2
        assert not stacks.can_redo
    both(script)


def test_map_fresh_edit_clears_redo():
    def script(ns, log):
        (_rt_a, [map_a]), _ = make_pair(
            ns, ns.Svc(), channels=[(ns.map.SharedMap, "m")])
        stacks = ns.undo.UndoRedoStackManager()
        ns.undo.SharedMapUndoRedoHandler(stacks).attach(map_a)
        map_a.set("k", 1)
        stacks.close_current_operation()
        stacks.undo_operation()
        assert stacks.can_redo
        map_a.set("k", 9)
        stacks.close_current_operation()
        assert not stacks.can_redo
        log((stacks.can_undo, stacks.can_redo, dict(map_a.items())))
    both(script)


def test_operation_grouping_undoes_as_unit():
    def script(ns, log):
        (rt_a, [map_a]), (rt_b, [map_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.map.SharedMap, "m")])
        stacks = ns.undo.UndoRedoStackManager()
        ns.undo.SharedMapUndoRedoHandler(stacks).attach(map_a)
        map_a.set("x", 1)
        map_a.set("y", 2)
        stacks.close_current_operation()
        stacks.undo_operation()
        pump_rts(rt_a, rt_b)
        assert not map_a.has("x") and not map_a.has("y")
        assert not map_b.has("x") and not map_b.has("y")
        log((state(map_a), state(map_b)))
    both(script)


def test_map_delete_absent_key_emits_nothing():
    def script(ns, log):
        (rt_a, [map_a]), (rt_b, [map_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.map.SharedMap, "m")])
        events_a, events_b = [], []
        map_a.on("valueChanged", lambda ch, local: events_a.append(ch))
        map_b.on("valueChanged", lambda ch, local: events_b.append(ch))
        map_a.delete("ghost")
        pump_rts(rt_a, rt_b)
        assert events_a == [] and events_b == []
        log((events_a, events_b, state(map_b)))
    both(script)


def test_string_undo_insert_remove():
    def script(ns, log):
        (rt_a, [str_a]), (rt_b, [str_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.String, "s")])
        stacks = ns.undo.UndoRedoStackManager()
        ns.undo.SharedStringUndoRedoHandler(stacks).attach(str_a)
        str_a.insert_text(0, "hello world")
        stacks.close_current_operation()
        str_a.remove_range(5, 11)
        stacks.close_current_operation()
        pump_rts(rt_a, rt_b)
        assert str_a.get_text() == "hello"
        stacks.undo_operation()
        pump_rts(rt_a, rt_b)
        assert str_a.get_text() == str_b.get_text() == "hello world"
        log((str_a.get_text(), state(str_a), state(str_b)))
        stacks.undo_operation()
        pump_rts(rt_a, rt_b)
        assert str_a.get_text() == str_b.get_text() == " world"
        log((str_a.get_text(), state(str_a), state(str_b)))
    both(script)


def test_string_undo_insert_survives_concurrent_remote_edit():
    def script(ns, log):
        (rt_a, [str_a]), (rt_b, [str_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.String, "s")])
        stacks = ns.undo.UndoRedoStackManager()
        ns.undo.SharedStringUndoRedoHandler(stacks).attach(str_a)
        str_a.insert_text(0, "abc")
        stacks.close_current_operation()
        pump_rts(rt_a, rt_b)
        str_b.insert_text(1, "XY")
        pump_rts(rt_a, rt_b)
        assert str_a.get_text() == "aXYbc"
        stacks.undo_operation()
        pump_rts(rt_a, rt_b)
        assert str_a.get_text() == str_b.get_text() == "XY"
        log((state(str_a), state(str_b)))
    both(script)


def test_string_undo_annotate_restores_previous_runs():
    def script(ns, log):
        (rt_a, [str_a]), (rt_b, [str_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.String, "s")])
        stacks = ns.undo.UndoRedoStackManager()
        ns.undo.SharedStringUndoRedoHandler(stacks).attach(str_a)
        str_a.insert_text(0, "abcdef")
        stacks.close_current_operation()
        str_a.annotate(0, 3, 7)
        stacks.close_current_operation()
        str_a.annotate(1, 5, 9)
        stacks.close_current_operation()
        pump_rts(rt_a, rt_b)
        stacks.undo_operation()
        pump_rts(rt_a, rt_b)
        assert str_a.annotations() == str_b.annotations() == [(0, 3, 7)]
        log((state(str_a), state(str_b)))
    both(script)


def test_op_stream_attributor_records_and_serializes():
    def script(ns, log):
        (rt_a, [map_a]), (rt_b, [_map_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.map.SharedMap, "m")])
        attr_b = ns.attr.mixin_attributor(rt_b)
        map_a.set("k", 1)
        map_a.set("j", 2)
        pump_rts(rt_a, rt_b)
        entries = attr_b.entries()
        assert len(entries) == 2
        seqs = sorted(entries)
        client_id, ts = entries[seqs[0]]
        assert client_id == rt_a.client_id
        assert ts > 0
        assert attr_b.user_of(seqs[0]) == f"client-{rt_a.client_id}"
        blob = ns.attr.Attributor.deserialize(attr_b.serialize())
        assert blob.entries() == entries
        log((entries, attr_b.serialize(), attr_b.user_of(seqs[1])))
    both(script)


def test_agent_scheduler_first_claim_wins():
    def script(ns, log):
        (rt_a, [sch_a]), (rt_b, [sch_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.sched.AgentScheduler, "sch")])
        picked = []
        sch_a.on("picked", picked.append)
        sch_a.pick("leader")
        sch_b.pick("leader")
        pump_rts(rt_a, rt_b)
        assert sch_a.holder_of("leader") == rt_a.client_id
        assert sch_b.holder_of("leader") == rt_a.client_id
        assert picked == ["leader"]
        assert sch_a.picked_tasks() == {"leader"}
        assert sch_b.picked_tasks() == set()
        log((picked, state(sch_a), state(sch_b)))
    both(script)


def test_agent_scheduler_reelection_on_leave():
    def script(ns, log):
        (rt_a, [sch_a]), (rt_b, [sch_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.sched.AgentScheduler, "sch")])
        sch_a.pick("t")
        sch_b.pick("t")
        pump_rts(rt_a, rt_b)
        assert sch_b.holder_of("t") == rt_a.client_id
        rt_a.dispose() if hasattr(rt_a, "dispose") else rt_a.disconnect()
        pump_rts(rt_b)
        pump_rts(rt_b)
        assert sch_b.holder_of("t") == rt_b.client_id
        log((sch_b.holder_of("t"), state(sch_b)))
    both(script)


def test_agent_scheduler_release():
    def script(ns, log):
        (rt_a, [sch_a]), (rt_b, [sch_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.sched.AgentScheduler, "sch")])
        sch_a.pick("t")
        pump_rts(rt_a, rt_b)
        sch_b.pick("t")
        pump_rts(rt_a, rt_b)
        lost = []
        sch_a.on("lost", lost.append)
        sch_a.release("t")
        pump_rts(rt_a, rt_b)
        assert lost == ["t"]
        assert sch_a.holder_of("t") == rt_b.client_id
        assert sch_b.picked_tasks() == {"t"}
        log((lost, state(sch_a), state(sch_b)))
    both(script)


def test_dependency_container_resolve_and_scopes():
    def script(ns, log):
        parent = ns.synth.DependencyContainer()
        parent.register("logger", {"name": "root"})
        child = ns.synth.DependencyContainer(parent)
        child.register("config", lambda: {"flag": True})
        scope = child.synthesize(required=("logger", "config"),
                                 optional=("missing",))
        assert scope.logger["name"] == "root"
        assert scope.config["flag"] is True
        assert scope.missing is None
        assert "missing" in scope
        with pytest.raises(KeyError) as e:
            child.synthesize(required=("nope",))
        with pytest.raises(AttributeError):
            _ = scope.never_requested
        assert child.resolve("config") is scope.config
        log((scope.logger, scope.config, str(e.value), child.has("logger"),
             parent.has("config")))
    both(script)


def test_map_interception_stamps_props():
    def script(ns, log):
        (rt_a, [map_a]), (rt_b, [map_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.map.SharedMap, "m")])
        seen = []
        rt_b.on_op = lambda msg: (
            seen.append(msg.contents)
            if msg.type == ns.types.MessageType.OPERATION else None)
        ns.icpt.create_shared_map_with_interception(
            map_a, lambda contents: {"user": "alice"})
        map_a.set("k", 1)
        pump_rts(rt_a, rt_b)
        assert map_b.get("k") == 1
        [op] = seen
        assert op["contents"]["props"] == {"user": "alice"}
        log(json.dumps(op, sort_keys=True))
    both(script)


def test_string_interception_and_merge_unaffected():
    def script(ns, log):
        (rt_a, [str_a]), (rt_b, [str_b]) = make_pair(
            ns, ns.Svc(), channels=[(ns.String, "s")])
        ns.icpt.create_shared_string_with_interception(
            str_a, lambda contents: ({"by": "bob"}
                                     if contents.get("k") == "ins" else {}))
        str_a.insert_text(0, "hi")
        str_a.annotate(0, 2, 3)
        pump_rts(rt_a, rt_b)
        assert str_b.get_text() == "hi"
        assert str_b.annotations() == [(0, 2, 3)]
        log((state(str_a), state(str_b)))
    both(script)


# ---------------------------------------------------------------------------
# helper packages (tests/test_framework_helpers.py)


def drain(rts):
    for rt in rts:
        rt.flush()
    busy = True
    while busy:
        busy = any(rt.process_incoming() for rt in rts)


def test_request_handler_routes():
    def script(ns, log):
        rt = ns.RT(ns.Svc(), "d", channels=(ns.String("text"),))
        seen = []

        def custom(parts, runtime):
            if parts[:1] == ["_custom"]:
                seen.append(parts)
                return {"custom": parts[1:]}
            return None

        handle = ns.helpers.build_runtime_request_handler(
            custom, ns.helpers.channel_request_handler)
        assert handle("/text", rt) is rt.get_channel("text")
        assert handle("/_custom/a/b", rt) == {"custom": ["a", "b"]}
        with pytest.raises(KeyError) as e:
            handle("/missing", rt)
        log((seen, str(e.value)))
    both(script)


def test_oldest_client_observer_tracks_quorum():
    def script(ns, log):
        svc = ns.Svc()
        a = ns.RT(svc, "d", channels=(ns.map.SharedMap("m"),))
        b = ns.RT(svc, "d", channels=(ns.map.SharedMap("m"),))
        drain([a, b])
        oa = ns.helpers.OldestClientObserver(a)
        ob = ns.helpers.OldestClientObserver(b)
        assert oa.is_oldest and not ob.is_oldest
        events = []
        ob.on_change(events.append)
        a.disconnect()
        drain([b])
        assert ob.is_oldest
        assert events == [True]
        log((events, sorted(b.quorum_members)))
    both(script)


def test_view_adapter_rerenders_on_ops():
    def script(ns, log):
        svc = ns.Svc()
        a = ns.RT(svc, "d", channels=(ns.String("text"),))
        b = ns.RT(svc, "d", channels=(ns.String("text"),))
        views = []
        adapter = ns.helpers.ViewAdapter(b, "text", lambda s: s.get_text())
        adapter.subscribe(views.append)
        a.get_channel("text").insert_text(0, "hi")
        drain([a, b])
        assert views[0] == "" and views[-1] == "hi"
        log(views)
    both(script)


def test_web_code_loader_resolves_quorum_proposal():
    def script(ns, log):
        svc = ns.Svc()
        a = ns.RT(svc, "d", channels=(ns.map.SharedMap("m"),))
        b = ns.RT(svc, "d", channels=(ns.map.SharedMap("m"),))
        drain([a, b])
        loader = ns.helpers.WebCodeLoader()
        loader.register("my-app@1.0", {"factory": "v1"})
        with pytest.raises(KeyError) as e:
            loader.resolve(a)
        loader.propose_code(a, "my-app@1.0")
        drain([a, b])
        a.send_noop()
        b.send_noop()
        drain([a, b])
        assert loader.resolve(b) == {"factory": "v1"}
        log((str(e.value), b.approved_proposals))
    both(script)


def test_location_redirection_follows_moves():
    def script(ns, log):
        r = ns.helpers.LocationRedirectionResolver(ns.local.resolve_url)
        r.add_redirect("fluid-test://old/doc1", "fluid-test://new/doc1-moved")
        assert r.resolve("fluid-test://old/doc1") == "doc1-moved"
        assert r.resolve("fluid-test://host/plain") == "plain"
        r.add_redirect("fluid-test://a/x", "fluid-test://b/x")
        r.add_redirect("fluid-test://b/x", "fluid-test://a/x")
        with pytest.raises(RuntimeError) as e:
            r.resolve("fluid-test://a/x")
        log((r.resolve("fluid-test://old/doc1"), str(e.value)))
    both(script)
