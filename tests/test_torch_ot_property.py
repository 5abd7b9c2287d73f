"""Parity: the port's ``models/ot_json.py`` (``SharedOTJson``, ``transform``,
``apply_op``) and ``models/property_dds.py`` (``SharedPropertyTree`` and
its changeset algebra: ``squash``, ``rebase``, ``apply_changeset``)
against the reference's.

The OT json and PropertyDDS cases of tests/test_dds_families.py, with
their seeds, run once per package over that package's
``ContainerRuntime`` and ``LocalFluidService``: the reference test's
assertions hold on both, and what each script records (the documents'
data, property values, summaries as JSON bytes, the algebra's results)
must be equal across the packages.
"""

import copy
import json
import types as pytypes

import numpy as np
import pytest

from fluidframework_tpu.models import ot_json as ref_ot
from fluidframework_tpu.models import property_dds as ref_prop
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu_torch.models import ot_json as ot
from fluidframework_tpu_torch.models import property_dds as prop
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from test_torch_consensus_ddses import both_over

REF = pytypes.SimpleNamespace(RT=RefRT, Svc=RefSvc, ot=ref_ot, prop=ref_prop)
PORT = pytypes.SimpleNamespace(RT=ContainerRuntime, Svc=LocalFluidService,
                               ot=ot, prop=prop)


def setup(ns, channel_factory, n=2, doc="fam-doc"):
    svc = ns.Svc()
    rts = [ns.RT(svc, doc, channels=(channel_factory(),)) for _ in range(n)]
    return svc, rts


def drain(rts):
    for rt in rts:
        rt.flush()
    busy = True
    while busy:
        busy = any(rt.process_incoming() for rt in rts)


def state(ch) -> str:
    return json.dumps(ch.summarize_core(), sort_keys=True, default=repr)


def both(script):
    both_over(script, REF, PORT)


# -- OT json ----------------------------------------------------------------------


def test_ot_transform_list_indices():
    def script(ns, log):
        transform = ns.ot.transform
        op = {"p": [5], "li": "x"}
        assert transform(op, {"p": [2], "li": "y"})["p"] == [6]
        assert transform(op, {"p": [2], "ld": 1})["p"] == [4]
        assert transform({"p": [2], "ld": 1}, {"p": [2], "ld": 1}) is None
        assert transform({"p": ["a", "b"], "oi": 1},
                         {"p": ["a"], "od": 1}) is None
        for a, b in [({"p": [5], "li": "x"}, {"p": [5], "li": "y"}),
                     ({"p": [1, 0], "oi": 2}, {"p": [0], "li": 9}),
                     ({"p": ["n"], "na": 3}, {"p": ["n"], "na": 4}),
                     ({"p": [3], "ld": 1}, {"p": [1], "ld": 1})]:
            log((transform(a, b), transform(b, a)))
        doc = {"items": [1, 2], "n": 1, "cfg": {"x": 1}}
        for o in ({"p": ["items", 1], "li": 7}, {"p": ["n"], "na": 4},
                  {"p": ["cfg", "x"], "od": 1}, {"p": ["k"], "oi": 3}):
            doc = ns.ot.apply_op(copy.deepcopy(doc), o)
            log(copy.deepcopy(doc))
    both(script)


def test_ot_json_concurrent_lists_converge():
    def script(ns, log):
        _svc, (a, b) = setup(
            ns, lambda: ns.ot.SharedOTJson("j", initial={"items": []}))
        ja, jb = a.get_channel("j"), b.get_channel("j")
        ja.list_insert(["items"], 0, "from-a")
        jb.list_insert(["items"], 0, "from-b")
        drain([a, b])
        assert ja.as_data() == jb.as_data()
        assert set(ja.get("items")) == {"from-a", "from-b"}
        log((ja.as_data(), state(ja), state(jb)))
        ja.list_delete(["items"], 0)
        jb.list_insert(["items"], 2, "tail")
        drain([a, b])
        assert ja.as_data() == jb.as_data()
        assert len(ja.get("items")) == 2
        log((ja.as_data(), state(ja), state(jb)))
    both(script)


def test_ot_json_number_add_commutes():
    def script(ns, log):
        _svc, (a, b) = setup(
            ns, lambda: ns.ot.SharedOTJson("j", initial={"n": 0}))
        ja, jb = a.get_channel("j"), b.get_channel("j")
        ja.number_add(["n"], 5)
        jb.number_add(["n"], 7)
        drain([a, b])
        assert ja.get("n") == jb.get("n") == 12
        log((ja.as_data(), state(ja)))
    both(script)


def test_ot_json_delete_vs_nested_edit():
    def script(ns, log):
        _svc, (a, b) = setup(
            ns, lambda: ns.ot.SharedOTJson("j", initial={"cfg": {"x": 1}}))
        ja, jb = a.get_channel("j"), b.get_channel("j")
        ja.delete_key(["cfg"])
        jb.set_key(["cfg", "x"], 99)
        drain([a, b])
        assert ja.as_data() == jb.as_data()
        assert ja.get("cfg") is None
        log((ja.as_data(), state(ja), state(jb)))
    both(script)


def test_ot_bridges_over_already_acked_ops():
    def script(ns, log):
        _svc, (a, b) = setup(ns, lambda: ns.ot.SharedOTJson(
            "j", initial={"items": ["a", "b", "c", "d", "e"]}))
        ja, jb = a.get_channel("j"), b.get_channel("j")
        ja.list_insert(["items"], 0, "X")
        jb.list_insert(["items"], 5, "Y")
        a.flush()
        a.process_incoming()
        log(ja.as_data())
        drain([a, b])
        assert ja.as_data() == jb.as_data()
        assert ja.get("items") == ["X", "a", "b", "c", "d", "e", "Y"]
        log((ja.as_data(), state(ja), state(jb)))
    both(script)


def test_ot_progressive_transform_across_batches():
    def script(ns, log):
        _svc, (a, b) = setup(ns, lambda: ns.ot.SharedOTJson(
            "j", initial={"items": ["a", "b"]}))
        ja, jb = a.get_channel("j"), b.get_channel("j")
        jb.list_delete(["items"], 0)
        b.flush()
        ja.list_delete(["items"], 0)
        ja.list_insert(["items"], 1, "x")
        drain([a, b])
        assert ja.as_data() == jb.as_data()
        assert ja.get("items") == ["b", "x"]
        log((ja.as_data(), state(ja), state(jb)))
    both(script)


@pytest.mark.parametrize("seed", range(4))
def test_ot_json_fuzz_convergence(seed):
    def script(ns, log):
        rng = np.random.default_rng(seed)
        _svc, rts = setup(ns, lambda: ns.ot.SharedOTJson(
            "j", initial={"items": list("abcd"), "n": 0}), n=3)
        docs = [rt.get_channel("j") for rt in rts]
        for step in range(100):
            i = int(rng.integers(0, 3))
            d = docs[i]
            items = d.get("items")
            roll = rng.random()
            if roll < 0.45:
                d.list_insert(["items"],
                              int(rng.integers(0, len(items) + 1)),
                              f"s{step}")
            elif roll < 0.7 and items:
                d.list_delete(["items"], int(rng.integers(0, len(items))))
            elif roll < 0.85:
                d.number_add(["n"], int(rng.integers(1, 5)))
            else:
                d.set_key([f"k{int(rng.integers(0, 4))}"], step)
            if step % 3 == 0:
                rts[i].flush()
            if step % 5 == 0:
                for rt in rts:
                    rt.process_incoming()
                log([doc.as_data() for doc in docs])
        drain(rts)
        datas = [d.as_data() for d in docs]
        assert datas[0] == datas[1] == datas[2]
        log((datas, [state(d) for d in docs]))
    both(script)


# -- PropertyDDS --------------------------------------------------------------------


def test_property_changeset_algebra():
    def script(ns, log):
        p = ns.prop
        a = {"insert": {"p.x": ("Int32", 1)}, "modify": {}, "remove": []}
        b = {"insert": {}, "modify": {"p.x": 2}, "remove": []}
        sq = p.squash(a, b)
        doc = {}
        p.apply_changeset(doc, sq)
        assert doc["p.x"] == ("Int32", 2)
        c = {"insert": {}, "modify": {}, "remove": ["p.x"]}
        d1, d2 = {}, {}
        p.apply_changeset(d1, p.squash(p.squash(a, b), c))
        p.apply_changeset(d2, p.squash(a, p.squash(b, c)))
        assert d1 == d2
        r = p.rebase(b, c)
        assert not r["modify"]
        log((sq, doc, d1, r, p.empty_changeset(), p.rebase(a, c),
             p.squash(c, a)))
    both(script)


def test_property_tree_commit_and_convergence():
    def script(ns, log):
        _svc, (a, b) = setup(ns, lambda: ns.prop.SharedPropertyTree("p"))
        pa, pb = a.get_channel("p"), b.get_channel("p")
        pa.insert_property("car.speed", "Int32", 60)
        pa.insert_property("car.name", "String", "zippy")
        pa.commit()
        drain([a, b])
        assert pb.get("car.speed") == 60
        with pytest.raises(TypeError):
            pb.set_value("car.speed", "fast")
        log((state(pa), state(pb)))
        pb.remove_property("car.speed")
        pb.commit()
        b.flush()
        pa.set_value("car.speed", 80)
        pa.commit()
        drain([a, b])
        assert pa.get("car.speed") == pb.get("car.speed") is None
        assert pa.get("car.name") == "zippy"
        log((state(pa), state(pb)))
    both(script)


def test_property_tree_summary_roundtrip():
    def script(ns, log):
        svc, (a,) = setup(ns, lambda: ns.prop.SharedPropertyTree("p"), n=1)
        pa = a.get_channel("p")
        pa.insert_property("cfg.flag", "Bool", True)
        pa.commit()
        drain([a])
        a.submit_summary()
        drain([a])
        late = ns.RT(svc, "fam-doc",
                     channels=(ns.prop.SharedPropertyTree("p"),))
        drain([a, late])
        assert late.get_channel("p").get("cfg.flag") is True
        log((state(pa), state(late.get_channel("p"))))
    both(script)


def test_property_remove_preexisting_with_staged_child_insert():
    def script(ns, log):
        _svc, (a, b) = setup(ns, lambda: ns.prop.SharedPropertyTree("p"))
        pa, pb = a.get_channel("p"), b.get_channel("p")
        pa.insert_property("a", "Int32", 1)
        pa.commit()
        drain([a, b])
        pa.insert_property("a.b", "Int32", 2)
        pa.remove_property("a")
        pa.commit()
        drain([a, b])
        assert pb.get("a") is None and pa.get("a") is None
        assert pb.get("a.b") is None
        log((state(pa), state(pb)))
    both(script)


def test_property_array_ot_converges():
    def script(ns, log):
        _svc, (a, b) = setup(ns, lambda: ns.prop.SharedPropertyTree("p"))
        pa, pb = a.get_channel("p"), b.get_channel("p")
        pa.insert_array_property("tags", ["x", "y", "z"])
        pa.commit()
        drain([a, b])
        assert pb.get("tags") == ["x", "y", "z"]
        pa.array_insert("tags", 0, ["a0"])
        pa.commit()
        a.flush()
        pb.array_remove("tags", 1)
        pb.commit()
        drain([a, b])
        assert pa.get("tags") == pb.get("tags") == ["a0", "x", "z"]
        log((state(pa), state(pb)))
        pa.array_remove("tags", 1)
        pa.commit()
        a.flush()
        pb.array_remove("tags", 1)
        pb.commit()
        drain([a, b])
        assert pa.get("tags") == pb.get("tags") == ["a0", "z"]
        log((state(pa), state(pb)))
    both(script)


@pytest.mark.parametrize("seed", range(3))
def test_property_array_fuzz(seed):
    def script(ns, log):
        rng = np.random.default_rng(seed)
        _svc, rts = setup(ns, lambda: ns.prop.SharedPropertyTree("p"), n=3)
        docs = [rt.get_channel("p") for rt in rts]
        docs[0].insert_array_property("arr", [0, 1, 2, 3])
        docs[0].commit()
        drain(rts)
        for step in range(80):
            i = int(rng.integers(0, 3))
            d = docs[i]
            arr = d.get("arr") or []
            if arr and rng.random() < 0.4:
                d.array_remove("arr", int(rng.integers(0, len(arr))))
            else:
                d.array_insert("arr", int(rng.integers(0, len(arr) + 1)),
                               [100 + step])
            d.commit()
            if step % 3 == 0:
                rts[i].flush()
            if step % 5 == 0:
                for rt in rts:
                    rt.process_incoming()
                log([doc.get("arr") for doc in docs])
        drain(rts)
        vals = [d.get("arr") for d in docs]
        assert vals[0] == vals[1] == vals[2]
        log((vals, [state(d) for d in docs]))
    both(script)


def test_squash_remove_reinsert_keeps_array_ops():
    def script(ns, log):
        p = ns.prop
        a = {"insert": {"p": ("Array", [1, 2, 3])}, "modify": {},
             "remove": [], "arrays": {}}
        b = {"insert": {"p": ("Array", [])}, "modify": {}, "remove": ["p"],
             "arrays": {"p": [{"i": 0, "ins": [9]}]}}
        d1, d2 = {}, {}
        sq = p.squash(a, b)
        p.apply_changeset(d1, sq)
        p.apply_changeset(d2, a)
        p.apply_changeset(d2, b)
        assert d1 == d2 == {"p": ("Array", [9])}
        log((sq, d1))
    both(script)
