"""Parity: the port's hierarchy trees (``tree/hierarchy.py``,
``tree/hierarchical_tree.py``, ``tree/legacy_tree.py``, ``tree/chunked.py``)
against the reference's.

Each case of tests/test_hierarchical_tree.py, and the four legacy-tree
cases of tests/test_dds_families.py, runs once per package over that
package's ``ContainerRuntime`` and ``LocalFluidService``: the reference
test's assertions hold on both, and what the script observes (tree data,
schemas, edit logs, summaries as JSON bytes, chunk columns) must be equal
across the packages. ``UniformChunk.to_device(..., device="cpu")`` must
give the dtype and the bytes of the reference's ``jnp.asarray`` (64-bit
types narrowed to 32 bits, as JAX does with x64 off); a column that is
not numeric raises ``TypeError`` in both.
"""

import json
import types as pytypes

import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.framework import attributor as ref_attr
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu.tree import chunked as ref_chunked
from fluidframework_tpu.tree import hierarchical_tree as ref_ht
from fluidframework_tpu.tree import hierarchy as ref_hier
from fluidframework_tpu.tree import legacy_tree as ref_legacy
from fluidframework_tpu_torch.framework import attributor
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from fluidframework_tpu_torch.tree import chunked
from fluidframework_tpu_torch.tree import hierarchical_tree as ht
from fluidframework_tpu_torch.tree import hierarchy
from fluidframework_tpu_torch.tree import legacy_tree
from test_torch_consensus_ddses import both_over

REF = pytypes.SimpleNamespace(
    port=False, RT=RefRT, Svc=RefSvc, ht=ref_ht, hier=ref_hier,
    legacy=ref_legacy, chunked=ref_chunked, attr=ref_attr,
)
PORT = pytypes.SimpleNamespace(
    port=True, RT=ContainerRuntime, Svc=LocalFluidService, ht=ht,
    hier=hierarchy, legacy=legacy_tree, chunked=chunked, attr=attributor,
)


def both(script):
    both_over(script, REF, PORT)


def setup(ns, n=2, doc="tree-doc", make=None):
    svc = ns.Svc()
    make = make or (lambda: ns.ht.HierarchicalTree("tree"))
    return svc, [ns.RT(svc, doc, channels=(make(),)) for _ in range(n)]


def drain(rts):
    for rt in rts:
        rt.flush()
    busy = True
    while busy:
        busy = any(rt.process_incoming() for rt in rts)


def tree_of(rt):
    return rt.get_channel("tree")


def state(ch) -> str:
    return json.dumps(ch.summarize_core(), sort_keys=True)


def views(*trees) -> tuple:
    return tuple(json.dumps(t.root.as_data(), sort_keys=True) for t in trees)


# ---------------------------------------------------------------------------
# HierarchicalTree (tests/test_hierarchical_tree.py)


def test_basic_tree_editing_and_convergence():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        (todo,) = ta.root["lists"].append({"type": "list", "value": "todo"})
        todo["items"].append({"type": "item", "value": "buy milk"},
                             {"type": "item", "value": "write tests"})
        drain([a, b])
        assert tb.root.as_data() == ta.root.as_data()
        items = tb.root["lists"][0]["items"]
        assert [i.value for i in items] == ["buy milk", "write tests"]
        log((views(ta, tb), state(ta), state(tb)))
    both(script)


def test_concurrent_inserts_converge_with_tie_order():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        ta.root["kids"].append({"type": "n", "value": "base"})
        drain([a, b])
        ta.root["kids"].insert(0, {"type": "n", "value": "from-a"})
        tb.root["kids"].insert(0, {"type": "n", "value": "from-b"})
        log(views(ta, tb))
        drain([a, b])
        va = [n.value for n in ta.root["kids"]]
        assert va == [n.value for n in tb.root["kids"]]
        assert set(va) == {"from-a", "from-b", "base"}
        assert va[-1] == "base"
        log((va, state(ta)))
    both(script)


def test_concurrent_value_sets_lww():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        ta.root["f"].append({"type": "n", "value": 0})
        drain([a, b])
        ta.root["f"][0].value = "from-a"
        tb.root["f"][0].value = "from-b"
        drain([a, b])
        assert ta.root["f"][0].value == tb.root["f"][0].value == "from-b"
        log((views(ta, tb), state(tb)))
    both(script)


def test_delete_vs_concurrent_edit():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        (n,) = ta.root["f"].append({"type": "n", "value": 1})
        drain([a, b])
        ta.delete_node(n.node_id)
        tb.set_value(n.node_id, 99)
        drain([a, b])
        assert ta.root.as_data() == tb.root.as_data()
        assert len(ta.root["f"]) == 0
        log((views(ta, tb), state(ta)))
    both(script)


def test_moves_and_concurrent_move_cycle_guard():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        (x,) = ta.root["f"].append({"type": "n", "value": "x"})
        (y,) = ta.root["f"].append({"type": "n", "value": "y"})
        drain([a, b])
        ta.move_node(x.node_id, y.node_id, "kids", 0)
        tb.move_node(y.node_id, x.node_id, "kids", 0)
        drain([a, b])
        assert ta.root.as_data() == tb.root.as_data()
        top = ta.root.as_data().get("fields", {}).get("f", [])
        assert len(top) == 1
        assert len(top[0].get("fields", {}).get("kids", [])) == 1
        log((views(ta, tb), state(ta)))
    both(script)


def test_schema_validation_and_propagation():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        ta.set_schema({
            "list": {"fields": {"items": {"kind": "sequence",
                                          "child_types": ["item"]}}},
            "item": {"fields": {}},
        })
        (lst,) = ta.root["root"].append({"type": "list"})
        lst["items"].append({"type": "item", "value": 1})
        errors = []
        for bad in (lambda: lst["items"].append({"type": "list"}),
                    lambda: ta.root["root"].append({"type": "mystery"})):
            with pytest.raises(ns.hier.SchemaError) as e:
                bad()
            errors.append(str(e.value))
        drain([a, b])
        assert "list" in tb.schema.types
        assert ta.root.as_data() == tb.root.as_data()
        log((errors, tb.schema.to_spec(), views(ta, tb), state(tb)))
    both(script)


def test_transaction_commit_and_abort():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        with ta.transaction():
            ta.root["f"].append({"type": "n", "value": 1})
            ta.root["f"].append({"type": "n", "value": 2})
        drain([a, b])
        assert [n.value for n in tb.root["f"]] == [1, 2]
        with pytest.raises(RuntimeError):
            with ta.transaction():
                ta.root["f"].append({"type": "n", "value": 3})
                assert len(ta.root["f"]) == 3
                raise RuntimeError("abort")
        assert [n.value for n in ta.root["f"]] == [1, 2]
        drain([a, b])
        assert [n.value for n in tb.root["f"]] == [1, 2]
        log((views(ta, tb), state(tb)))
    both(script)


def test_anchors_survive_edits_and_die_with_node():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        (x,) = ta.root["f"].append({"type": "n", "value": "x"})
        anchor = ta.anchor(x)
        drain([a, b])
        tb.root["f"].insert(0, {"type": "n", "value": "before"})
        drain([a, b])
        assert anchor.valid and anchor.resolve().value == "x"
        log((anchor.node_id, anchor.valid, views(ta, tb)))
        tb.delete_node(anchor.node_id)
        drain([a, b])
        assert not anchor.valid and anchor.resolve() is None
        log((anchor.valid, state(ta)))
    both(script)


def test_offline_edits_resubmit_verbatim():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        (n,) = ta.root["f"].append({"type": "n", "value": "base"})
        drain([a, b])
        a.disconnect()
        ta.root["f"].append({"type": "n", "value": "offline-1"})
        ta.set_value(n.node_id, "changed-offline")
        tb.root["f"].append({"type": "n", "value": "concurrent"})
        b.flush()
        a.reconnect()
        drain([a, b])
        assert ta.root.as_data() == tb.root.as_data()
        vals = [x.value for x in ta.root["f"]]
        assert set(vals) == {"changed-offline", "offline-1", "concurrent"}
        log((vals, views(ta, tb), state(ta)))
    both(script)


def test_summary_roundtrip_and_late_join():
    def script(ns, log):
        svc, (a,) = setup(ns, 1)
        ta = tree_of(a)
        ta.root["f"].append({"type": "n", "value": 1},
                            {"type": "n", "value": 2})
        drain([a])
        a.submit_summary()
        drain([a])
        late = ns.RT(svc, "tree-doc",
                     channels=(ns.ht.HierarchicalTree("tree"),))
        drain([a, late])
        assert tree_of(late).root.as_data() == ta.root.as_data()
        log((views(ta, tree_of(late)), state(tree_of(late))))
    both(script)


def points_tree(ns, n):
    _svc, (a,) = setup(ns, 1)
    ta = tree_of(a)
    for i in range(n):
        ta.root["points"].append({
            "type": "point",
            "fields": {"x": [{"type": "num", "value": float(i)}],
                       "y": [{"type": "num", "value": float(i * 2)}]},
        })
    drain([a])
    return ta


def test_uniform_chunking_and_device_columns():
    def script(ns, log):
        ta = points_tree(ns, 16)
        chunks = ns.chunked.chunk_field(ta._view, 0, "points")
        assert len(chunks) == 1
        assert isinstance(chunks[0], ns.chunked.UniformChunk)
        assert chunks[0].count == 16
        cols = ns.chunked.field_as_arrays(ta._view, 0, "points")
        np.testing.assert_array_equal(cols["x[0]"], np.arange(16.0))
        np.testing.assert_array_equal(cols["y[0]"], np.arange(16.0) * 2)
        dev = (chunks[0].to_device("x[0]", device="cpu") if ns.port
               else chunks[0].to_device("x[0]"))
        assert float(dev.sum()) == float(np.arange(16.0).sum())
        host = dev.numpy() if ns.port else np.asarray(dev)
        log((repr(chunks[0].shape), chunks[0].node_ids,
             {k: (v.dtype.str, v.tobytes()) for k, v in cols.items()},
             host.dtype.str, host.tobytes()))
    both(script)


@pytest.mark.parametrize("seed", range(4))
def test_random_tree_fuzz_convergence(seed):
    def script(ns, log):
        rng = np.random.default_rng(seed)
        _svc, rts = setup(ns, 3)
        trees = [tree_of(rt) for rt in rts]

        def random_node(t):
            ids = list(t._view.nodes.keys())
            return int(ids[rng.integers(0, len(ids))])

        for step in range(120):
            i = int(rng.integers(0, 3))
            t = trees[i]
            roll = rng.random()
            try:
                if roll < 0.5:
                    t.insert_nodes(
                        random_node(t), f"f{int(rng.integers(0, 3))}", 0,
                        [{"type": "n", "value": int(rng.integers(0, 100))}])
                elif roll < 0.7:
                    nid = random_node(t)
                    if nid != 0:
                        t.delete_node(nid)
                elif roll < 0.9:
                    t.set_value(random_node(t), int(rng.integers(0, 100)))
                else:
                    nid, dst = random_node(t), random_node(t)
                    if (nid != 0 and nid != dst
                            and not t._view.is_ancestor(nid, dst)):
                        t.move_node(nid, dst, "m", 0)
            except AssertionError:
                pass
            if step % 3 == 0:
                rts[i].flush()
            if step % 5 == 0:
                for rt in rts:
                    rt.process_incoming()
            if step % 20 == 0:
                log(views(*trees))
        drain(rts)
        datas = [t.root.as_data() for t in trees]
        assert datas[0] == datas[1] == datas[2]
        log((views(*trees), [state(t) for t in trees]))
    both(script)


def test_tx_abort_with_equal_valued_ops_keeps_outer():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        (n,) = ta.root["f"].append({"type": "n", "value": 0})
        drain([a, b])
        with ta.transaction():
            ta.set_value(n.node_id, 7)
            with pytest.raises(RuntimeError):
                with ta.transaction():
                    ta.set_value(n.node_id, 7)
                    raise RuntimeError("abort inner")
        drain([a, b])
        assert ta.root["f"][0].value == tb.root["f"][0].value == 7
        assert not ta._pending
        log((views(ta, tb), state(tb)))
    both(script)


def test_tx_abort_rolls_back_schema():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        with pytest.raises(RuntimeError):
            with ta.transaction():
                ta.set_schema({"only": {"fields": {}}})
                raise RuntimeError("abort")
        assert not ta.schema.types
        ta.root["f"].append({"type": "anything"})
        drain([a, b])
        log((views(ta, tb), state(tb), tb.schema.to_spec()))
    both(script)


def test_move_after_concurrent_delete_stays_deleted():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        (x,) = ta.root["f"].append({"type": "n", "value": "x"})
        (dst,) = ta.root["g"].append({"type": "n", "value": "dst"})
        drain([a, b])
        ta.delete_node(x.node_id)
        tb.move_node(x.node_id, dst.node_id, "kids", 0)
        drain([a, b])
        assert ta.root.as_data() == tb.root.as_data()
        assert len(ta.root["f"]) == 0
        assert len(ta.root["g"][0]["kids"]) == 0
        log((views(ta, tb), state(ta)))
    both(script)


def test_chunking_rejects_polymorphic_fields():
    def script(ns, log):
        _svc, (a,) = setup(ns, 1)
        ta = tree_of(a)
        ta.root["rows"].append(
            {"type": "row", "fields": {"f": [{"type": "num", "value": 1}]}},
            {"type": "row", "fields": {"f": [{"type": "num", "value": 2},
                                              {"type": "num", "value": 3}]}},
        )
        drain([a])
        chunks = ns.chunked.chunk_field(ta._view, 0, "rows")
        assert not any(isinstance(c, ns.chunked.UniformChunk)
                       for c in chunks)
        log(chunks)
    both(script)


def test_tree_attribution_via_op_stream():
    def script(ns, log):
        _svc, (a, b) = setup(ns)
        ta, tb = tree_of(a), tree_of(b)
        attr_b = ns.attr.OpStreamAttributor(b)
        ta.root["f"].append({"type": "n", "value": "original"})
        drain([a, b])
        node_b = tb.root["f"][0]
        ins_seq = node_b.insert_seq
        assert ins_seq > 0
        who = attr_b.get(ins_seq)
        assert who is not None and who[0] == a.client_id
        tb.set_value(node_b.node_id, "edited-by-b")
        drain([a, b])
        val_seq = tb.root["f"][0].value_seq
        assert val_seq > ins_seq
        assert attr_b.get(val_seq)[0] == b.client_id
        ta.root["f"].append({"type": "n", "value": "pending"})
        assert ta.root["f"][1].insert_seq == 0
        log((ins_seq, val_seq, who[0], sorted(attr_b.entries())))
    both(script)


# ---------------------------------------------------------------------------
# LegacySharedTree (tests/test_dds_families.py)


def legacy_pair(ns):
    return setup(ns, 2, "fam-doc", lambda: ns.legacy.LegacySharedTree("t"))


def legacy_state(*trees) -> tuple:
    return tuple((json.dumps(t.current_view(), sort_keys=True),
                  len(t.edit_log), state(t)) for t in trees)


def test_legacy_tree_edits_history_and_undo():
    def script(ns, log):
        _svc, (a, b) = legacy_pair(ns)
        ta, tb = a.get_channel("t"), b.get_channel("t")
        nid = ta.insert_node(0, "kids", {"type": "n", "value": "hello"})
        drain([a, b])
        assert tb.current_view() == ta.current_view()
        assert len(tb.edit_log) == 1
        e2 = ta.apply_edit({"k": "val", "id": nid, "value": "changed"})
        drain([a, b])
        assert tb.current_view()["fields"]["kids"][0]["value"] == "changed"
        before = tb.log_viewer.revision_at(1)
        assert before.subtree(0)["fields"]["kids"][0]["value"] == "hello"
        log((nid, e2, legacy_state(ta, tb),
             json.dumps(before.serialize(), sort_keys=True)))
        ta.undo(e2)
        drain([a, b])
        assert tb.current_view()["fields"]["kids"][0]["value"] == "hello"
        log(legacy_state(ta, tb))
    both(script)


def test_legacy_tree_constraint_drops_whole_edit():
    def script(ns, log):
        _svc, (a, b) = legacy_pair(ns)
        ta, tb = a.get_channel("t"), b.get_channel("t")
        nid = ta.insert_node(0, "kids", {"type": "n", "value": 1})
        drain([a, b])
        tb.insert_node(0, "kids", {"type": "n", "value": 2})
        b.flush()
        ta.apply_edit(
            {"k": "constraint", "parent": 0, "field": "kids", "length": 1},
            {"k": "val", "id": nid, "value": 99},
        )
        drain([a, b])
        assert ta.current_view() == tb.current_view()
        vals = [k["value"] for k in ta.current_view()["fields"]["kids"]]
        assert 99 not in vals
        log(legacy_state(ta, tb))
    both(script)


def test_legacy_tree_edit_references_its_own_insert():
    def script(ns, log):
        _svc, (a, b) = legacy_pair(ns)
        ta, tb = a.get_channel("t"), b.get_channel("t")
        node = ta._assign_ids({"type": "n"})
        ta.apply_edit(
            {"k": "ins", "parent": 0, "field": "kids", "anchor": None,
             "nodes": [node]},
            {"k": "val", "id": node["id"], "value": "set-in-same-edit"},
        )
        drain([a, b])
        assert (tb.current_view()["fields"]["kids"][0]["value"]
                == "set-in-same-edit")
        log(legacy_state(ta, tb))
    both(script)


def test_legacy_tree_undo_of_dependent_changes():
    def script(ns, log):
        _svc, (a, b) = legacy_pair(ns)
        ta, tb = a.get_channel("t"), b.get_channel("t")
        node = ta._assign_ids({"type": "n"})
        eid = ta.apply_edit(
            {"k": "ins", "parent": 0, "field": "kids", "anchor": None,
             "nodes": [node]},
            {"k": "val", "id": node["id"], "value": 7},
        )
        drain([a, b])
        ta.undo(eid)
        drain([a, b])
        assert ta.current_view() == tb.current_view()
        assert not ta.current_view().get("fields", {}).get("kids")
        eid2 = ta.apply_edit({"k": "del", "id": 999999})
        drain([a, b])
        assert ta.undo(eid2) is None
        log((eid, eid2, legacy_state(ta, tb)))
    both(script)


# ---------------------------------------------------------------------------
# chunked.to_device: the JAX dtype rule


COLUMNS = {
    "int64": [1, 2**40, -3, 7],
    "float64": [1.5, 1e300, float("nan"), -0.0],
    "bool": [True, False, True],
    "mixed_int_float": [1, 2.5, 3],
}


def _chunk(mod, values):
    return mod.UniformChunk(
        shape=None, count=len(values), node_ids=list(range(len(values))),
        columns={"v": np.asarray(values)})


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_to_device_matches_the_jax_dtype_rule(name):
    values = COLUMNS[name]
    with np.errstate(over="ignore"):
        want = np.asarray(jnp.asarray(np.asarray(values)))
        got = _chunk(chunked, values).to_device("v", device="cpu")
        via_ref = np.asarray(_chunk(ref_chunked, values).to_device("v"))
    assert got.device.type == "cpu"
    host = got.numpy()
    assert host.dtype == want.dtype == via_ref.dtype
    assert host.tobytes() == want.tobytes() == via_ref.tobytes()


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float16,
                                   np.int32, np.float32])
def test_to_device_keeps_narrow_dtypes(dtype):
    col = np.arange(5).astype(dtype)
    c = chunked.UniformChunk(shape=None, count=5, node_ids=list(range(5)),
                             columns={"v": col})
    got = c.to_device("v", device="cpu").numpy()
    want = np.asarray(jnp.asarray(col))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # A copy: writing the tensor leaves the chunk's column as it was.
    t = c.to_device("v", device="cpu")
    t += 1
    assert np.array_equal(c.columns["v"], col)


def test_string_column_raises_in_both_packages():
    for mod in (ref_chunked, chunked):
        c = _chunk(mod, ["a", "b"])
        kw = {"device": "cpu"} if mod is chunked else {}
        with pytest.raises(TypeError):
            c.to_device("v", **kw)

