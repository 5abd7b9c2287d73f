"""Parity: the port's ``models/shared_directory.py``, ``ink.py``,
``summary_block.py`` and ``id_compressor.py`` (and the SharedMap clear
shadowing case beside them) against the reference's.

Each case of tests/test_new_ddses.py runs once per package over that
package's ``ContainerRuntime`` and ``LocalFluidService``: the reference
test's assertions hold on both, and the observations the script records
(reads, stroke ids and points, id mappings, summaries as JSON bytes) must
be equal across the packages. ``uuid`` in the id compressor comes from
one counter per package.
"""

import json
import types as pytypes

import numpy as np
import pytest

import test_torch_pipeline as TP
from fluidframework_tpu.models import id_compressor as ref_ids
from fluidframework_tpu.models import ink as ref_ink
from fluidframework_tpu.models import shared_directory as ref_dir
from fluidframework_tpu.models import summary_block as ref_block
from fluidframework_tpu.models.shared_map import SharedMap as RefMap
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu_torch.models import id_compressor as ids
from fluidframework_tpu_torch.models import ink
from fluidframework_tpu_torch.models import shared_directory as directory
from fluidframework_tpu_torch.models import summary_block as block
from fluidframework_tpu_torch.models.shared_map import SharedMap
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from test_torch_consensus_ddses import both_over

REF = pytypes.SimpleNamespace(
    RT=RefRT, Svc=RefSvc, SharedDirectory=ref_dir.SharedDirectory,
    Ink=ref_ink.Ink, SharedSummaryBlock=ref_block.SharedSummaryBlock,
    IdCompressor=ref_ids.IdCompressor, SharedMap=RefMap, ids_mod=ref_ids,
)
PORT = pytypes.SimpleNamespace(
    RT=ContainerRuntime, Svc=LocalFluidService,
    SharedDirectory=directory.SharedDirectory, Ink=ink.Ink,
    SharedSummaryBlock=block.SharedSummaryBlock,
    IdCompressor=ids.IdCompressor, SharedMap=SharedMap, ids_mod=ids,
)


@pytest.fixture(autouse=True)
def _same_uuids(monkeypatch):
    for ns in (REF, PORT):
        monkeypatch.setattr(ns.ids_mod, "_uuid", TP.FakeUuid())


def make(ns, n, channels_fn):
    svc = ns.Svc()
    return svc, [ns.RT(svc, "doc", channels=channels_fn()) for _ in range(n)]


def drain(rts):
    for rt in rts:
        rt.flush()
    while any(rt.process_incoming() for rt in rts):
        pass


def state(ch) -> str:
    return json.dumps(ch.summarize_core(), sort_keys=True)


def both(script):
    both_over(script, REF, PORT)


def strokes(ch) -> list:
    return [(s.id, s.pen, s.points.dtype.str, s.points.tolist())
            for s in ch.strokes()]


class TestSharedDirectory:
    def test_root_and_nested_keys_converge(self):
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.SharedDirectory("d"),))
            da, db = a.get_channel("d"), b.get_channel("d")
            da.set("top", 1)
            wa = da.create_subdirectory("ws")
            wa.set("x", 10)
            wa.create_subdirectory("deep").set("y", 20)
            drain([a, b])
            assert db.get("top") == 1
            wb = db.get_subdirectory("ws")
            assert wb.get("x") == 10
            assert wb.get_subdirectory("deep").get("y") == 20
            assert [n for n, _ in db.root.subdirectories()] == ["ws"]
            log((state(da), state(db)))
        both(script)

    def test_same_key_lww_and_local_pending_wins(self):
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.SharedDirectory("d"),))
            da, db = a.get_channel("d"), b.get_channel("d")
            da.create_subdirectory("s")
            drain([a, b])
            da.get_subdirectory("s").set("k", "a")
            db.get_subdirectory("s").set("k", "b")
            log((da.get_subdirectory("s").get("k"),
                 db.get_subdirectory("s").get("k")))
            drain([a, b])
            assert da.get_subdirectory("s").get("k") == \
                db.get_subdirectory("s").get("k")
            log((da.get_subdirectory("s").get("k"), state(da), state(db)))
        both(script)

    def test_rmdir_drops_subtree_everywhere(self):
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.SharedDirectory("d"),))
            da, db = a.get_channel("d"), b.get_channel("d")
            da.create_subdirectory("gone").set("k", 1)
            da.get_subdirectory("gone").create_subdirectory("below").set(
                "z", 2)
            drain([a, b])
            assert db.get_subdirectory("gone").get_subdirectory(
                "below").get("z") == 2
            log(state(db))
            db.root.delete_subdirectory("gone")
            drain([a, b])
            assert da.get_subdirectory("gone") is None
            assert db.get_subdirectory("gone") is None
            log((state(da), state(db)))
        both(script)

    def test_set_under_concurrently_deleted_subtree_dropped(self):
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.SharedDirectory("d"),))
            da, db = a.get_channel("d"), b.get_channel("d")
            da.create_subdirectory("s")
            drain([a, b])
            da.get_subdirectory("s").set("k", 1)
            db.root.delete_subdirectory("s")
            drain([a, b])
            assert da.get_subdirectory("s") is None
            assert db.get_subdirectory("s") is None
            log((state(da), state(db)))
        both(script)

    def test_clear_total_order_semantics(self):
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.SharedDirectory("d"),))
            da, db = a.get_channel("d"), b.get_channel("d")
            da.set("stale", 1)
            drain([a, b])
            da.set("mine", 2)
            db.root.clear()
            drain([a, b])
            assert not da.has("mine") and not db.has("mine")
            assert not da.has("stale") and not db.has("stale")
            log((state(da), state(db)))
            db.root.clear()
            da.set("keep", 3)
            for rt in (b, a):  # b flushes first: clear @ M, set @ M+1
                rt.flush()
            drain([a, b])
            assert da.get("keep") == 3 and db.get("keep") == 3
            log((state(da), state(db)))
        both(script)

    @pytest.mark.parametrize("mkdir_first", [True, False])
    def test_rmdir_racing_a_remote_mkdir_matches_the_reference(
            self, mkdir_first):
        """A delete of a path that does not exist yet, concurrent with a
        remote create of it: the deleter keeps the remote subdirectory
        (its own delete is acked as local, so it never drops it again)
        while the creator drops it. The reference's replicas diverge so;
        the port's replicas equal their reference twins."""
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.SharedDirectory("d"),))
            da, db = a.get_channel("d"), b.get_channel("d")
            if mkdir_first:
                db.create_subdirectory("s").set("v", 1)
                da.root.delete_subdirectory("s")
            else:
                da.root.delete_subdirectory("s")
                db.create_subdirectory("s").set("v", 1)
            b.flush()
            a.flush()
            drain([a, b])
            assert da.get_subdirectory("s") is not None
            assert db.get_subdirectory("s") is None
            log((state(da), state(db)))
        both(script)

    def test_summary_roundtrip(self):
        def script(ns, log):
            svc, (a,) = make(ns, 1, lambda: (ns.SharedDirectory("d"),))
            d = a.get_channel("d")
            d.set("k", 1)
            d.create_subdirectory("s").set("x", [1, 2])
            drain([a])
            a.submit_summary()
            drain([a])
            b = ns.RT(svc, "doc", channels=(ns.SharedDirectory("d"),))
            assert b.get_channel("d").get("k") == 1
            assert b.get_channel("d").get_subdirectory("s").get("x") == [1, 2]
            log((state(d), state(b.get_channel("d"))))
        both(script)


class TestInk:
    def test_strokes_converge(self):
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.Ink("ink"),))
            ia, ib = a.get_channel("ink"), b.get_channel("ink")
            sa = ia.create_stroke({"color": "red"})
            ia.append_points(sa.id, [[0, 0, 0.0, 1.0], [1, 1, 0.1, 1.0]])
            sb = ib.create_stroke({"color": "blue"})
            ib.append_points(sb.id, [[5, 5, 0.0, 0.5]])
            drain([a, b])
            assert [s.id for s in ia.strokes()] == \
                [s.id for s in ib.strokes()]
            assert ib.get_stroke(sa.id).points.shape == (2, 4)
            assert ia.get_stroke(sb.id).pen == {"color": "blue"}
            np.testing.assert_array_equal(ia.get_stroke(sa.id).points,
                                          ib.get_stroke(sa.id).points)
            log((strokes(ia), strokes(ib), state(ia)))
        both(script)

    def test_incremental_appends_in_order(self):
        def script(ns, log):
            _svc, (a, b) = make(ns, 2, lambda: (ns.Ink("ink"),))
            ia, ib = a.get_channel("ink"), b.get_channel("ink")
            s = ia.create_stroke()
            for i in range(5):
                ia.append_points(s.id, [[i, i, i * 0.1, 1.0]])
                drain([a, b])
                log(strokes(ib))
            pts = ib.get_stroke(s.id).points
            np.testing.assert_allclose(pts[:, 0],
                                       np.arange(5, dtype=np.float32))
        both(script)

    def test_clear_and_summary(self):
        def script(ns, log):
            svc, (a,) = make(ns, 1, lambda: (ns.Ink("ink"),))
            ch = a.get_channel("ink")
            s = ch.create_stroke()
            ch.append_points(s.id, [[1, 2, 3, 4]])
            drain([a])
            a.submit_summary()
            drain([a])
            b = ns.RT(svc, "doc", channels=(ns.Ink("ink"),))
            assert len(b.get_channel("ink").strokes()) == 1
            log((strokes(b.get_channel("ink")), state(b.get_channel("ink"))))
            ch.clear()
            drain([a])
            assert ch.strokes() == []
            log(state(ch))
        both(script)


class TestSharedSummaryBlock:
    def test_rides_summary_not_ops(self):
        def script(ns, log):
            svc, (a, b) = make(ns, 2, lambda: (ns.SharedSummaryBlock("sb"),))
            a.get_channel("sb").set("index", {"terms": 40})
            drain([a, b])
            assert b.get_channel("sb").get("index") is None
            a.submit_summary()
            drain([a, b])
            c = ns.RT(svc, "doc", channels=(ns.SharedSummaryBlock("sb"),))
            assert c.get_channel("sb").get("index") == {"terms": 40}
            log((state(a.get_channel("sb")), state(b.get_channel("sb")),
                 state(c.get_channel("sb"))))
        both(script)


class TestIdCompressor:
    @staticmethod
    def mk(ns):
        svc = ns.Svc()

        def one(s):
            return ns.RT(svc, "doc", channels=(ns.IdCompressor(
                "ids", cluster_capacity=8, session_id=s),))

        return svc, one("sess-a"), one("sess-b")

    def test_locals_usable_immediately_then_finalize(self):
        def script(ns, log):
            _svc, a, b = self.mk(ns)
            ca = a.get_channel("ids")
            got = ca.generate_ids(3)
            assert got == [-1, -2, -3]
            assert ca.normalize_to_final(-1) is None
            ca.take_id_range()
            drain([a, b])
            assert [ca.normalize_to_final(i) for i in got] == [0, 1, 2]
            log((state(ca), state(b.get_channel("ids"))))
        both(script)

    def test_cross_session_disjoint_and_convergent(self):
        def script(ns, log):
            _svc, a, b = self.mk(ns)
            ca, cb = a.get_channel("ids"), b.get_channel("ids")
            ca.generate_ids(3)
            cb.generate_ids(2)
            ca.take_id_range()
            cb.take_id_range()
            drain([a, b])
            fa = [ca.normalize_to_final(-i) for i in (1, 2, 3)]
            fb = [cb.normalize_to_final(-i) for i in (1, 2)]
            assert set(fa).isdisjoint(fb)
            for f in fa:
                assert ca.decompress(f) == cb.decompress(f) == \
                    ("sess-a", fa.index(f))
            for f in fb:
                assert ca.decompress(f)[0] == "sess-b"
            assert ca.recompress("sess-b", 0) == fb[0]
            log((fa, fb, state(ca), state(cb)))
        both(script)

    def test_cluster_reuse_keeps_ids_dense(self):
        def script(ns, log):
            _svc, a, b = self.mk(ns)
            ca = a.get_channel("ids")
            ca.generate_ids(3)
            ca.take_id_range()
            drain([a, b])
            ca.generate_ids(3)
            ca.take_id_range()
            drain([a, b])
            assert [ca.normalize_to_final(-i) for i in (4, 5, 6)] == \
                [3, 4, 5]
            assert ca._next_final == 8
            log((state(ca), state(b.get_channel("ids"))))
        both(script)

    def test_overflow_allocates_new_cluster(self):
        def script(ns, log):
            _svc, a, b = self.mk(ns)
            ca, cb = a.get_channel("ids"), b.get_channel("ids")
            ca.generate_ids(8)
            ca.take_id_range()
            cb.generate_ids(1)
            cb.take_id_range()
            drain([a, b])
            ca.generate_ids(2)
            ca.take_id_range()
            drain([a, b])
            finals = [ca.normalize_to_final(-i) for i in (9, 10)]
            assert finals[0] >= 16
            assert ca.decompress(finals[1]) == ("sess-a", 9)
            assert cb.decompress(finals[1]) == ("sess-a", 9)
            log((finals, state(ca), state(cb)))
        both(script)

    def test_summary_roundtrip(self):
        def script(ns, log):
            svc, a, b = self.mk(ns)
            ca = a.get_channel("ids")
            ca.generate_ids(3)
            ca.take_id_range()
            drain([a, b])
            a.submit_summary()
            drain([a, b])
            c = ns.RT(svc, "doc", channels=(ns.IdCompressor(
                "ids", cluster_capacity=8, session_id="sess-c"),))
            cc = c.get_channel("ids")
            assert cc.decompress(2) == ("sess-a", 2)
            cc.generate_ids(1)
            cc.take_id_range()
            drain([c, a, b])
            assert cc.normalize_to_final(-1) == 8
            assert ca.decompress(8) == ("sess-c", 0)
            log((state(ca), state(cc)))
        both(script)

    def test_session_id_defaults_to_a_uuid(self):
        """Without a session id each package draws one from ``uuid``."""
        def script(ns, log):
            svc = ns.Svc()
            rt = ns.RT(svc, "doc", channels=(ns.IdCompressor("ids"),))
            log(rt.get_channel("ids").session_id)
        both(script)


class TestSharedMapClearShadowing:
    def test_remote_set_during_pending_local_clear(self):
        def script(ns, log):
            svc = ns.Svc()
            a = ns.RT(svc, "doc", channels=(ns.SharedMap("m"),))
            b = ns.RT(svc, "doc", channels=(ns.SharedMap("m"),))
            ma, mb = a.get_channel("m"), b.get_channel("m")
            ma.set("x", 1)
            drain([a, b])
            ma.set("y", 2)
            mb.clear()
            drain([a, b])
            assert not ma.has("y") and not mb.has("y")
            assert not ma.has("x") and not mb.has("x")
            log((state(ma), state(mb)))
        both(script)
