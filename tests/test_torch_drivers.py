"""Parity: the port's drivers (``drivers/binary_snapshot.py``,
``caching_driver.py``, ``debugger_driver.py``, ``file_driver.py``) against
the reference's.

Each case of tests/test_binary_snapshot.py, tests/test_driver_wrappers.py
and tests/test_summaries.py::test_file_capture_copies_chunk_blobs runs
once per package (reference classes over the reference's
``LocalFluidService``, port classes over the port's, the port's strings
and trees with ``device="cpu"``): the reference test's assertions hold on
both, and what the script observes must be equal across the packages.
Beyond the mirrored cases:

- ``encode_snapshot`` gives the same bytes in both packages, for plain
  values and for the runtimes' summaries of one script, and each package
  decodes the other's bytes;
- a directory saved by either package's ``save_document`` loads in the
  other's ``load_document`` and replays to the same text;
- one script's ``save_document`` directories are byte-equal across the
  packages (the sequencer's clock is one fake clock per package);
- the port's encoder refuses a tensor.
"""

import functools
import json
import os
import types as pytypes

import numpy as np
import pytest
import torch

from fluidframework_tpu.drivers import binary_snapshot as ref_bs
from fluidframework_tpu.drivers import caching_driver as ref_cache
from fluidframework_tpu.drivers import debugger_driver as ref_dbg
from fluidframework_tpu.drivers import file_driver as ref_file
from fluidframework_tpu.models.shared_map import SharedMap as RefMap
from fluidframework_tpu.models.shared_string import SharedString as RefString
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service import sequencer as ref_sequencer
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu.service.summary_store import SummaryStore as RefStore
from fluidframework_tpu.tree import SharedTree as RefTree
from fluidframework_tpu_torch.drivers import binary_snapshot as bs
from fluidframework_tpu_torch.drivers import caching_driver as cache_mod
from fluidframework_tpu_torch.drivers import debugger_driver as dbg
from fluidframework_tpu_torch.drivers import file_driver as file_mod
from fluidframework_tpu_torch.models.shared_map import SharedMap
from fluidframework_tpu_torch.models.shared_string import SharedString
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service import sequencer as port_sequencer
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from fluidframework_tpu_torch.service.summary_store import SummaryStore
from fluidframework_tpu_torch.tree import SharedTree
from test_torch_consensus_ddses import both_over
from test_torch_framework import FakeClock

REF = pytypes.SimpleNamespace(
    port=False, RT=RefRT, Svc=RefSvc, Store=RefStore, bs=ref_bs,
    cache=ref_cache, dbg=ref_dbg, file=ref_file, String=RefString,
    Map=RefMap, Tree=RefTree, sequencer=ref_sequencer,
)
PORT = pytypes.SimpleNamespace(
    port=True, RT=ContainerRuntime, Svc=LocalFluidService, Store=SummaryStore,
    bs=bs, cache=cache_mod, dbg=dbg, file=file_mod,
    String=functools.partial(SharedString, device="cpu"), Map=SharedMap,
    Tree=functools.partial(SharedTree, device="cpu"),
    sequencer=port_sequencer,
)


@pytest.fixture(autouse=True)
def _same_clock(monkeypatch):
    for ns in (REF, PORT):
        monkeypatch.setattr(ns.sequencer, "time", FakeClock())


def both(script):
    both_over(script, REF, PORT)


def drain(rts):
    for rt in rts:
        if rt.connected:
            rt.flush()
    busy = True
    while busy:
        busy = any(rt.process_incoming() for rt in rts if rt.connected)


# ---------------------------------------------------------------------------
# binary snapshot (tests/test_binary_snapshot.py)

VALUES = [
    None, True, False, 0, -1, 2**40, -(2**40), 3.5, "héllo", b"\x00\xff",
    [], {}, [1, "a", None, [2.5]], {"k": {"n": [1, 2, 3]}, "z": "s"},
    list(range(-5, 20)), [2**31 - 1, -(2**31)] * 5, [2**31] * 9,
    -(2**63) - 1, 2**70, -(2**70), (1, 2), float("inf"), -0.0,
]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_roundtrip_values_and_bytes(i):
    value = VALUES[i]
    blob = bs.encode_snapshot(value)
    assert blob == ref_bs.encode_snapshot(value)
    assert bs.decode_snapshot(blob) == ref_bs.decode_snapshot(blob)
    want = list(value) if isinstance(value, tuple) else value
    assert bs.decode_snapshot(blob) == want


def summary_script(ns, log):
    svc = ns.Svc()
    a = ns.RT(svc, "doc", channels=(ns.String("t"), ns.Map("m")))
    a.get_channel("t").insert_text(0, "binary snapshot body " * 200)
    a.get_channel("t").annotate(3, 40, 5)
    a.get_channel("t").remove_range(10, 30)
    a.get_channel("m").set("k", [1, 2, 3])
    while a.process_incoming():
        pass
    summary = a.summarize()
    blob = ns.bs.encode_snapshot(summary)
    assert ns.bs.decode_snapshot(blob) == json.loads(json.dumps(summary))
    assert len(blob) < len(json.dumps(summary).encode())
    log(blob)
    return blob


def test_roundtrip_real_summary_and_size():
    both(summary_script)


def test_summary_bytes_decode_across_packages():
    """Each package decodes the other's bytes of one script's summary to
    the same value, and re-encodes it to the same bytes."""
    blobs = {}
    for name, ns in (("ref", REF), ("port", PORT)):
        blobs[name] = summary_script(ns, lambda _x: None)
    assert blobs["ref"] == blobs["port"]
    assert bs.decode_snapshot(blobs["ref"]) == \
        ref_bs.decode_snapshot(blobs["port"])
    assert bs.encode_snapshot(ref_bs.decode_snapshot(blobs["ref"])) == \
        blobs["ref"]


def test_deterministic_encoding_content_addresses():
    def script(ns, log):
        a = {"b": 1, "a": [9] * 20}
        b = {"a": [9] * 20, "b": 1}
        assert ns.bs.encode_snapshot(a) == ns.bs.encode_snapshot(b)
        log(ns.bs.encode_snapshot(a))
    both(script)


def test_rejects_garbage():
    def script(ns, log):
        for bad in (b"not a snapshot",
                    ns.bs.encode_snapshot({"x": 1}) + b"junk",
                    ns.bs.encode_snapshot({"x": "long string"})[:-3]):
            with pytest.raises(ValueError) as e:
                ns.bs.decode_snapshot(bad)
            log(str(e.value))
    both(script)


def test_big_ints_roundtrip():
    def script(ns, log):
        for v in (-(2**63) - 1, 2**70, -(2**70)):
            blob = ns.bs.encode_snapshot(v)
            assert ns.bs.decode_snapshot(blob) == v
            log(blob)
    both(script)


def test_encoder_refuses_tensors_and_numpy_values():
    """A tensor that leaks into a summary raises instead of being guessed
    into bytes; numpy arrays and non-float numpy scalars raise in both
    packages alike."""
    for v in (torch.arange(3, dtype=torch.int32), torch.tensor(5),
              {"lanes": [1, torch.tensor(2)]}):
        with pytest.raises(TypeError, match="torch.Tensor"):
            bs.encode_snapshot(v)
    for v in (np.arange(3), np.int32(4), {"k": np.int64(1)}):
        for mod in (bs, ref_bs):
            with pytest.raises(TypeError, match="unencodable"):
                mod.encode_snapshot(v)


# ---------------------------------------------------------------------------
# caching and debugger drivers (tests/test_driver_wrappers.py)


def cache_files(d) -> list:
    out = []
    for root, _dirs, files in os.walk(d):
        for f in sorted(files):
            p = os.path.join(root, f)
            out.append((os.path.relpath(p, d), open(p, "rb").read()))
    return sorted(out)


def test_caching_driver_serves_cold_start_from_cache(tmp_path):
    def script(ns, log):
        d = str(tmp_path / ("port" if ns.port else "ref"))
        inner = ns.Svc()
        author = ns.RT(inner, "doc", channels=(ns.String("t"),))
        author.get_channel("t").insert_text(0, "cached content")
        drain([author])
        svc = ns.cache.CachingFluidService(inner, ns.cache.PersistentCache(d))
        svc.snapshot_to_cache("doc")
        svc2 = ns.cache.CachingFluidService(inner,
                                            ns.cache.PersistentCache(d))
        reader = ns.RT(svc2, "doc", channels=(ns.String("t"),))
        drain([author, reader])
        assert reader.get_channel("t").get_text() == "cached content"
        assert svc2.stats["cached_ops_served"] > 0
        log((svc2.stats, cache_files(d)))
    both(script)


def test_caching_driver_epoch_mismatch_evicts(tmp_path):
    def script(ns, log):
        d = str(tmp_path / ("port" if ns.port else "ref"))
        inner = ns.Svc()
        author = ns.RT(inner, "doc", channels=(ns.String("t"),))
        author.get_channel("t").insert_text(0, "v1")
        drain([author])
        epoch = {"doc": 1}
        svc = ns.cache.CachingFluidService(
            inner, ns.cache.PersistentCache(d), epoch_of=lambda x: epoch[x])
        svc.snapshot_to_cache("doc")
        epoch["doc"] = 2
        reader = ns.RT(svc, "doc", channels=(ns.String("t"),))
        drain([author, reader])
        assert reader.get_channel("t").get_text() == "v1"
        assert svc.stats["evictions"] == 1
        assert svc.stats["cached_ops_served"] == 0
        log((svc.stats, cache_files(d)))
    both(script)


def test_debugger_pauses_and_steps_delivery():
    def script(ns, log):
        ctl = ns.dbg.DebuggerController()
        svc = ns.dbg.DebuggerFluidService(ns.Svc(), ctl)
        a = ns.RT(svc, "doc", channels=(ns.String("t"),))
        b = ns.RT(svc, "doc", channels=(ns.String("t"),))
        ctl.pause()
        a.get_channel("t").insert_text(0, "xyz")
        a.flush()
        b.process_incoming()
        assert b.get_channel("t").get_text() == ""
        ctl.step(1)
        b.process_incoming(1)
        ctl.resume()
        drain([a, b])
        assert b.get_channel("t").get_text() == "xyz"
        assert {d for d, *_ in ctl.log} == {"in", "out"}
        log([(d, doc, type(m).__name__, getattr(m, "sequence_number", None))
             for d, doc, m in ctl.log])
    both(script)


def test_caching_driver_summary_plus_tail_cold_start():
    def script(ns, log):
        inner = ns.Svc()
        author = ns.RT(inner, "doc", channels=(ns.String("t"),))
        author.get_channel("t").insert_text(0, "summarized")
        drain([author])
        author.submit_summary()
        drain([author])
        author.get_channel("t").insert_text(0, "tail-")
        drain([author])
        svc = ns.cache.CachingFluidService(inner)
        svc.snapshot_to_cache(
            "doc", initial_summary=inner.docs["doc"].latest_summary)
        reader = ns.RT(svc, "doc", channels=(ns.String("t"),))
        drain([author, reader])
        assert reader.get_channel("t").get_text() == "tail-summarized"
        assert svc.stats["cached_ops_served"] > 0
        log((svc.stats, ns.bs.encode_snapshot(svc.cache.get_doc("doc"))))
    both(script)


def test_debugger_steps_not_lost_to_partial_release():
    def script(ns, log):
        ctl = ns.dbg.DebuggerController()
        svc = ns.dbg.DebuggerFluidService(ns.Svc(), ctl)
        a = ns.RT(svc, "doc", channels=(ns.String("t"),))
        b = ns.RT(svc, "doc", channels=(ns.String("t"),))
        ctl.pause()
        a.get_channel("t").insert_text(0, "x")
        a.get_channel("t").insert_text(1, "y")
        a.flush()
        ctl.step(2)
        b.process_incoming(1)
        b.process_incoming(1)
        assert b.get_channel("t").get_text() == "xy"
        log((ctl.pending_steps(), len(ctl.log)))
    both(script)


def test_cache_hostile_handles_stay_inside_cache_dir(tmp_path):
    def script(ns, log):
        base = tmp_path / ("port" if ns.port else "ref")
        cache = ns.cache.PersistentCache(str(base / "cache"))
        evil = "../../escape"
        cache.put_blob(evil, b"payload")
        assert cache.get_blob(evil) == b"payload"
        assert cache.has_blob(evil)
        cache.put_doc("../esc-doc", {"epoch": 1, "head": 0, "ops": [],
                                     "summary": None})
        assert cache.get_doc("../esc-doc") is not None
        assert not (base.parent / "escape").exists()
        assert not (base / "escape").exists()
        outside = [p for p in base.rglob("*") if p.is_file()
                   and "cache" not in p.parts[len(base.parts):][0:1]]
        assert outside == []
        log(cache_files(str(base)))
    both(script)


def test_cache_disk_roundtrip_with_hashed_names(tmp_path):
    def script(ns, log):
        d = str(tmp_path / ("port" if ns.port else "ref") / "c")
        cache = ns.cache.PersistentCache(d)
        cache.put_blob("sha-abc", b"hello")
        cache.put_doc("doc1", {"epoch": 1, "head": 3, "ops": [],
                               "summary": None})
        fresh = ns.cache.PersistentCache(d)
        assert fresh.get_blob("sha-abc") == b"hello"
        assert fresh.get_doc("doc1")["head"] == 3
        log(cache_files(d))
    both(script)


# ---------------------------------------------------------------------------
# file driver (tests/test_summaries.py::test_file_capture_copies_chunk_blobs)


def file_channels(ns):
    return (ns.String("text"), ns.Map("meta"), ns.Tree("list"))


def saved_doc(ns, path):
    """One script: a chunked-store document with ops past a summary,
    saved to ``path``; returns the live runtime."""
    svc = ns.Svc(store=ns.Store(chunk_bytes=512))
    a = ns.RT(svc, "doc", channels=file_channels(ns))
    a.get_channel("text").insert_text(0, "chunky " * 400)
    a.get_channel("meta").set("k", {"v": [1, 2, 3]})
    drain([a])
    a.submit_summary()
    drain([a])
    a.get_channel("text").insert_text(7, "tail ")
    drain([a])
    ns.file.save_document(svc, "doc", path)
    return a


def test_file_capture_copies_chunk_blobs(tmp_path):
    def script(ns, log):
        d = str(tmp_path / ("port" if ns.port else "ref"))
        a = saved_doc(ns, d)
        fds = ns.file.FileDocumentService(d, doc_id="doc")
        b = ns.RT(fds.as_replay_service(), "doc", channels=file_channels(ns),
                  mode="read")
        assert b.get_channel("text").get_text() == \
            a.get_channel("text").get_text()
        assert b.get_channel("text").get_text().startswith("chunky tail ")
        log((b.get_channel("text").get_text(), len(fds.ops),
             fds.initial_summary, sorted(os.listdir(os.path.join(d,
                                                                 "blobs")))))
    both(script)


def test_save_document_directories_are_byte_equal(tmp_path):
    dirs = {}
    for name, ns in (("ref", REF), ("port", PORT)):
        dirs[name] = str(tmp_path / name)
        saved_doc(ns, dirs[name])
    ref_files, port_files = cache_files(dirs["ref"]), cache_files(dirs["port"])
    assert [p for p, _ in port_files] == [p for p, _ in ref_files]
    for (path, x), (_, y) in zip(port_files, ref_files):
        assert x == y, path
    assert len(ref_files) > 3


@pytest.mark.parametrize("saver", ["ref", "port"])
def test_saved_directory_loads_in_the_other_package(tmp_path, saver):
    save_ns, load_ns = (REF, PORT) if saver == "ref" else (PORT, REF)
    d = str(tmp_path / "saved")
    live = saved_doc(save_ns, d)
    fds = load_ns.file.load_document(d, doc_id="doc")
    reader = load_ns.RT(fds.as_replay_service(), "doc",
                        channels=file_channels(load_ns), mode="read")
    assert reader.get_channel("text").get_text() == \
        live.get_channel("text").get_text()
    assert dict(reader.get_channel("meta").items()) == \
        dict(live.get_channel("meta").items())
    # Stepped replay to a seq in the middle matches on both sides.
    mid = fds.ops[len(fds.ops) // 2].sequence_number
    other = save_ns.file.load_document(d, doc_id="doc")
    texts = []
    for ns, f in ((load_ns, fds), (save_ns, other)):
        rt = ns.RT(f.as_replay_service(replay_to=mid), "doc",
                   channels=file_channels(ns), mode="read")
        texts.append(rt.get_channel("text").get_text())
    assert texts[0] == texts[1]


def test_drivers_package_exports_the_file_driver():
    import fluidframework_tpu.drivers as ref_drivers
    import fluidframework_tpu_torch.drivers as drivers

    for name in ("FileDocumentService", "load_document", "save_document"):
        assert name in drivers.__all__ and name in ref_drivers.__all__
        assert getattr(drivers, name) is getattr(file_mod, name)
