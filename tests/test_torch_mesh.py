"""Parity: the port's device mesh (``parallel/mesh.py``: the device list,
``DocShard``, ``apply_and_stats``; ``DocFleet(mesh=)``;
``PipelineFluidService(device_mesh=)``) against the JAX reference on its
eight virtual CPU devices (tests/conftest.py), driven with the same seeded
numpy ops.

The port's mesh is an ordered list of eight ``cpu`` entries, the
counterpart of the reference's eight virtual devices, so shard counts,
slot counts and telemetry shapes are the reference's. After every step
both sides must agree exactly (int32, tolerance 0): every lane and scalar
of every shard, the stats, the telemetry and the readbacks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

import test_torch_fleet as F
import test_torch_pipeline as TP
from __graft_entry__ import _example_ops
from fluidframework_tpu.parallel.fleet import DocFleet as RefFleet
from fluidframework_tpu.parallel.mesh import DocShard as RefShard
from fluidframework_tpu_torch.interop import (
    doc_shard_from_reference,
    fleet_from_reference,
    mesh_state_to_numpy,
)
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops.segment_state import (
    SEGMENT_LANES,
    SegmentState,
    materialize,
)
from fluidframework_tpu_torch.parallel import mesh as M
from fluidframework_tpu_torch.parallel.fleet import _SCALARS, DocFleet
from fluidframework_tpu_torch.protocol.constants import OP_WIDTH

N_DEV = 8


def ref_mesh(axis="docs"):
    return RefMesh(np.array(jax.devices()[:N_DEV]), (axis,))


def port_mesh(axis="docs"):
    return M.Mesh(["cpu"] * N_DEV, axis)


@pytest.fixture(autouse=True)
def _cpu_device_list():
    """The port's device list: eight CPU entries (the reference's eight
    virtual devices), restored after each test."""
    M.set_devices(["cpu"] * N_DEV)
    yield
    M.set_devices(None)


def _fields_equal(want, got, what=""):
    for f, a, b in zip(SegmentState._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{what} {f}")


def _ref_shards(arr):
    """A reference global array's per-device blocks, in mesh order."""
    shards = sorted(arr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in shards]


# -- the device list -------------------------------------------------------------


def test_device_list_and_mesh(monkeypatch):
    assert M.devices() == [torch.device("cpu")] * N_DEV
    mesh = M.make_mesh()
    assert mesh.size == N_DEV and mesh.axis == "docs"
    assert M.make_mesh(2, axis="seg") == M.Mesh(["cpu", "cpu"], "seg")
    assert mesh.groups() == [(torch.device("cpu"), list(range(N_DEV)))]
    M.set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.Mesh(["cuda"])
    with pytest.raises(ValueError, match="at least one"):
        M.Mesh([])


def test_shard_state_ops_and_apply_and_stats():
    """shard_state / shard_ops split contiguously; apply_and_stats equals
    the reference's XLA apply_and_stats over the whole batch."""
    from fluidframework_tpu.ops.segment_state import make_batched_state
    from fluidframework_tpu.parallel.mesh import (
        apply_and_stats as ref_apply_and_stats,
    )
    from fluidframework_tpu_torch.parallel.fleet import _blank_packed

    mesh = port_mesh()
    t, s = _blank_packed(16, 32, "cpu")
    parts = M.shard_state(t, s, mesh)
    assert [p[0].shape for p in parts] == [(15, 2, 32)] * N_DEV
    ops = _example_ops(16, 8)
    ops[3:5, 2:] = 0  # two documents with a shorter batch
    stats = M.apply_and_stats(parts, M.shard_ops(ops, mesh))
    ref_state, ref_stats = ref_apply_and_stats(
        make_batched_state(16, 32, int(s[0, 3])), ops)
    assert {k: int(v) for k, v in stats.items()} == \
        {k: int(v) for k, v in ref_stats.items()}
    got = M.gather_parts(parts, mesh.first)
    _fields_equal(ref_state, M.unpack_state(*got))
    with pytest.raises(ValueError, match="evenly"):
        M.shard_ops(ops[:12], M.Mesh(["cpu"] * 5))


# -- DocShard -----------------------------------------------------------------------


class ShardPair:
    """A reference DocShard (``backend``) and the port's, in lockstep."""

    def __init__(self, n_docs, capacity, backend="xla"):
        self.ref = RefShard(n_docs=n_docs, capacity=capacity,
                            mesh=ref_mesh(), backend=backend)
        self.port = M.DocShard(n_docs, capacity, mesh=port_mesh())
        self.check()

    def ref_state(self):
        return self.ref.unpacked_state()

    def check(self):
        want = self.ref_state()
        _fields_equal(want, self.port.unpacked_state())
        _fields_equal(want, mesh_state_to_numpy(self.port))
        # Shard i of the port holds the reference's block on device i.
        for lane, got in zip(SegmentState._fields[:15],
                             zip(*[p[0] for p in self.port.parts])):
            for blk, part in zip(_ref_shards(getattr(want, lane)), got):
                np.testing.assert_array_equal(blk, part.numpy())
        np.testing.assert_array_equal(self.ref.telemetry_slice(),
                                      self.port.telemetry_slice())
        docs = [0, 5, self.port.n_docs - 1]
        want_s, got_s = self.ref.doc_states(docs), self.port.doc_states(docs)
        for d in docs:
            _fields_equal(want_s[d], got_s[d], f"doc {d}")

    def apply(self, ops):
        want = {k: int(v) for k, v in self.ref.apply(ops).items()}
        got = {k: int(v) for k, v in self.port.apply(ops).items()}
        assert want == got
        self.check()
        return got

    def compact(self):
        self.ref.compact()
        self.port.compact()
        self.check()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_docshard_matches_reference(backend):
    """Both reference backends (pinned equal by tests/test_sharding.py)."""
    p = ShardPair(16, 64, backend)
    rng = np.random.default_rng(3)
    tr = F.Traffic(16, seed=3, msn_lag=4, insert_bias=0.7)
    for step in range(3):
        busy = np.flatnonzero(rng.random(16) < 0.7)  # others idle
        stats = p.apply(tr.round(4, docs=busy))
        assert stats["docs_with_errors"] == 0
        p.compact()
    assert stats["max_seq"] == max(tr.seqs)


def test_docshard_single_doc_heterogeneous_and_compact():
    """tests/test_sharding.py's cases on the port, held to the reference:
    one stream on every doc equals the single-doc kernel, per-doc mixed
    streams, a compaction that keeps the text."""
    pay = {1: "hello", 2: "XY"}
    rows = [E.insert(0, 1, 5, seq=1, ref=0, client=0),
            E.insert(2, 2, 2, seq=2, ref=1, client=1),
            E.remove(1, 4, seq=3, ref=2, client=0, msn=2)]
    # The shapes of test_docshard_matches_reference (16 docs x 64 rows,
    # K 4), so the reference's compiled steps are reused.
    p = ShardPair(16, 64)
    ops = np.zeros((16, 4, OP_WIDTH), np.int32)
    ops[:, :3] = np.stack(rows)
    stats = p.apply(ops)
    assert stats["max_seq"] == 3 and stats["docs_with_errors"] == 0
    host = p.port.doc_states(range(16))
    assert {materialize(host[d], pay) for d in range(16)} == {"hllo"}
    p.compact()
    assert materialize(p.port.doc_states([7])[7], pay) == "hllo"

    p = ShardPair(16, 64)
    ops = np.zeros((16, 4, OP_WIDTH), np.int32)
    pay = {1: "aaaa", 2: "bb"}
    for d in range(16):
        ops[d, 0] = E.insert(0, 1, 4, seq=1, ref=0, client=0)
        ops[d, 1] = (E.insert(d % 4, 2, 2, seq=2, ref=1, client=1) if d % 2
                     else E.remove(0, 2, seq=2, ref=1, client=1))
    p.apply(ops)
    texts = [materialize(s, pay)
             for s in p.port.doc_states(range(16)).values()]
    assert texts[:4] == ["aa", "abbaaa", "aa", "aaabba"]


def test_docshard_arguments_and_handover():
    with pytest.raises(ValueError, match="divide evenly"):
        M.DocShard(12, 16, mesh=port_mesh())
    with pytest.raises(ValueError, match="CUDA"):
        M.DocShard(8, 16, mesh=port_mesh(), kernel="cuda")
    assert M.DocShard(16, 16).mesh == M.make_mesh()
    ref = RefShard(n_docs=16, capacity=32, mesh=ref_mesh())
    ops = _example_ops(16, 8)
    ref.apply(ops)
    port = doc_shard_from_reference(
        [np.asarray(x) for x in ref.state], port_mesh())
    p = ShardPair.__new__(ShardPair)
    p.ref, p.port = ref, port
    p.check()
    p.apply(np.roll(ops, 3, axis=0) * (np.arange(16) % 3 == 0)[:, None, None])
    p.compact()


# -- DocFleet(mesh=) ------------------------------------------------------------------


class MeshPair(F.Pair):
    """test_torch_fleet's Pair on meshes: the reference fleet over its
    eight virtual devices, the port's over eight CPU entries; besides the
    Pair's checks, every pool's every shard matches block for block."""

    def __init__(self, *args, kernel="xla", **kw):
        self.ref = RefFleet(*args, kernel=kernel, mesh=ref_mesh(), **kw)
        self.port = DocFleet(*args, mesh=port_mesh(), **kw)
        self.check()

    def check(self):
        super().check()
        for cap, rp in self.ref.pools.items():
            pp = self.port.pools[cap]
            assert len(pp.parts) == N_DEV
            st = rp.state
            for i, lane in enumerate(SEGMENT_LANES):
                for blk, part in zip(_ref_shards(getattr(st, lane)),
                                     pp.parts):
                    np.testing.assert_array_equal(blk, part[0][i].numpy())
            for j, s in enumerate(_SCALARS):
                for blk, part in zip(_ref_shards(getattr(st, s)), pp.parts):
                    np.testing.assert_array_equal(blk, part[1][:, j].numpy())


# The scenarios of test_torch_fleet that take a mesh-specific path:
# promotion (growth), demotion, eviction and restore, slot growth (a mesh
# pool re-splits), the overflow scan, the padding slot dropping per
# shard, and the staged dispatch with its compaction. The others run the
# same per-shard code and stay in test_torch_fleet without a mesh.
MESH_SCENARIOS = [F.growth, F.padding_drops, F.demotion, F.evict_restore,
                  F.add_doc_grows_slots, F.overflowing, F.staged_and_aot]


@pytest.mark.parametrize("scenario", MESH_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_mesh_fleet_matches_reference(scenario, monkeypatch):
    """DocFleet scenarios of tests/test_torch_fleet.py with the two
    fleets on meshes, in lockstep through MeshPair."""
    monkeypatch.setattr(F, "Pair", MeshPair)
    scenario("xla")


def test_mesh_fleet_handover_and_arguments():
    ref = RefFleet(4, 16, high_water=0.7, mesh=ref_mesh())
    tr = F.Traffic(4, seed=29, msn_lag=5)
    for _ in range(5):
        ref.apply(tr.round(2))
        ref.compact()
        ref.check_and_migrate()
    pools = {cap: (tuple(np.asarray(x) for x in pool.state),
                   pool.doc_of_slot, pool.slot_gen, pool._free)
             for cap, pool in ref.pools.items()}
    port = fleet_from_reference(
        pools, ref.placement, base_capacity=16, high_water=0.7,
        migrations=ref.migrations, mesh=port_mesh())
    p = MeshPair.__new__(MeshPair)
    p.ref, p.port = ref, port
    p.check()
    for _ in range(3):
        p.same("apply", tr.round(2))
        p.call("compact")
        p.same("check_and_migrate")
    with pytest.raises(TypeError, match="Mesh"):
        DocFleet(2, 8, mesh=ref_mesh())
    with pytest.raises(ValueError, match="power-of-two"):
        DocFleet(2, 8, mesh=M.Mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="first device"):
        DocFleet(2, 8, mesh=port_mesh(), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        DocFleet(2, 8, mesh=port_mesh(), kernel="cuda")


# -- PipelineFluidService(device_mesh=) -------------------------------------------------


class MeshPipe(TP.Pipe):
    """test_torch_pipeline's Pipe with ``device_mesh=``: the reference's
    eight virtual devices, the port's eight CPU entries."""

    def __init__(self, monkeypatch, device_kernel="xla", **kw):
        self.kernel = device_kernel
        monkeypatch.setattr(
            TP.ref_pipeline, "PipelineFluidService",
            _with(TP.ref_pipeline.PipelineFluidService,
                  device_mesh=ref_mesh(), device_kernel=device_kernel),
        )
        monkeypatch.setattr(
            TP.port_pipeline, "PipelineFluidService",
            _with(TP.port_pipeline.PipelineFluidService,
                  device_mesh=port_mesh()),
        )
        super().__init__(monkeypatch, **kw)

    def check(self):
        super().check()
        for side in ("ref", "port"):
            fleet = self.svc[side].device.fleet
            assert fleet.mesh is not None
        for cap, pp in self.svc["port"].device.fleet.pools.items():
            assert len(pp.parts) == N_DEV


def _with(cls, **fixed):
    """``cls`` with some keyword arguments fixed (over the caller's)."""
    def make(*args, **kw):
        return cls(*args, **{**kw, **fixed})
    return make


def _drive(p, n_docs, rounds, k=4):
    writers = [p.connect(f"m{i}") for i in range(n_docs)]
    for _ in range(rounds):
        TP._round(p, writers, n=k)
    p.same("flush_device")
    p.reads()
    return writers


@pytest.mark.parametrize("device_kernel", ["xla", "pallas"])
def test_pipeline_on_the_mesh(monkeypatch, device_kernel):
    """tests/test_mesh_pipeline.py's parity cases: 12 documents of k-op
    frames through deli into the mesh fleet, against both reference
    engines; every pool is split over the eight shards."""
    p = MeshPipe(monkeypatch, device_kernel=device_kernel,
                 n_partitions=2)
    _drive(p, 8 if device_kernel == "xla" else 4,
           rounds=2 if device_kernel == "xla" else 1)
    assert p.svc["port"].device.stats()["docs_with_errors"] == 0


def test_pipeline_mesh_promotion_keeps_the_placement(monkeypatch):
    """A document that outgrows the base tier promotes into a pool that
    is also split over the mesh, its text intact."""
    p = MeshPipe(monkeypatch, n_partitions=1, device_capacity=16)
    w = p.connect("grow")
    for _ in range(6):
        TP._round(p, [w], n=4)
        p.same("flush_device")
    fleet = p.svc["port"].device.fleet
    idx = p.svc["port"].device._index[("grow", "s")]
    cap, _slot = fleet.placement[idx]
    assert cap > 16
    assert [part[0].device for part in fleet.pools[cap].parts] == \
        list(port_mesh().devices)
    assert len(p.text("grow")) > 16
    p.reads()
