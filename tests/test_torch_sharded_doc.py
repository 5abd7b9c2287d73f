"""Parity: the port's ``ShardedDoc`` (one document over eight CPU entries
of the device list, plain PyTorch kernels) against the JAX reference's
over its eight virtual devices, op for op, and the sharded overflow of
the serving stage (``DeviceFleetBackend(sharded_overflow=True)``, and
``PipelineFluidService(device_sharded_overflow=True)`` under a
``SharedString`` on each package's own container runtime).

Every shard's 15 lanes and 5 scalars must agree after every op (int32,
tolerance 0), as must the err lanes, the single-table view and its text.
The fuzz streams mix unknown op types (-1, 7, 100), writers at or past
MAX_WRITERS, local (unsequenced) inserts and removes with their acks,
and positions past the document's end.
"""

import numpy as np
import pytest

import test_torch_device_backend as DB
from fluidframework_tpu.models.shared_string import SharedString as RefString
from fluidframework_tpu.ops import encode as RE
from fluidframework_tpu.ops.merge_kernel import jit_apply_ops as ref_apply
from fluidframework_tpu.ops.segment_state import make_state as ref_make_state
from fluidframework_tpu.ops.segment_state import materialize as ref_mat
from fluidframework_tpu.parallel.sharded_doc import ShardedDoc as RefDoc
from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service.pipeline import (
    PipelineFluidService as RefPipe,
)
from fluidframework_tpu.testing.fuzz import random_acked_stream
from fluidframework_tpu.testing.oracle import OracleDoc
from fluidframework_tpu_torch.interop import (
    mesh_state_to_numpy,
    sharded_doc_from_reference,
)
from fluidframework_tpu_torch.models.shared_string import (
    SharedString as PortString,
)
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops.segment_state import (
    SegmentState,
    materialize,
)
from fluidframework_tpu_torch.parallel import mesh as M
from fluidframework_tpu_torch.parallel.sharded_doc import ShardedDoc
from fluidframework_tpu_torch.protocol.constants import (
    ERR_CLIENT,
    ERR_RANGE,
    F_MSN,
    F_TYPE,
    MAX_WRITERS,
    NO_CLIENT,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.runtime.container import (
    ContainerRuntime as PortRT,
)
from fluidframework_tpu_torch.service.pipeline import (
    PipelineFluidService as PortPipe,
)
from fluidframework_tpu_torch.service.server_main import (
    build_server,
    load_config,
)

N_DEV = 8


@pytest.fixture(autouse=True)
def _cpu_device_list():
    """The port's device list: eight CPU entries (the reference's eight
    virtual devices), restored after each test."""
    M.set_devices(["cpu"] * N_DEV)
    yield
    M.set_devices(None)


class DocPair:
    """A reference ShardedDoc and the port's, in lockstep."""

    def __init__(self, shard_cap, base=None, self_client=NO_CLIENT):
        self.ref = RefDoc(shard_cap=shard_cap, self_client=self_client)
        self.port = ShardedDoc(shard_cap, self_client=self_client)
        assert self.port.n_shards == self.ref.n_shards == N_DEV
        if base is not None:
            self.ref.load_single(base)
            self.port.load_single(SegmentState(*[np.asarray(x)
                                                 for x in base]))
        self.check()

    def check(self):
        want = [np.asarray(x) for x in self.ref.state]
        for f, a, b in zip(SegmentState._fields, want,
                           mesh_state_to_numpy(self.port)):
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert self.ref.err == self.port.err
        assert self.ref.rows_in_use() == self.port.rows_in_use()

    def apply(self, rows, each=True):
        """rows [K, OP_WIDTH]; one op at a time (checked after each) or
        the batch in one call."""
        rows = np.asarray(rows, np.int32)
        for part in (rows[i:i + 1] for i in range(len(rows))) if each \
                else [rows]:
            self.ref.apply(part)
            self.port.apply(part)
            self.check()

    def call(self, name, *args):
        want = getattr(self.ref, name)(*args)
        got = getattr(self.port, name)(*args)
        assert want == got, (name, want, got)
        self.check()
        return got

    def single(self):
        want, got = self.ref.to_single(), self.port.to_single()
        for f, a, b in zip(SegmentState._fields, want, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
        return got


def baseline_doc(n_rows, payloads):
    """A single-table reference doc of n_rows acked inserts."""
    rows = []
    for i in range(n_rows):
        payloads[100 + i] = chr(97 + i % 26) * 3
        rows.append(RE.insert(3 * i, 100 + i, 3, seq=i + 1, ref=i, client=0))
    return ref_apply(ref_make_state(256, NO_CLIENT), np.stack(rows)), n_rows + 1


def _oracle(base):
    track = OracleDoc(NO_CLIENT)
    h = [np.asarray(x) for x in base]
    for i in range(int(h[15])):
        track.apply(RE.insert(3 * i, int(h[1][i]), 3, seq=i + 1, ref=i,
                              client=0))
    return track


@pytest.mark.parametrize("seed", range(4))
def test_sharded_matches_reference(seed):
    """tests/test_sharded_doc.py's stream on a loaded baseline, op for op,
    then compaction and the single-table view against the single-device
    reference kernel and the oracle."""
    rng = np.random.default_rng(seed + 100)
    payloads = {}
    base, next_seq = baseline_doc(24, payloads)  # 3 rows per shard
    p = DocPair(64, base)
    track = _oracle(base)
    stream = np.stack(random_acked_stream(
        rng, 40, payloads, track, caught_up=True, seq0=next_seq)).astype(
            np.int32)
    p.apply(stream)
    assert p.port.err == 0
    got = materialize(p.single(), payloads)
    assert got == ref_mat(ref_apply(base, stream), payloads)
    assert got == track.text(payloads)
    p.call("compact")


def test_rows_distributed_and_cross_shard_ranges():
    """An insert mid-document lands on its owner shard only; a remove and
    an annotate that span shards clamp into each; ERR_RANGE fires in
    global coordinates."""
    payloads = {999: "ZZ", 998: "!!"}
    base, s = baseline_doc(24, payloads)
    p = DocPair(64, base)
    counts = p.port.state.count.copy()
    assert (counts > 0).all()
    p.apply([E.insert(60, 999, 2, seq=s, ref=s - 1, client=1)])
    changed = np.flatnonzero(p.port.state.count - counts)
    assert len(changed) == 1 and changed[0] != 0
    p.apply([E.remove(10, 50, seq=s + 1, ref=s, client=2),
             E.annotate(0, 20, 7, seq=s + 2, ref=s + 1, client=1)])
    assert p.port.err == 0
    assert "ZZ" in materialize(p.single(), payloads)
    p.apply([E.remove(10, 500, seq=s + 3, ref=s + 2, client=0),
             E.insert(400, 998, 2, seq=s + 4, ref=s + 3, client=1)])
    assert p.port.err & ERR_RANGE
    assert materialize(p.single(), payloads).endswith("!!")


def test_empty_doc_and_long_lived_zamboni():
    """A document grown from nothing; then a long insert/remove stream
    with a trailing collab window, compacted and rebalanced every round,
    stays bounded."""
    payloads = {1: "hello", 2: "XY"}
    p = DocPair(32)
    p.apply([E.insert(0, 1, 5, seq=1, ref=0, client=0),
             E.insert(2, 2, 2, seq=2, ref=1, client=1),
             E.remove(1, 3, seq=3, ref=2, client=0)])
    assert materialize(p.single(), payloads) == "hYllo"

    payloads = {}
    p = DocPair(64)
    track = OracleDoc(NO_CLIENT)
    rng = np.random.default_rng(5)
    seq0, peaks = 1, []
    for _round in range(8):
        stream = np.stack(random_acked_stream(
            rng, 24, payloads, track, msn_lag=8, caught_up=True,
            seq0=seq0)).astype(np.int32)
        seq0 += len(stream)
        stream[-1, F_MSN] = seq0 - 1
        p.apply(stream, each=False)
        p.call("compact")
        p.call("rebalance")
        assert p.port.err == 0
        peaks.append(p.port.rows_in_use())
    assert max(peaks) < 40, peaks
    assert materialize(p.single(), payloads) == track.text(payloads)


def test_rebalance_evens_a_hot_shard():
    payloads = {}
    base, s = baseline_doc(24, payloads)
    p = DocPair(64, base)
    rows = []
    for i in range(40):  # all land on the shard owning position 36
        payloads[2000 + i] = "q"
        rows.append(E.insert(36, 2000 + i, 1, seq=s + i, ref=s + i - 1,
                             client=1))
    p.apply(rows, each=False)
    before = p.port.state.count.copy()
    text = materialize(p.single(), payloads)
    assert p.call("rebalance", 0.5)
    after = p.port.state.count
    assert after.max() < before.max()
    assert after.max() <= -(-int(after.sum()) // N_DEV)
    assert materialize(p.single(), payloads) == text
    assert not p.call("rebalance", 0.9)


def _fuzz_rows(rng, n, seq0, length):
    """Mixed rows: inserts (some local, acked later), removes, annotates,
    noops, acks, unknown types, writers past MAX_WRITERS, positions past
    the end."""
    rows, pending, seq = [], [], seq0
    for _ in range(n):
        r = rng.random()
        client = int(rng.choice([0, 1, 2, MAX_WRITERS - 1, MAX_WRITERS,
                                 MAX_WRITERS + 3])) if rng.random() < 0.15 \
            else int(rng.integers(0, 4))
        pos = int(rng.integers(0, length + 3))
        if r < 0.45:
            local = rng.random() < 0.2
            lseq = seq + 1000
            rows.append(E.insert(pos, int(rng.integers(1, 9)),
                                 int(rng.integers(1, 4)),
                                 seq=UNASSIGNED_SEQ if local else seq,
                                 ref=seq - 1, client=client, lseq=lseq,
                                 msn=max(0, seq - 6)))
            if local:
                pending.append(("insert", lseq))
            length += 2
        elif r < 0.6:
            b = pos + int(rng.integers(1, 4))
            local = rng.random() < 0.2
            rows.append(E.remove(pos, b, seq=UNASSIGNED_SEQ if local else seq,
                                 ref=seq - 1, client=client, lseq=seq + 1000,
                                 msn=max(0, seq - 6)))
            if local:
                pending.append(("remove", seq + 1000))
        elif r < 0.7:
            rows.append(E.annotate(pos, pos + 2, int(rng.integers(1, 5)),
                                   seq=seq, ref=seq - 1, client=client))
        elif r < 0.8 and pending:
            kind, lseq = pending.pop(0)
            rows.append(E.ack(kind, lseq=lseq, seq=seq, msn=max(0, seq - 6)))
        elif r < 0.9:
            row = E.insert(pos, 3, 1, seq=seq, ref=seq - 1, client=client)
            row[F_TYPE] = int(rng.choice([-1, 7, 100]))
            rows.append(row)
        else:
            rows.append(E.noop(seq=seq, msn=max(0, seq - 4)))
        seq += 1
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_mixed_streams(seed):
    """Seeded mixed streams (unknown types, wide writers, local ops and
    acks, out-of-range positions) op for op on a loaded baseline, a
    self-client document, then compaction and rebalance."""
    rng = np.random.default_rng(seed)
    payloads = {}
    base, s = baseline_doc(16, payloads)
    p = DocPair(48, base, self_client=int(seed % 3))
    p.apply(_fuzz_rows(rng, 48, s, 48))
    p.call("compact")
    p.call("rebalance", 0.3)
    p.single()
    assert p.port.err & (ERR_CLIENT | ERR_RANGE)


def test_handover_and_arguments():
    """A reference ShardedDoc handed over mid-stream continues bit for
    bit; kernel='cuda' needs cards; the CPU has no shard cap."""
    payloads = {}
    base, s = baseline_doc(24, payloads)
    ref = RefDoc(shard_cap=64)
    ref.load_single(base)
    rows = _fuzz_rows(np.random.default_rng(9), 24, s, 72)
    ref.apply(rows[:12])
    p = DocPair.__new__(DocPair)
    p.ref = ref
    p.port = sharded_doc_from_reference(
        [np.asarray(x) for x in ref.state], M.make_mesh(axis="seg"))
    p.check()
    p.apply(rows[12:])
    clone = p.port.clone(kernel="plain")
    assert clone.kernel == "plain" and clone.rows_in_use() == \
        p.port.rows_in_use()
    with pytest.raises(ValueError, match="CUDA"):
        ShardedDoc(16, kernel="cuda")
    assert ShardedDoc(70000).shard_cap == 70000  # no cap on the CPU
    with pytest.raises(ValueError, match="too large"):
        ShardedDoc(1).load_single(p.single())


# -- the serving stage's sharded overflow ---------------------------------------


class OverflowPair(DB.Pair):
    """test_torch_device_backend's Pair with ``sharded_overflow=True``;
    also compares every sharded document shard for shard."""

    def check(self):
        super().check()
        ref, port = self.ref._sharded, self.port._sharded
        assert sorted(ref) == sorted(port)
        for idx in ref:
            want = [np.asarray(x) for x in ref[idx].state]
            for f, a, b in zip(SegmentState._fields, want,
                               mesh_state_to_numpy(port[idx])):
                np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("pump", DB.MODES)
def test_backend_overflow_stats_telemetry_and_reads(pump):
    """Documents outgrow a 16-row top tier and re-home into ShardedDocs
    (8 x 16 rows) through the lambdas; stats, the telemetry's ``sharded``
    row, doc_states, text and summaries equal the reference's."""
    p = OverflowPair(capacity=8, max_capacity=16, sharded_overflow=True,
                     pump_mode=pump, feed_deadline_ms=0.0)
    ops = DB.Ops(seed=21, remove_p=0.2, msn_lag=6)
    for r in range(10):
        for d in ("a", "b", "c"):
            if d != "c" or r < 3:
                p.frame(d, ops, *ops.advance(d, 3))
        p.same("flush")
    p.same("collect_now")
    assert len(p.port._sharded) == 2
    st = p.port.stats()
    assert st["sharded_docs"] == 2 and st["docs_with_errors"] == 0
    assert st["sharded_rows"] > 32
    assert p.port.telemetry()["shards"]["sharded"].shape == (N_DEV, 9)
    p.reads()
    DB._texts(p, ops)


def _runtime_pair(n_writes, burst=False):
    """A SharedString over each package's PipelineFluidService with an
    8-row top tier and sharded overflow; the same inserts on both."""
    svc = {"ref": RefPipe(n_partitions=2, device_capacity=8,
                          device_max_capacity=8,
                          device_sharded_overflow=True),
           "port": PortPipe(n_partitions=2, device_capacity=8,
                            device_max_capacity=8,
                            device_sharded_overflow=True,
                            device_torch="cpu")}
    rts = {"ref": RefRT(svc["ref"], "doc", channels=(RefString("s"),)),
           "port": PortRT(svc["port"], "doc",
                          channels=(PortString("s", device="cpu"),))}
    nacks = {k: [] for k in rts}
    for k, rt in rts.items():
        rt.connection.on_nack = nacks[k].append
    for i in range(n_writes):
        for rt in rts.values():
            rt.get_channel("s").insert_text(0, chr(ord("a") + i % 26))
            if not burst:
                rt.flush()
                rt.process_incoming()
    for rt in rts.values():
        rt.flush()
        rt.process_incoming()
    return svc, rts, nacks


def _same_service(svc, rts):
    st = {k: s.device.stats() for k, s in svc.items()}
    for s in st.values():
        s["residency"].pop("wake_p99_ms")
    assert st["port"].pop("promotions_refused") == 0  # the port's own
    assert st["ref"] == st["port"]
    texts = {k: s.device_text("doc", "s") for k, s in svc.items()}
    assert texts["ref"] == texts["port"] == \
        rts["port"].get_channel("s").get_text()
    ref, port = svc["ref"].device._sharded, svc["port"].device._sharded
    for idx in ref:
        for f, a, b in zip(SegmentState._fields, ref[idx].state,
                           mesh_state_to_numpy(port[idx])):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
    return st["port"]


@pytest.mark.parametrize("burst", [False, True], ids=["per_op", "burst"])
def test_pipeline_overflow_under_a_shared_string(burst):
    """tests/test_sharded_doc.py's reachability cases: per-op writes far
    past the top tier, and one burst flush, promote into a ShardedDoc
    without a nack and keep serving."""
    svc, rts, nacks = _runtime_pair(14 if burst else 30, burst)
    assert nacks == {"ref": [], "port": []}
    st = _same_service(svc, rts)
    assert st["sharded_docs"] == 1 and st["docs_with_errors"] == 0
    for rt in rts.values():
        rt.get_channel("s").insert_text(5, "MORE")
        rt.flush()
        rt.process_incoming()
    _same_service(svc, rts)


def test_server_main_serves_sharded_overflow():
    """server_main's ``device_sharded_overflow`` key reaches the backend,
    and a channel past the top tier re-homes and serves."""
    cfg = load_config(overrides={"device_sharded_overflow": True,
                                 "device_capacity": 8,
                                 "device_max_capacity": 8,
                                 "device_flush_min_rows": 1})
    server = build_server(cfg, device_torch="cpu")
    svc = server.service
    assert svc.device.sharded_overflow
    rt = PortRT(svc, "doc", channels=(PortString("s", device="cpu"),))
    for i in range(20):
        rt.get_channel("s").insert_text(0, chr(97 + i))
        rt.flush()
        rt.process_incoming()
    assert svc.device.stats()["sharded_docs"] == 1
    assert svc.device_text("doc", "s") == rt.get_channel("s").get_text()
