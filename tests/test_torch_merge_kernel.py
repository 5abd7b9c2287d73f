"""The port's client merge API against the reference's XLA functions.

``fluidframework_tpu_torch.ops.merge_kernel`` (``apply_op``, ``apply_ops``,
``jit_apply_ops``, ``batched_apply_ops``, ``compact``, ``batched_compact``)
runs K1/K2's plain versions on CPU states; each test feeds the same numpy
state and op rows to the reference's XLA functions
(``fluidframework_tpu.ops.merge_kernel``) and compares every int32 lane,
scalar and err bit exactly. The rest of ``ops/segment_state.py``
(``grow``, ``adopt_client_slot``, ``restamp_rows``, ``to_host``,
``materialize``) is held to the reference the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import encode as RE
from fluidframework_tpu.ops import merge_kernel as RM
from fluidframework_tpu.ops import segment_state as RS
from fluidframework_tpu.testing.fuzz import random_acked_stream
from fluidframework_tpu.testing.oracle import OracleDoc
from fluidframework_tpu_torch.interop import (
    segment_state_from_numpy,
    segment_state_to_numpy,
)
from fluidframework_tpu_torch.ops import merge_kernel as M
from fluidframework_tpu_torch.ops import segment_state as S
from fluidframework_tpu_torch.protocol.constants import (
    F_CLIENT,
    F_LSEQ,
    F_MSN,
    F_REF,
    F_SEQ,
    F_TYPE,
    NO_CLIENT,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
)

CPU = "cpu"
OP_KIND = {OP_INSERT: "insert", OP_REMOVE: "remove", OP_ANNOTATE: "annotate"}


def ref_arrays(state):
    return tuple(np.array(x, np.int32) for x in RS.to_host(state))


def same(port_state, ref, what=""):
    got = segment_state_to_numpy(port_state)
    want = ref_arrays(ref)
    for name, g, w in zip(RS.SegmentState._fields, got, want):
        assert g.shape == w.shape and np.array_equal(g, w), (
            f"{what}: field {name} differs: port {g.tolist()} "
            f"reference {w.tolist()}")


class Pair:
    """One client replica on both packages: a reference state and a port
    state fed the same op rows, with the same compaction and growth
    policy as the DDSes (compact when count passes cap - 8, grow x2 if
    compaction was not enough) plus compactions at random points."""

    def __init__(self, client: int, cap: int):
        self.client = client
        self.ref = RS.make_state(cap, client)
        self.port = S.make_interactive_state(cap, client, device=CPU)
        self.lseq = 0
        self.compactions = []
        self.grows = []

    def apply(self, row, step):
        self.ref = RM.jit_apply_ops(self.ref, row[None].astype(np.int32))
        self.port = M.jit_apply_ops(self.port, row[None])
        same(self.port, self.ref, f"client {self.client} step {step}")
        cap = RS.capacity_of(self.ref)
        assert S.capacity_of(self.port) == cap
        if int(RS.to_host(self.ref).count) > cap - 8:
            self.compact(step)
            if int(RS.to_host(self.ref).count) > cap - 8:
                self.ref = RS.grow(self.ref, cap * 2)
                self.port = S.grow(self.port, cap * 2)
                self.grows.append(step)
                same(self.port, self.ref, f"grow at step {step}")

    def compact(self, step):
        self.ref = RM.compact(self.ref)
        self.port = M.compact(self.port)
        self.compactions.append(step)
        same(self.port, self.ref, f"compact at step {step}")


def local_row(rng, pair, length, payloads, next_orig):
    """A random local (unacked) op against the replica's own text."""
    kind = int(rng.integers(0, 3)) if length > 0 else 0
    pair.lseq += 1
    common = dict(client=pair.client, lseq=pair.lseq)  # seq: UNASSIGNED
    if kind == 0:
        n = int(rng.integers(1, 5))
        payloads[next_orig] = "x" * n
        return RE.insert(int(rng.integers(0, length + 1)), next_orig, n,
                         **common)
    a = int(rng.integers(0, length))
    b = int(rng.integers(a + 1, min(length, a + 6) + 1))
    if kind == 1:
        return RE.remove(a, b, **common)
    return RE.annotate(a, b, int(rng.integers(1, 50)), **common)


@pytest.mark.parametrize("seed,cap", [(0, 16), (1, 64), (2, 16), (3, 128)])
def test_interactive_farm_with_pending_rows_and_compaction(seed, cap):
    """Three client replicas submit local ops (pending inserts, removes and
    annotates), a FIFO sequencer orders them with an advancing MSN, and
    every replica applies the sequenced stream (acks of its own ops,
    remote ops at their perspective). After every op each replica's port
    state equals its reference state; compaction runs whenever the table
    fills and at random points in between, on states full of pending rows;
    small tables make it grow past its first capacity."""
    rng = np.random.default_rng(seed)
    n = 3
    reps = [Pair(c, cap) for c in range(n)]
    payloads = {}
    next_orig = 1
    queue = []  # (sender, row) in submit order
    seq = 0
    step = 0
    pending_counts = 0
    for rnd in range(40):
        for p in reps:
            if rng.random() < 0.7:
                length = len(RS.materialize(p.ref, payloads))
                row = local_row(rng, p, length, payloads, next_orig)
                next_orig += 1
                p.apply(row, step)
                step += 1
                queue.append((p.client, row))
        h = RS.to_host(reps[0].ref)
        pending_counts += int((np.asarray(h.lseq) != 0).sum()
                              + (np.asarray(h.rlseq) != 0).sum()
                              + (np.asarray(h.alseq) != 0).sum())
        # Sequence part of the queue; the MSN trails the head.
        for _ in range(int(rng.integers(0, len(queue) + 1))):
            sender, row = queue.pop(0)
            seq += 1
            msn = max(0, seq - int(rng.integers(1, 6)))
            for p in reps:
                if p.client == sender:
                    out = RE.ack(OP_KIND[int(row[F_TYPE])], int(row[F_LSEQ]),
                                 seq, msn=msn)
                else:
                    out = row.copy()
                    out[F_SEQ] = seq
                    out[F_LSEQ] = 0
                    out[F_MSN] = msn
                    out[F_REF] = seq - 1 - int(rng.integers(0, 2))
                p.apply(out, step)
                step += 1
        for p in reps:
            if rng.random() < 0.25:
                p.compact(step)
    assert pending_counts > 0
    assert sum(len(p.compactions) for p in reps) > 0
    if cap == 16:
        assert sum(len(p.grows) for p in reps) > 0


@pytest.mark.parametrize("ty", [-1, 7, 100])
def test_unknown_op_types_match_xla(ty):
    """XLA ``apply_op`` clips the op type into [0, 6]: -1 runs as NOOP, 7
    and 100 as ACK_ANNOTATE. The port's ``apply_ops`` matches it (K1
    itself would change only the bookkeeping and ERR_CLIENT)."""
    payloads = {}
    track = OracleDoc(2)
    ops = random_acked_stream(np.random.default_rng(5), 12, payloads, track)
    # A pending local annotate, so an ACK_ANNOTATE-shaped row finds rows.
    ann = RE.annotate(0, 3, 9, client=2, lseq=1)
    ref = RM.apply_ops(RS.make_state(64, 2), np.stack(ops + [ann]))
    port = segment_state_from_numpy(ref_arrays(ref), CPU)
    bad = np.zeros((3, OP_WIDTH), np.int32)
    bad[:, F_TYPE] = ty
    bad[:, F_SEQ] = [20, 21, 22]
    bad[:, F_LSEQ] = 1
    bad[:, F_MSN] = [3, 4, 5]
    bad[2, F_CLIENT] = 400  # past MAX_WRITERS: ERR_CLIENT
    want = RM.apply_ops(ref, bad)
    got = M.apply_ops(port, bad)
    same(got, want, f"type {ty}")
    same(port, ref, "apply_ops leaves its input as it was")
    one = M.apply_op(port, bad[0])
    same(one, RM.apply_op(ref, jnp.asarray(bad[0])), f"apply_op type {ty}")


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_apply_and_compact_match_xla(seed):
    """``batched_apply_ops`` / ``jit_batched_apply_ops`` and
    ``batched_compact`` on 6 documents, acked streams with an MSN lag so
    compaction has tombstones to reclaim, and ranges past the text."""
    rng = np.random.default_rng(seed)
    d, k, cap = 6, 24, 96
    ops = np.zeros((d, k, OP_WIDTH), np.int32)
    for i in range(d):
        payloads = {}
        ops[i] = np.stack(random_acked_stream(
            rng, k, payloads, OracleDoc(NO_CLIENT), msn_lag=4))
    ref = RS.make_batched_state(d, cap, NO_CLIENT)
    port = segment_state_from_numpy(ref_arrays(ref), CPU)
    for half in (ops[:, : k // 2], ops[:, k // 2:]):
        want = RM.batched_apply_ops(ref, jnp.asarray(half))
        got = M.batched_apply_ops(port, half)
        same(got, want, "batched_apply_ops")
        same(port, ref, "batched_apply_ops leaves its input as it was")
        ref = RM.jit_batched_apply_ops(ref, jnp.asarray(half))
        port = M.jit_batched_apply_ops(port, torch.from_numpy(half))
        same(port, ref, "jit_batched_apply_ops")
        ref = RM.batched_compact(ref)
        port = M.batched_compact(port)
        same(port, ref, "batched_compact")


def test_overflow_and_range_errors_match_xla():
    """A table too small for the stream sets ERR_CAPACITY and drops the
    op; a remove past the text sets ERR_RANGE — as XLA does."""
    payloads = {}
    ops = random_acked_stream(np.random.default_rng(9), 20, payloads,
                              OracleDoc(NO_CLIENT))
    ops.append(RE.remove(0, 500, seq=21, ref=20, client=1))
    ref = RS.make_state(8, NO_CLIENT)
    port = S.make_interactive_state(8, NO_CLIENT, device=CPU)
    for op in ops:
        ref = RM.jit_apply_ops(ref, op[None])
        port = M.jit_apply_ops(port, op[None])
        same(port, ref)
    assert int(port.err) & 1 and int(port.err) & 2


@pytest.mark.parametrize("cap,new", [(1024, 2048), (2048, 4096),
                                     (8192, 16384), (16384, 32768)])
def test_grow_across_tier_edges(cap, new):
    """``grow`` across the shared (2,048) and cluster (16,384) tier edges:
    lanes, scalars and the new free rows equal the reference's, the state
    stays packed, and the next op applies the same on both."""
    payloads = {}
    ops = random_acked_stream(np.random.default_rng(cap), 12, payloads,
                              OracleDoc(4), msn_lag=3)
    ref = RM.apply_ops(RS.make_state(cap, 4), np.stack(ops))
    port = segment_state_from_numpy(ref_arrays(ref), CPU)
    ref, port = RS.grow(ref, new), S.grow(port, new)
    same(port, ref, f"grow {cap} -> {new}")
    assert S.packed_of(port) is not None
    op = RE.insert(1, 999, 3, seq=13, ref=12, client=1)
    payloads[999] = "new"
    ref = RM.jit_apply_ops(ref, op[None])
    port = M.jit_apply_ops(port, op[None])
    same(port, ref, "op after grow")
    assert S.materialize(port, payloads) == RS.materialize(ref, payloads)


@pytest.mark.parametrize("new_client", [5, 40, 70])
def test_adopt_client_slot_and_restamp_rows(new_client):
    """After pending local inserts and removes, adopting a slot in each
    removers lane (0-30, 31-61, 62-92) restamps the same rows; restamping
    one lane on listed rows (one value or one per row) equals the
    reference's host restamp."""
    payloads = {}
    ops = random_acked_stream(np.random.default_rng(new_client), 10,
                              payloads, OracleDoc(3))
    old = 33 if new_client == 5 else 3
    local = [
        RE.insert(2, 500, 4, client=old, lseq=1),
        RE.remove(0, 3, client=old, lseq=2),
        RE.annotate(1, 5, 7, client=old, lseq=3),
    ]
    ref = RM.apply_ops(RS.make_state(64, old), np.stack(ops + local))
    port = segment_state_from_numpy(ref_arrays(ref), CPU)
    ref = RS.adopt_client_slot(ref, new_client)
    port = S.adopt_client_slot(port, new_client)
    same(port, ref, "adopt_client_slot")
    assert S.packed_of(port) is not None
    rows = [0, 2, 3]
    ref = RS.restamp_rows(ref, "lseq", rows, 9)
    port = S.restamp_rows(port, "lseq", rows, 9)
    same(port, ref, "restamp_rows")
    offs = np.asarray(ref.off).copy()
    offs[rows] = [4, 5, 6]
    ref = ref._replace(off=jnp.asarray(offs))
    port = S.restamp_rows(port, "off", rows, [4, 5, 6])
    same(port, ref, "restamp_rows, one value per row")


def test_removed_by_slot_host_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        bits = [int(rng.integers(0, 1 << 31)) for _ in range(3)]
        c = int(rng.integers(-3, 100))
        assert S.removed_by_slot_host(*bits, c) == \
            RS.removed_by_slot_host(*bits, c)


def test_to_host_is_one_copy_and_materialize_matches():
    """``to_host`` of a packed state copies (no aliasing) and gives the
    reference's fields; ``materialize`` the reference's text."""
    payloads = {}
    ops = random_acked_stream(np.random.default_rng(11), 30, payloads,
                              OracleDoc(NO_CLIENT), msn_lag=5)
    ref = RM.apply_ops(RS.make_state(128, NO_CLIENT), np.stack(ops))
    port = segment_state_from_numpy(ref_arrays(ref), CPU)
    h = S.to_host(port)
    h.kind[:] = 99
    same(port, ref)
    assert S.materialize(port, payloads) == RS.materialize(ref, payloads)
    assert S.to_packed(port)[0].data_ptr() == S.packed_of(port)[0].data_ptr()


def test_make_interactive_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        S.make_interactive_state(16, 0)
