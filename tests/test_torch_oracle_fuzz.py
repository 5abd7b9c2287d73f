"""Parity: the port's merge oracle (``testing/oracle.py`` ``OracleDoc``)
and fuzz streams (``testing/fuzz.py`` ``random_acked_stream``) against
the reference's, and the farm of tests/test_fuzz_convergence.py on both
packages.

- ``random_acked_stream`` draws the same rows (byte for byte), payloads
  and oracle evolution as the reference's for the same generator state.
- The farm: N clients submit random local ops to their own replica (a
  merge state + an oracle), a FIFO sequencer orders them, every replica
  and a server replica apply the sequenced stream with acks. The
  reference runs its XLA kernel with its oracle, the port K1/K2's plain
  versions on CPU states with its oracle; every random choice is drawn
  once (from the reference's oracle) and applied to both. Texts, oracle
  structures and every lane of every replica must agree across the
  packages, and the replicas must converge as the reference's do.
- ``device_state_parity`` (bench.py) at a small size: fuzz streams
  through the port's packed K1/K2 (apply half, compact, apply half,
  compact) equal every document's oracle text and the reference's
  lanes, with every err lane clear.
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import encode as RE
from fluidframework_tpu.ops import merge_kernel as RM
from fluidframework_tpu.ops import segment_state as RS
from fluidframework_tpu.testing import fuzz as ref_fuzz
from fluidframework_tpu.testing import oracle as ref_oracle
from fluidframework_tpu_torch.interop import segment_state_to_numpy
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import compact_kernel as K2
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops import merge_kernel as M
from fluidframework_tpu_torch.ops import segment_state as S
from fluidframework_tpu_torch.protocol.constants import (
    F_LSEQ,
    F_SEQ,
    F_TYPE,
    KIND_FREE,
    NO_CLIENT,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.testing import fuzz, oracle

CAP = 512
ALPHABET = "abcdefghijklmnopqrstuvwxyz"
OP_KIND = {OP_INSERT: "insert", OP_REMOVE: "remove", OP_ANNOTATE: "annotate"}


def ref_lanes(state) -> tuple:
    return tuple(np.array(x, np.int32) for x in RS.to_host(state))


def same_lanes(port_state, ref_state, what):
    for name, g, w in zip(RS.SegmentState._fields,
                          segment_state_to_numpy(port_state),
                          ref_lanes(ref_state)):
        assert g.shape == w.shape and np.array_equal(g, w), (
            f"{what}: lane {name}")


# -- the generator --------------------------------------------------------------


@pytest.mark.parametrize("seed,n_ops,msn_lag,caught_up,seq0", [
    (0, 200, None, False, 1),
    (1, 200, 24, False, 1),
    (2, 160, 24, True, 1),  # the bench's and the smoke's stream shape
    (3, 120, 8, True, 57),
    (4, 300, 3, False, 1),
])
def test_random_acked_stream_is_the_references(seed, n_ops, msn_lag,
                                               caught_up, seq0):
    """Rows byte for byte, payloads and the tracking oracles after the
    stream, with one payload table carried across two streams."""
    outs = {}
    for side, (gen, orc) in {"ref": (ref_fuzz, ref_oracle),
                             "port": (fuzz, oracle)}.items():
        rng = np.random.default_rng(seed)
        payloads = {}
        tracks = [orc.OracleDoc(NO_CLIENT), orc.OracleDoc(NO_CLIENT)]
        rows = [np.stack(gen.random_acked_stream(
            rng, n_ops, payloads, t, msn_lag=msn_lag, caught_up=caught_up,
            seq0=seq0)) for t in tracks]
        outs[side] = (rows, payloads, tracks)
    (rr, rp, rt), (pr, pp, pt) = outs["ref"], outs["port"]
    for a, b in zip(rr, pr):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert rp == pp
    for a, b in zip(rt, pt):
        assert a.struct() == b.struct()
        assert a.text(rp) == b.text(pp)
        assert (a.min_seq, a.cur_seq) == (b.min_seq, b.cur_seq)


def test_oracle_replays_a_stream_as_the_reference():
    """Every op of a mixed stream (inserts, removes, annotates, acks of
    local ops and noops) leaves both oracles with the same segments."""
    rng = np.random.default_rng(7)
    payloads = {}
    stream = ref_fuzz.random_acked_stream(
        rng, 150, payloads, ref_oracle.OracleDoc(NO_CLIENT), msn_lag=12)
    a, b = ref_oracle.OracleDoc(2), oracle.OracleDoc(2)
    for i, row in enumerate(stream):
        a.apply(row)
        b.apply(row)
        if i % 25 == 0:  # a local insert by the replica's own client, acked
            loc = RE.insert(0, 1, 1, seq=UNASSIGNED_SEQ, ref=int(row[F_SEQ]),
                            client=2, lseq=i + 1)
            ack = RE.ack("insert", i + 1, int(row[F_SEQ]))
            for o in (a, b):
                o.apply(loc)
                o.apply(ack)
        assert a.struct() == b.struct(), i
    assert b.text(payloads) == a.text(payloads)
    noop = E.noop(msn=160, seq=160)
    a.apply(noop)
    b.apply(noop)
    assert (a.min_seq, a.cur_seq) == (b.min_seq, b.cur_seq) == (160, 160)


# -- the farm -----------------------------------------------------------------


class Replica:
    """One client on both packages: the reference's kernel state and
    oracle, the port's state (CPU, plain K1/K2) and oracle."""

    def __init__(self, client: int):
        self.client = client
        self.ref = RS.make_state(CAP, client)
        self.port = S.make_state(CAP, client, device="cpu")
        self.ref_o = ref_oracle.OracleDoc(client)
        self.port_o = oracle.OracleDoc(client)
        self.ref_seq = 0
        self.lseq = 0

    def _apply(self, row: np.ndarray):
        rows = row[None, :].astype(np.int32)
        self.ref = RM.jit_apply_ops(self.ref, rows)
        self.port = M.jit_apply_ops(self.port, rows)
        self.ref_o.apply(row)
        self.port_o.apply(row)

    def submit(self, row: np.ndarray) -> tuple:
        self.lseq += 1
        row = row.copy()
        row[F_LSEQ] = self.lseq
        self._apply(row)
        return (self.client, row)

    def deliver(self, seq: int, sender: int, row: np.ndarray):
        if sender == self.client:
            kind = OP_KIND[int(row[F_TYPE])]
            self._apply(E.ack(kind, int(row[F_LSEQ]), seq))
        else:
            srow = row.copy()
            srow[F_SEQ] = seq
            srow[F_LSEQ] = 0
            self._apply(srow)
        self.ref_seq = seq


def visible_struct(lanes) -> list:
    """The visible rows of a document (tombstone order may differ between
    replicas; tests/test_fuzz_convergence.py)."""
    h = RS.SegmentState(*lanes)
    rows = []
    for i in range(int(h.count)):
        if int(h.kind[i]) == KIND_FREE or int(h.rseq[i]) != RSEQ_NONE:
            continue
        rows.append((int(h.orig[i]), int(h.off[i]), int(h.length[i]),
                     int(h.seq[i]), int(h.client[i]), int(h.aval[i])))
    return rows


def gen_local_op(rng, rep: Replica, payloads, next_orig):
    length = len(rep.ref_o.text(payloads))
    choice = rng.integers(0, 3) if length > 0 else 0
    if choice == 0:
        n = int(rng.integers(1, 5))
        payloads[next_orig[0]] = "".join(rng.choice(list(ALPHABET), n))
        row = E.insert(int(rng.integers(0, length + 1)), next_orig[0], n,
                       seq=UNASSIGNED_SEQ, ref=rep.ref_seq, client=rep.client)
        next_orig[0] += 1
    elif choice == 1:
        a = int(rng.integers(0, length))
        b = int(rng.integers(a + 1, min(length, a + 8) + 1))
        row = E.remove(a, b, seq=UNASSIGNED_SEQ, ref=rep.ref_seq,
                       client=rep.client)
    else:
        a = int(rng.integers(0, length))
        b = int(rng.integers(a + 1, min(length, a + 8) + 1))
        row = E.annotate(a, b, int(rng.integers(1, 50)), seq=UNASSIGNED_SEQ,
                         ref=rep.ref_seq, client=rep.client)
    return row


@pytest.mark.parametrize("seed", range(10))
def test_farm_convergence(seed):
    rng = np.random.default_rng(seed)
    n_clients = 3 + seed % 3
    n_ops = 30
    reps = [Replica(c) for c in range(n_clients)]
    server = Replica(NO_CLIENT)
    payloads = {}
    next_orig = [1]
    raw_queue = []
    seq = 0
    sequenced = []
    submitted = 0

    def sequence_some(k):
        nonlocal seq
        for _ in range(min(k, len(raw_queue))):
            sender, row = raw_queue.pop(0)
            seq += 1
            srow = row.copy()
            srow[F_SEQ] = seq
            srow[F_LSEQ] = 0
            server._apply(srow)
            sequenced.append((seq, sender, row))

    while submitted < n_ops * n_clients:
        act = rng.integers(0, 3)
        rep = reps[int(rng.integers(0, n_clients))]
        if act == 0:
            raw_queue.append(
                rep.submit(gen_local_op(rng, rep, payloads, next_orig)))
            submitted += 1
        elif act == 1:
            sequence_some(int(rng.integers(1, 4)))
        else:
            delivered = [s for s, _, _ in sequenced if s <= rep.ref_seq]
            pending = sequenced[len(delivered):]
            for s, sender, row in pending[: int(rng.integers(1, 5))]:
                rep.deliver(s, sender, row)
        assert rep.port_o.struct() == rep.ref_o.struct()

    sequence_some(len(raw_queue))
    for rep in reps:
        for s, sender, row in sequenced:
            if s > rep.ref_seq:
                rep.deliver(s, sender, row)

    texts = [S.materialize(rep.port, payloads) for rep in reps]
    assert texts == [RS.materialize(rep.ref, payloads) for rep in reps]
    assert all(t == texts[0] for t in texts), f"client texts diverged: {texts}"
    assert S.materialize(server.port, payloads) == texts[0]
    assert server.port_o.text(payloads) == texts[0]
    for rep in reps + [server]:
        same_lanes(rep.port, rep.ref, f"client {rep.client}")
        assert rep.port_o.struct() == rep.ref_o.struct()
        assert int(S.to_host(rep.port).err) == 0
    structs = [visible_struct(segment_state_to_numpy(r.port))
               for r in reps + [server]]
    assert all(s == structs[0] for s in structs), "replica structures diverged"

    fin = np.stack([E.noop(msn=seq, seq=seq)]).astype(np.int32)
    for rep in reps:
        port = M.compact(M.jit_apply_ops(rep.port, fin))
        ref = RM.compact(RM.jit_apply_ops(rep.ref, fin))
        assert S.materialize(port, payloads) == texts[0]
        same_lanes(port, ref, f"compacted client {rep.client}")


# -- device_state_parity at a small size ------------------------------------------


def fuzz_batch(gen, orc, n_docs, n_ops, seed0=1000):
    """bench.py's streams: one ``random_acked_stream`` (msn lag 24,
    caught up) a document, one shared payload table."""
    payloads = {}
    oracles = [orc.OracleDoc(NO_CLIENT) for _ in range(n_docs)]
    batch = np.stack([np.stack(gen.random_acked_stream(
        np.random.default_rng(seed0 + d), n_ops, payloads, oracles[d],
        msn_lag=24, caught_up=True)) for d in range(n_docs)]).astype(np.int32)
    return batch, payloads, oracles


@pytest.mark.parametrize("n_docs,cap,n_ops", [(8, 256, 96), (3, 128, 64)])
def test_state_parity_through_the_packed_kernels(n_docs, cap, n_ops):
    batch, payloads, oracles = fuzz_batch(fuzz, oracle, n_docs, n_ops)
    rbatch, rpayloads, roracles = fuzz_batch(ref_fuzz, ref_oracle, n_docs,
                                             n_ops)
    assert batch.tobytes() == rbatch.tobytes() and payloads == rpayloads
    st = S.make_batched_state(n_docs, cap, NO_CLIENT, device="cpu")
    t, s, _ = S.to_packed(st)
    ops = torch.from_numpy(batch)
    half = n_ops // 2
    K1.apply_ops_packed(t, s, ops[:, :half].contiguous())
    K2.compact_packed(t, s)
    K1.apply_ops_packed(t, s, ops[:, half:].contiguous())
    K2.compact_packed(t, s)
    port = S.packed_views(t, s, False)
    ref = RS.make_batched_state(n_docs, cap, NO_CLIENT)
    ref = RM.jit_batched_apply_ops(ref, batch[:, :half])
    ref = RM.batched_compact(ref)
    ref = RM.jit_batched_apply_ops(ref, batch[:, half:])
    ref = RM.batched_compact(ref)
    same_lanes(port, ref, "packed state")
    host = S.to_host(port)
    assert int((host.err != 0).sum()) == 0
    for d in range(n_docs):
        one = S.SegmentState(*[np.asarray(x)[d] for x in host])
        assert S.materialize(one, payloads) == oracles[d].text(payloads)
        assert oracles[d].struct() == roracles[d].struct()
