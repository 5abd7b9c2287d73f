"""The sharded document's per-op exchange (X1 ``shard_stats``, X2
``shard_resolve`` and the two in one launch, ``shard_exchange``;
``ops/shard_exchange_kernel.py``) on the CPU.

- X1's plain version, one pass (the last eligible zero-length row against
  the last positive row), against the prefix form it replaces
  (``insert_place_mask`` at ``total - excl_cumsum(vis)``) on seeded random
  tables: zero-length tombstones at a shard's end, unassigned seqs,
  local-client and local (unsequenced) ops, shard lengths past 2**31.
- ``ShardedDoc`` on eight CPU entries of the device list against the JAX
  reference's ``ShardedDoc`` on its eight virtual devices, every lane and
  scalar after every op (int32, tolerance 0), on edge cases of the
  exchange: the tail at a shard boundary, inserts and ranges past the
  end, empty shards between live ones, every shard empty, a remove over
  three shards, ranges empty in some shards, unknown op types, a local
  client, rows with UNASSIGNED_SEQ, a global length past 2**31; and on
  two device groups with interleaved shards (the all_gather layout).
- The wrappers take the plain versions for CPU tensors and count no
  launch; ``ShardedDoc`` goes through them: one device group through
  ``shard_exchange``, two through X1 and X2.
- The bound the kernels' X1 reads by: every row at or past a document's
  (or shard's) count is free, in the reference's states and the port's,
  after each op of a fuzz stream, after compactions and grows, and in a
  sharded document after apply, compact, rebalance and load_single.

Inputs are made with numpy from a seed; the card's holds are in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from fluidframework_tpu.ops import merge_kernel as RMK
from fluidframework_tpu.ops import segment_state as RSS
from fluidframework_tpu.ops.segment_state import SegmentState as RefState
from fluidframework_tpu.parallel.sharded_doc import ShardedDoc as RefDoc
from fluidframework_tpu.testing.fuzz import random_acked_stream
from fluidframework_tpu.testing.oracle import OracleDoc
from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops import merge_kernel as MK
from fluidframework_tpu_torch.ops import segment_state as SS
from fluidframework_tpu_torch.ops import shard_exchange_kernel as SX
from fluidframework_tpu_torch.ops.apply_kernel import (
    N_LANES,
    N_SCALARS,
    SC_COUNT,
    SC_MIN_SEQ,
    SC_SELF,
)
from fluidframework_tpu_torch.ops.segment_state import (
    LANE_FILLS,
    SEGMENT_LANES,
)
from fluidframework_tpu_torch.parallel import mesh as M
from fluidframework_tpu_torch.parallel.sharded_doc import ShardedDoc
from fluidframework_tpu_torch.protocol.constants import (
    ERR_RANGE,
    F_CLIENT,
    F_REF,
    F_SEQ,
    F_TYPE,
    KIND_FREE,
    KIND_TEXT,
    NO_CLIENT,
    OP_WIDTH,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from test_torch_sharded_doc import DocPair, _fuzz_rows, baseline_doc

N_DEV = 8
LANE = {k: i for i, k in enumerate(SEGMENT_LANES)}


@pytest.fixture(autouse=True)
def _cpu_device_list():
    """The port's device list: eight CPU entries (the reference's eight
    virtual devices), restored after each test."""
    M.set_devices(["cpu"] * N_DEV)
    yield
    M.set_devices(None)


# -- X1: the one-pass tail against the prefix form ---------------------------


def prefix_stats(tables, scalars, op) -> torch.Tensor:
    """The form X1 replaces: the placement predicate at ``rem = total -
    excl_cumsum(vis)``, which needs a prefix scan over the shard."""
    def f(i):
        return op[i].reshape(1, 1)

    clientn = f(F_CLIENT)
    is_local = clientn == scalars[:, SC_SELF:SC_SELF + 1]
    part, vis = K1._perspective(tables, clientn, f(F_REF), is_local,
                                scalars[:, SC_MIN_SEQ:SC_MIN_SEQ + 1])
    total = vis.sum(1, keepdim=True).to(torch.int32)
    tail = K1.insert_place_mask(tables, f(F_SEQ), part, vis,
                                total - K1.excl_cumsum(vis)).any(1)
    return torch.stack([total[:, 0],
                        (scalars[:, SC_COUNT] > 0).to(torch.int32),
                        tail.to(torch.int32)], dim=1)


def random_group(rng, n_g, s, flavour):
    """A packed pair of ``n_g`` shards of ``s`` rows: live rows up to each
    shard's count (free rows past it), random stamps and removers, and by
    ``flavour``: ``"tail"`` zero-length tombstones at every shard's end,
    ``"unassigned"`` many rows with UNASSIGNED_SEQ, ``"wrap"`` lengths
    that add up to 0xB4000000-0xF0000000 a shard (visible lengths past
    2**31, below 2**32), ``"mixed"`` all of these in turn."""
    t = np.zeros((N_LANES, n_g, s), np.int32)
    for k, v in LANE_FILLS.items():
        t[LANE[k]] = v
    sc = np.zeros((n_g, N_SCALARS), np.int32)
    top = 40
    for d in range(n_g):
        fl = flavour if flavour != "mixed" else \
            ("tail", "unassigned", "wrap", "plain")[d % 4]
        count = int(rng.integers(0, min(s, 60) + 1)) if d % 5 else \
            min(s, 60)
        n = np.arange(count)
        t[LANE["kind"], d, :count] = KIND_TEXT
        t[LANE["orig"], d, :count] = 1 + n
        big = fl == "wrap"
        if big:  # the live rows' lengths add up to at most 0xF0000000
            per = min(0xF0000000 // max(count, 1), (1 << 31) - 1)
            length = rng.integers(per * 3 // 4, per + 1, count)
        else:
            length = rng.integers(0, 4, count)
        t[LANE["length"], d, :count] = length
        p_un = 0.5 if fl == "unassigned" else 0.1
        seq = rng.integers(1, top, count)
        seq[rng.random(count) < p_un] = UNASSIGNED_SEQ
        t[LANE["seq"], d, :count] = seq
        t[LANE["client"], d, :count] = rng.integers(0, 4, count)
        rseq = np.where(rng.random(count) < (0.1 if big else 0.4),
                        rng.integers(1, top, count), RSEQ_NONE)
        rseq[rng.random(count) < 0.05] = UNASSIGNED_SEQ
        if fl == "tail" and count:
            # The shard ends in tombstones: removed before any op's ref.
            k = int(rng.integers(1, min(count, 4) + 1))
            rseq[count - k:] = rng.integers(1, 6, k)
        t[LANE["rseq"], d, :count] = rseq
        removed = rseq != RSEQ_NONE
        for lane in ("rbits", "rbits2", "rbits3"):
            t[LANE[lane], d, :count] = np.where(
                removed, rng.integers(0, 1 << 8, count), 0)
        sc[d, SC_COUNT] = count
        sc[d, SC_MIN_SEQ] = int(rng.integers(0, 4))
        sc[d, SC_SELF] = int(rng.choice([NO_CLIENT, 0, 1, 2]))
    return torch.from_numpy(t), torch.from_numpy(sc)


def random_op(rng):
    """An insert row whose seq, ref and writer span the tables' stamps:
    unsequenced (local) ops, writers 0-3 (some the shard's self client)."""
    seq = UNASSIGNED_SEQ if rng.random() < 0.25 else int(rng.integers(1, 50))
    return torch.from_numpy(E.insert(0, 1, 1, seq=seq,
                                     ref=int(rng.integers(0, 50)),
                                     client=int(rng.integers(0, 4))))


@pytest.mark.parametrize("s", [32, 256])
@pytest.mark.parametrize("flavour", ["tail", "unassigned", "wrap", "plain",
                                     "mixed"])
@pytest.mark.parametrize("seed", range(3))
def test_one_pass_tail_equals_the_prefix_form(seed, flavour, s):
    """X1's plain version equals the prefix form on 8 shards x 24 ops,
    every column; the tables' tails fire somewhere, and with ``"wrap"``
    shard lengths pass 2**31 (each stays below 2**32, the stated
    domain)."""
    rng = np.random.default_rng(1000 * seed + s + len(flavour))
    tables, scalars = random_group(rng, N_DEV, s, flavour)
    fired, longest = 0, 0
    for _ in range(24):
        op = random_op(rng)
        got = SX.shard_stats_plain(tables, scalars, op)
        want = prefix_stats(tables, scalars, op)
        assert got.dtype == torch.int32 and got.shape == (N_DEV, 3)
        assert torch.equal(got, want), (got, want)
        fired += int(got[:, 2].sum())
        _part, vis = K1._perspective(
            tables, op[F_CLIENT].reshape(1, 1), op[F_REF].reshape(1, 1),
            op[F_CLIENT].reshape(1, 1) == scalars[:, SC_SELF:SC_SELF + 1],
            scalars[:, SC_MIN_SEQ:SC_MIN_SEQ + 1])
        true = vis.long().sum(1)
        assert int(true.max()) < 1 << 32
        longest = max(longest, int(true.max()))
    if flavour in ("tail", "mixed"):
        assert fired > 0
    if flavour == "wrap":
        assert longest >= 1 << 31


# -- ShardedDoc against the reference on the exchange's edge cases -------------


def sharded_fields(shards, cap=32, self_client=NO_CLIENT, min_seq=0):
    """The 20 sharded fields from per-shard row lists; a row is a dict of
    lanes (``length`` and ``seq`` at least; ``client`` 0, ``rseq``
    RSEQ_NONE, a fresh ``orig`` by default)."""
    lanes = {k: np.full((N_DEV, cap), LANE_FILLS.get(k, 0), np.int32)
             for k in SEGMENT_LANES}
    orig, top = 0, 0
    for d, rows in enumerate(shards):
        for r, row in enumerate(rows):
            orig += 1
            full = dict(kind=KIND_TEXT, orig=orig, client=0, rseq=RSEQ_NONE)
            full.update(row)
            for k, v in full.items():
                lanes[k][d, r] = v
            top = max(top, full["seq"], full["rseq"] % RSEQ_NONE)
    counts = np.array([len(r) for r in shards], np.int32)

    def rep(v):
        return np.full(N_DEV, v, np.int32)

    return [lanes[k] for k in SEGMENT_LANES] + [
        counts, rep(min_seq), rep(top), rep(self_client), rep(0)]


def load_both(p: DocPair, fields) -> None:
    """Load the same sharded state into the reference and the port."""
    spec = NamedSharding(p.ref.mesh, P(p.ref.axis))
    p.ref.state = RefState(*[jax.device_put(jnp.asarray(np.asarray(
        x, np.int32)), spec) for x in fields])
    p.port.load_state(fields)
    p.check()


def run_case(p: DocPair, steps) -> None:
    """Apply each ``(row, grows)`` op to both, compared after each; where
    ``grows`` names a shard, exactly that shard's count must change (the
    insert's owner)."""
    for row, grows in steps:
        before = p.port.state.count.copy()
        p.apply([row])
        if grows is not None:
            changed = np.flatnonzero(p.port.state.count != before)
            assert changed.tolist() == [grows], (row, changed)


def _text_rows(n, length=3, seq0=1):
    return [dict(length=length, seq=seq0 + i) for i in range(n)]


def case_tail_at_boundary():
    """Shard 2 ends in a tombstone removed at seq 17 by writer 0 (length 0
    for a ref of 17 on, or for writer 0): an insert at the boundary after
    shard 2 with a later seq lands in shard 2, before the tombstone; with
    ref 16 the tombstone is still visible and the insert at the boundary
    after it lands in shard 3; the remover's own insert does not see it,
    and an unsequenced insert goes before it too. Shard 5 starts with a
    tombstone and has live rows after it, so the boundary after shard 5
    goes to shard 6."""
    shards = [_text_rows(2, seq0=1 + 2 * d) for d in range(N_DEV)]
    shards[2][1]["rseq"] = 17
    shards[2][1]["rbits"] = 1  # removed by writer 0
    shards[5].insert(0, dict(length=3, seq=3, rseq=17, rbits=1))
    fields = sharded_fields(shards)
    steps = [
        (E.insert(15, 900, 2, seq=31, ref=17, client=1), 2),
        (E.insert(18, 901, 2, seq=32, ref=16, client=2), 3),
        (E.insert(15, 902, 1, seq=33, ref=16, client=0), 2),
        (E.insert(38, 903, 1, seq=34, ref=33, client=1), 6),
        (E.insert(18, 904, 1, seq=UNASSIGNED_SEQ, ref=34, client=3,
                  lseq=1), 2),
    ]
    return fields, NO_CLIENT, steps


def case_past_the_end():
    """Inserts and ranges past the document's end set ERR_RANGE on every
    shard (global coordinates); an insert at exactly the end appends to
    the last live shard."""
    fields = sharded_fields([_text_rows(2, seq0=1 + 2 * d)
                             for d in range(N_DEV)])
    total = 6 * N_DEV
    steps = [
        (E.insert(total, 900, 2, seq=20, ref=19, client=1), 7),
        (E.insert(total + 3, 901, 2, seq=21, ref=20, client=1), 7),
        (E.remove(total - 4, total + 6, seq=22, ref=21, client=2), None),
        (E.annotate(0, total + 40, 5, seq=23, ref=22, client=0), None),
    ]
    return fields, NO_CLIENT, steps


def case_empty_shards_between():
    """Only shards 0, 3 and 7 hold rows: the end of shard 0 is the start
    of shard 3 (owner 3), the document's end goes to shard 7 (the last
    live shard), and a remove spans the empty ones."""
    shards = [[] for _ in range(N_DEV)]
    for d in (0, 3, 7):
        shards[d] = _text_rows(2, seq0=1 + 2 * d)
    fields = sharded_fields(shards)
    steps = [
        (E.insert(6, 900, 2, seq=20, ref=19, client=1), 3),
        (E.insert(20, 901, 1, seq=21, ref=20, client=1), 7),
        (E.remove(4, 15, seq=22, ref=21, client=2), None),
        (E.insert(0, 902, 1, seq=23, ref=22, client=3), 0),
    ]
    return fields, NO_CLIENT, steps


def case_every_shard_empty():
    """No shard holds rows: inserts go to shard 0; past the end it is
    ERR_RANGE; an empty remove is a NOOP everywhere."""
    fields = sharded_fields([[] for _ in range(N_DEV)])
    steps = [
        (E.remove(0, 0, seq=1, ref=0, client=0), None),
        (E.insert(0, 900, 3, seq=2, ref=1, client=0), 0),
        (E.insert(9, 901, 3, seq=3, ref=2, client=1), 0),
        (E.insert(1, 902, 2, seq=4, ref=3, client=1), 0),
    ]
    return fields, NO_CLIENT, steps


def case_remove_over_three_shards():
    """A remove from inside shard 0 to inside shard 2 (splits at both
    ends), an annotate over five shards, then an insert in the gap."""
    fields = sharded_fields([_text_rows(3, seq0=1 + 3 * d)
                             for d in range(N_DEV)])
    steps = [
        (E.remove(5, 25, seq=30, ref=29, client=1), None),
        (E.annotate(3, 40, 7, seq=31, ref=30, client=2), None),
        (E.insert(5, 900, 2, seq=32, ref=31, client=0), 0),
    ]
    return fields, NO_CLIENT, steps


def case_ranges_empty_in_some_shards():
    """An annotate inside shard 1 (a NOOP on every other shard), an empty
    remove, a remove of shard 1's tail only, a range that ends exactly on
    a boundary."""
    fields = sharded_fields([_text_rows(3, seq0=1 + 3 * d)
                             for d in range(N_DEV)])
    steps = [
        (E.annotate(10, 14, 3, seq=30, ref=29, client=1), None),
        (E.remove(20, 20, seq=31, ref=30, client=1), None),
        (E.remove(16, 18, seq=32, ref=31, client=2), None),
        (E.annotate(9, 18, 4, seq=33, ref=32, client=0), None),
    ]
    return fields, NO_CLIENT, steps


def case_unknown_types():
    """Unknown types (-1, 7, 100) between inserts: clipped into NOOP /
    ACK_ANNOTATE as the reference's lax.switch does."""
    fields = sharded_fields([_text_rows(2, seq0=1 + 2 * d)
                             for d in range(N_DEV)])
    steps = []
    for i, ty in enumerate((-1, 7, 100)):
        row = E.insert(7 + i, 900 + i, 1, seq=20 + 2 * i, ref=19 + 2 * i,
                       client=1)
        row[F_TYPE] = ty
        steps.append((row, None))
        steps.append((E.insert(7 + i, 910 + i, 1, seq=21 + 2 * i,
                               ref=20 + 2 * i, client=2), 1))
    return fields, NO_CLIENT, steps


def case_local_client():
    """A document of self client 1: its own unsequenced insert and remove
    (local ops, the is_local perspective), remote ops between, then their
    acks and a sequenced op of client 1."""
    fields = sharded_fields([_text_rows(2, seq0=1 + 2 * d)
                             for d in range(N_DEV)], self_client=1)
    steps = [
        (E.insert(12, 900, 2, seq=UNASSIGNED_SEQ, ref=16, client=1,
                  lseq=1), 2),
        (E.insert(12, 901, 1, seq=17, ref=16, client=2), 2),
        (E.remove(10, 16, seq=UNASSIGNED_SEQ, ref=17, client=1, lseq=2),
         None),
        (E.ack("insert", lseq=1, seq=18), None),
        (E.ack("remove", lseq=2, seq=19), None),
        (E.insert(30, 902, 2, seq=20, ref=19, client=1), 5),
    ]
    return fields, 1, steps


def case_unassigned_rows():
    """Rows with UNASSIGNED_SEQ (client 1's pending inserts) end shard 3:
    invisible to a remote op's perspective (zero length, and its tie-break
    does not go before them), visible to the self client's, and an
    unsequenced op of another writer goes before them."""
    shards = [_text_rows(2, seq0=1 + 2 * d) for d in range(N_DEV)]
    shards[3].append(dict(length=2, seq=UNASSIGNED_SEQ, client=1, lseq=5))
    fields = sharded_fields(shards, self_client=1)
    b = 6 * 4  # the boundary after shard 3, remote view
    steps = [
        (E.insert(b, 900, 1, seq=20, ref=19, client=2), 4),
        (E.insert(b, 901, 1, seq=UNASSIGNED_SEQ, ref=20, client=1,
                  lseq=6), 3),
        (E.insert(b, 902, 1, seq=UNASSIGNED_SEQ, ref=20, client=2,
                  lseq=7), 3),
        (E.ack("insert", lseq=5, seq=21), None),
    ]
    return fields, 1, steps


def case_global_length_past_int32():
    """Rows of 2**27 characters, 3 a shard: each shard 402,653,184 long,
    the document 3 * 2**30, so the offsets past shard 5 and the global
    length wrap in int32 as the reference's do; an insert near 2**31
    lands in shard 5, a remove sets ERR_RANGE against the wrapped
    length."""
    big = 1 << 27
    fields = sharded_fields([_text_rows(3, length=big, seq0=1 + 3 * d)
                             for d in range(N_DEV)])
    steps = [
        (E.insert((1 << 31) - 10, 900, 2, seq=30, ref=29, client=1), 5),
        (E.insert(3 * big, 901, 1, seq=31, ref=30, client=2), 1),
        (E.remove(big - 1, big + 1, seq=32, ref=31, client=0), None),
        (E.annotate(0, 5, 2, seq=33, ref=32, client=3), None),
    ]
    return fields, NO_CLIENT, steps


CASES = {f.__name__[5:]: f for f in (
    case_tail_at_boundary, case_past_the_end, case_empty_shards_between,
    case_every_shard_empty, case_remove_over_three_shards,
    case_ranges_empty_in_some_shards, case_unknown_types,
    case_local_client, case_unassigned_rows, case_global_length_past_int32)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_doc_equals_the_reference_on_edge_cases(name):
    fields, self_client, steps = CASES[name]()
    p = DocPair(fields[0].shape[1], self_client=self_client)
    load_both(p, fields)
    run_case(p, steps)
    if name in ("past_the_end", "global_length_past_int32"):
        assert p.port.err & ERR_RANGE
    p.call("compact")


@pytest.mark.parametrize("seed", range(2))
def test_two_device_groups_equal_the_reference(seed):
    """Shards alternating over two device groups (``cpu`` and ``cpu:1``):
    X1 on each group, the stats shared, X2 and K1 on each, against the
    reference on tests/test_torch_sharded_doc.py's fuzz stream."""
    payloads = {}
    base, s = baseline_doc(16, payloads)
    devs = ["cpu", "cpu:1"] * (N_DEV // 2)
    p = DocPair.__new__(DocPair)
    p.ref = RefDoc(shard_cap=48, self_client=seed)
    p.port = ShardedDoc(48, mesh=M.Mesh(devs, "seg"), self_client=seed)
    assert len(p.port._groups) == 2 and not p.port._in_order
    p.ref.load_single(base)
    p.port.load_single(type(p.port.state)(*[np.asarray(x) for x in base]))
    p.check()
    p.apply(_fuzz_rows(np.random.default_rng(seed + 40), 40, s, 48))
    p.call("compact")
    p.call("rebalance", 0.3)


# -- the wrappers and ShardedDoc's use of them -------------------------------


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors ``shard_stats`` and ``shard_resolve`` write their
    plain versions' values into the given outputs (filled with a
    sentinel first) and count no launch; the op row is ``ops[k]``."""
    rng = np.random.default_rng(3)
    tables, scalars = random_group(rng, N_DEV, 64, "mixed")
    ops = torch.stack([random_op(rng) for _ in range(4)])
    SX.reset_counts()
    for k in range(4):
        out = torch.full((N_DEV, 3), -0x5EED, dtype=torch.int32)
        got = SX.shard_stats(tables, scalars, ops, k, out=out)
        assert got is out
        assert torch.equal(out, SX.shard_stats_plain(tables, scalars, ops[k]))
    stats = SX.shard_stats(tables, scalars, ops, 0)
    order = torch.tensor([3, 1, 0, 2, 7, 6, 5, 4], dtype=torch.int32)
    row_of = torch.argsort(order).to(torch.int32)
    at = torch.tensor([2, 5, 6], dtype=torch.int32)
    sc = scalars[:3].clone()
    want_rows, want_sc = SX.shard_resolve_plain(stats[order.long()], ops[1],
                                                at, row_of, sc)
    out = torch.full((3, 1, OP_WIDTH), -0x5EED, dtype=torch.int32)
    assert SX.shard_resolve(stats[order.long()], ops, 1, at, row_of, sc,
                            out=out) is out
    assert torch.equal(out, want_rows) and torch.equal(sc, want_sc)
    # row_of undoes the order: the same rows as from stats in shard order.
    same_rows, _ = SX.shard_resolve_plain(
        stats, ops[1], at, torch.arange(N_DEV, dtype=torch.int32), sc)
    assert torch.equal(same_rows, want_rows)
    # shard_exchange: X2 applied to X1's stats, the group in shard order.
    ar = torch.arange(N_DEV, dtype=torch.int32)
    for k in range(4):
        st = torch.full((N_DEV, 3), -0x5EED, dtype=torch.int32)
        out = torch.full((N_DEV, 1, OP_WIDTH), -0x5EED, dtype=torch.int32)
        sc = scalars.clone()
        want_st = SX.shard_stats_plain(tables, scalars, ops[k])
        want_rows, want_sc = SX.shard_resolve_plain(want_st, ops[k], ar, ar,
                                                    scalars)
        assert SX.shard_exchange(tables, sc, ops, k, stats=st,
                                 out=out) is out
        assert torch.equal(st, want_st) and torch.equal(out, want_rows)
        assert torch.equal(sc, want_sc)
        got = SX.shard_exchange_plain(tables, scalars, ops[k])
        for a, b in zip(got, (want_st, want_rows, want_sc)):
            assert torch.equal(a, b)
    assert SX.shard_stats.launches == SX.shard_resolve.launches == 0
    assert SX.shard_exchange.launches == 0


def test_sharded_doc_runs_the_exchange_through_the_wrappers(monkeypatch):
    """``kernel="auto"`` calls the exchange's wrappers once per op and
    group (so a card launches the kernels): one device group (8 x ``cpu``)
    ``shard_exchange`` alone, two groups (``cpu`` and ``cpu:1``) X1 and X2
    on each; ``kernel="plain"`` calls none of them. Both leave equal
    states. A clone gets buffers of its own, so applying to it leaves the
    original as it was."""
    import fluidframework_tpu_torch.parallel.sharded_doc as SDM

    calls = {"stats": 0, "resolve": 0, "exchange": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(SDM.SX, "shard_stats", spy("stats", SX.shard_stats))
    monkeypatch.setattr(SDM.SX, "shard_resolve",
                        spy("resolve", SX.shard_resolve))
    monkeypatch.setattr(SDM.SX, "shard_exchange",
                        spy("exchange", SX.shard_exchange))
    payloads = {}
    base, s = baseline_doc(16, payloads)
    rows = _fuzz_rows(np.random.default_rng(7), 12, s, 48)
    for devs, want in ((["cpu"] * N_DEV,
                        {"stats": 0, "resolve": 0, "exchange": 12}),
                       (["cpu", "cpu:1"] * (N_DEV // 2),
                        {"stats": 24, "resolve": 24, "exchange": 0})):
        calls.update(dict.fromkeys(calls, 0))
        doc = ShardedDoc(48, mesh=M.Mesh(devs, "seg"))
        doc.load_single(type(doc.state)(*[np.asarray(x) for x in base]))
        plain = doc.clone(kernel="plain")
        for g, h in zip(doc._groups, plain._groups):
            for name in ("tables", "scalars", "stats", "acc", "rows", "ids"):
                assert getattr(g, name).data_ptr() != \
                    getattr(h, name).data_ptr()
        before = [np.asarray(x).copy() for x in doc.state]
        plain.apply(rows)
        assert calls == dict.fromkeys(calls, 0)
        for a, b in zip(before, doc.state):
            np.testing.assert_array_equal(a, np.asarray(b))
        doc.apply(rows)
        assert calls == want, devs
        for a, b in zip(plain.state, doc.state):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exchange_entries_are_in_the_merge_library_without_tiers():
    for entry in ("shard_stats", "shard_resolve", "shard_exchange"):
        assert _cuda.ENTRIES[entry] == "merge"
        assert entry in _cuda.UNTIERED
        with pytest.raises(ValueError, match="no tier"):
            _cuda.tier(128, entry, 1)
    # A row a shard and the row of the launch's ticket.
    acc = SX.new_accumulators(3, "cpu")
    assert acc.dtype == torch.int32
    assert acc.tolist() == [list(SX.ACC_INIT)] * 4


@pytest.mark.parametrize("n,s", [(1, 64), (3, 128), (17, 32)])
def test_smoke_exchange_holds_rehearse_on_the_cpu(n, s):
    """chip_smoke's exchange holds (``exchange_case``, ``hold_exchange``:
    X1, X2 and ``shard_exchange`` into sentinel outputs, permuted stats
    rows, a strided group, ops past the end) run end to end on CPU
    tensors, where the wrappers take the plain versions; the byte floors
    count this run's live and removed rows and the rows below each shard's
    count, the all-rows floors every row."""
    from chip_smoke import exchange_bound_bytes, exchange_case, hold_exchange

    tables, scalars, ops = exchange_case(torch.device("cpu"), n, s, seed=n)
    assert tables.shape == (N_LANES, n, s) and ops.shape == (8, OP_WIDTH)
    assert int(scalars[0, SC_COUNT]) == s
    rows = hold_exchange(torch.device("cpu"), tables, scalars, ops,
                         f"cpu {n} x {s}", reps=1, plain_reps=1)
    assert [r["kernel"] for r in rows] == ["X1_shard_stats",
                                           "X2_shard_resolve",
                                           "X12_shard_exchange"]
    assert all(r["max_abs_err"] == 0 and r["ms"] >= 0 for r in rows)
    x1, x2, x12 = exchange_bound_bytes(tables)
    assert x1 >= 4 * n * s and x2 > 0 and x12 > 0
    assert all(0 < r["bound_ms"] <= r["all_rows_bound_ms"] for r in rows)
    assert rows[1]["bound_ms"] == rows[1]["all_rows_bound_ms"]
    assert SX.shard_stats.launches == SX.shard_resolve.launches == 0
    assert SX.shard_exchange.launches == 0


# -- the count bound: no row at or past count is in use -----------------------


def assert_free_past_count(kind, count, what):
    """Every row at or past its table's count is KIND_FREE (``kind``
    ``[..., S]``, ``count`` ``[...]``)."""
    kind = np.asarray(kind)
    kind = kind.reshape(-1, kind.shape[-1])
    count = np.asarray(count).reshape(-1)
    past = np.arange(kind.shape[1])[None, :] >= count[:, None]
    assert (kind[past] == KIND_FREE).all(), what


def _single_pair(cap):
    return (RSS.make_state(cap, NO_CLIENT),
            SS.make_state(cap, NO_CLIENT, device="cpu"))


def _check_single(ref, port, what):
    assert_free_past_count(ref.kind, ref.count, f"reference {what}")
    assert_free_past_count(port.kind, port.count, f"port {what}")
    np.testing.assert_array_equal(np.asarray(ref.kind),
                                  port.kind.numpy(), err_msg=what)


def count_bound_stream(seed):
    """Each op of ``random_acked_stream`` (the collab window 8 behind, so
    tombstones become reclaimable) through both packages' single-table
    apply, in a table of 40 rows the stream overfills (ERR_CAPACITY drops
    ops)."""
    rng = np.random.default_rng(seed)
    ops = np.stack(random_acked_stream(rng, 72, {}, OracleDoc(NO_CLIENT),
                                       msn_lag=8)).astype(np.int32)
    ref, port = _single_pair(40)
    for i, op in enumerate(ops):
        ref = RMK.jit_apply_ops(ref, op[None])
        port = MK.jit_apply_ops(port, op[None])
        _check_single(ref, port, f"op {i}")
    assert int(port.err) & 1  # the table filled


def count_bound_compact_grow(seed):
    """Chunks of the stream (the collab window 24 behind), each followed
    by a compaction, and a grow to twice the capacity whenever the table
    passes three quarters full."""
    rng = np.random.default_rng(seed + 50)
    ops = np.stack(random_acked_stream(rng, 96, {}, OracleDoc(NO_CLIENT),
                                       msn_lag=24)).astype(np.int32)
    ref, port = _single_pair(16)
    grown = 0
    for i in range(0, len(ops), 8):
        ref = RMK.jit_apply_ops(ref, ops[i:i + 8])
        port = MK.jit_apply_ops(port, ops[i:i + 8])
        _check_single(ref, port, f"ops to {i + 8}")
        ref = RMK.compact(ref)
        port = MK.compact(port)
        _check_single(ref, port, f"compaction after op {i + 8}")
        cap = SS.capacity_of(port)
        if int(port.count) * 4 > cap * 3:
            ref = RSS.grow(ref, 2 * cap)
            port = SS.grow(port, 2 * cap)
            grown += 1
            _check_single(ref, port, f"grow to {2 * cap}")
    assert grown


def count_bound_sharded(seed):
    """A sharded document (the reference's and the port's) after
    load_single, each op of a fuzz stream, compact, rebalance and another
    load_single, every shard."""
    payloads = {}
    base, s = baseline_doc(20 + 4 * seed, payloads)
    p = DocPair(48, base=base, self_client=seed)

    def check(what):
        for name, st in (("reference", p.ref.state),
                         ("port", p.port.state)):
            assert_free_past_count(st.kind, st.count, f"{name} {what}")

    check("load_single")
    for i, row in enumerate(_fuzz_rows(np.random.default_rng(seed + 60), 40,
                                       s, 48)):
        p.apply([row])
        check(f"op {i}")
    p.call("compact")
    check("compact")
    assert p.call("rebalance", 0.1)
    check("rebalance")
    single = p.single()
    p.ref.load_single(RefState(*[jnp.asarray(np.asarray(x))
                                 for x in single]))
    p.port.load_single(single)
    p.check()
    check("load_single of its own single table")


COUNT_BOUND = {f.__name__[12:]: f for f in (
    count_bound_stream, count_bound_compact_grow, count_bound_sharded)}


@pytest.mark.parametrize("case", sorted(COUNT_BOUND))
@pytest.mark.parametrize("seed", range(3))
def test_rows_past_count_are_free(case, seed):
    """The bound X1 reads by on the card: no row at or past a table's
    count is in use, in the reference's states and the port's."""
    COUNT_BOUND[case](seed)
