"""Parity: the port's DocFleet (``device="cpu"``, plain PyTorch kernels)
against the JAX reference DocFleet (``kernel="xla"``, and ``kernel="pallas"``
in interpret mode at the smallest shapes), driven through the same entry
points with the same seeded numpy ops.

After every step both fleets must agree exactly (int32 throughout, so the
tolerance is 0): every pool's 15 lanes and 5 scalars, pool order and slot
counts, ``doc_of_slot``, ``slot_gen`` and the slot free-lists, placement,
``migrations``/``demotions``, ``stats()``, ``telemetry_slice()``,
``doc_counts()``, ``doc_states()`` and ``doc_state()``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.parallel.fleet import DocFleet as RefFleet
from fluidframework_tpu_torch.interop import fleet_from_reference
from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.ops.segment_state import SEGMENT_LANES
from fluidframework_tpu_torch.parallel.fleet import _SCALARS, DocFleet, _Pool
from fluidframework_tpu_torch.protocol.constants import (
    ERR_CAPACITY,
    ERR_CLIENT,
    OP_WIDTH,
    UNASSIGNED_SEQ,
)


class Traffic:
    """Seeded per-doc op rounds (server-sequenced, one seq per op): inserts
    of 1-3 chars at random positions and 2-char removes; optionally local
    (pending) inserts acked one round later, a lagging collab window so
    compaction reclaims, and writers past the 93-slot cap."""

    def __init__(self, n_docs, seed=0, insert_bias=0.9, msn_lag=None):
        self.rng = np.random.default_rng(seed)
        self.n = n_docs
        self.bias = insert_bias
        self.msn_lag = msn_lag
        self.seqs = [0] * n_docs
        self.lens = [0] * n_docs
        self.orig = 1
        self.pending = [[] for _ in range(n_docs)]  # (lseq) awaiting ack

    def _msn(self, d):
        if self.msn_lag is None:
            return 0
        return max(0, self.seqs[d] - self.msn_lag)

    def round(self, k, docs=None, local=False, bad_client=(), bias=None):
        docs = range(self.n) if docs is None else docs
        bias = self.bias if bias is None else bias
        ops = np.zeros((self.n, k, OP_WIDTH), np.int32)
        for d in docs:
            i = 0
            while self.pending[d] and i < k:
                lseq = self.pending[d].pop()
                self.seqs[d] += 1
                ops[d, i] = E.ack("insert", lseq=lseq, seq=self.seqs[d],
                                  msn=self._msn(d))
                i += 1
            for i in range(i, k):
                self.seqs[d] += 1
                seq, msn = self.seqs[d], self._msn(d)
                client = 95 if d in bad_client else int(self.rng.integers(4))
                if self.lens[d] > 4 and self.rng.random() > bias:
                    a = int(self.rng.integers(0, self.lens[d] - 2))
                    ops[d, i] = E.remove(a, a + 2, seq=seq, ref=seq - 1,
                                         client=client, msn=msn)
                    self.lens[d] -= 2
                    continue
                n = int(self.rng.integers(1, 4))
                pos = int(self.rng.integers(0, self.lens[d] + 1))
                if local and i == k - 1:
                    lseq = seq  # unique per doc
                    ops[d, i] = E.insert(pos, self.orig, n, seq=UNASSIGNED_SEQ,
                                         ref=seq - 1, client=client,
                                         lseq=lseq, msn=msn)
                    self.pending[d].append(lseq)
                else:
                    ops[d, i] = E.insert(pos, self.orig, n, seq=seq,
                                         ref=seq - 1, client=client, msn=msn)
                self.orig += 1
                self.lens[d] += n
        return ops

    def clear(self, docs, k=2):
        """Remove each listed doc's whole text, then a noop that advances
        the collab window past it (so compaction reclaims every row)."""
        ops = np.zeros((self.n, k, OP_WIDTH), np.int32)
        for d in docs:
            self.seqs[d] += 1
            s = self.seqs[d]
            ops[d, 0] = E.remove(0, self.lens[d], seq=s, ref=s - 1, client=0,
                                 msn=self._msn(d))
            self.seqs[d] += 1
            ops[d, 1] = E.noop(seq=self.seqs[d], msn=self.seqs[d])
            self.lens[d] = 0
        return ops


def _ref_lanes(pool):
    st = pool.state
    return (np.stack([np.asarray(getattr(st, k)) for k in SEGMENT_LANES]),
            np.stack([np.asarray(getattr(st, s)) for s in _SCALARS], 1))


class Pair:
    """A reference fleet and a port fleet driven in lockstep."""

    def __init__(self, *args, kernel="xla", **kw):
        self.ref = RefFleet(*args, kernel=kernel, **kw)
        self.port = DocFleet(*args, device="cpu", **kw)
        self.check()

    def call(self, name, *args, **kw):
        want = getattr(self.ref, name)(*args, **kw)
        got = getattr(self.port, name)(*args, **kw)
        self.check()
        return want, got

    def same(self, name, *args, **kw):
        want, got = self.call(name, *args, **kw)
        assert want == got, (name, want, got)
        return got

    def check(self):
        ref, port = self.ref, self.port
        assert list(ref.pools) == list(port.pools)
        for cap, rp in ref.pools.items():
            pp = port.pools[cap]
            assert (rp.capacity, rp.n_slots) == (pp.capacity, pp.n_slots)
            lanes, scal = _ref_lanes(rp)
            np.testing.assert_array_equal(lanes, pp.tables.numpy(),
                                          err_msg=f"pool {cap} lanes")
            np.testing.assert_array_equal(scal, pp.scalars[:, :5].numpy(),
                                          err_msg=f"pool {cap} scalars")
            assert not pp.scalars[:, 5:].any()
            np.testing.assert_array_equal(rp.doc_of_slot, pp.doc_of_slot)
            np.testing.assert_array_equal(rp.slot_gen, pp.slot_gen)
            assert [int(s) for s in rp._free] == pp._free
        assert ref.placement == port.placement
        every = np.arange(len(ref.placement))
        np.testing.assert_array_equal(ref.doc_caps(every),
                                      port.doc_caps(every))
        assert (ref.n_docs, ref.migrations, ref.demotions) == (
            port.n_docs, port.migrations, port.demotions)
        assert ref.stats() == port.stats()
        want, got = ref.telemetry_slice(), port.telemetry_slice()
        assert list(want) == list(got)
        for cap in want:
            np.testing.assert_array_equal(want[cap], got[cap])
        placed = [d for d, p in enumerate(ref.placement) if p is not None]
        np.testing.assert_array_equal(ref.doc_counts(placed),
                                      port.doc_counts(placed))
        want, got = ref.doc_states(placed), port.doc_states(placed)
        assert sorted(want) == sorted(got)
        for d in placed:
            _states_equal(want[d], got[d])
        for d in placed[:1] + placed[-1:]:
            _states_equal(ref.doc_state(d), port.doc_state(d))
            _states_equal(ref.doc_state(d), got[d])

    def scans(self):
        """begin_scan on both, as a pair of tokens."""
        return self.ref.begin_scan(), self.port.begin_scan()

    def finish(self, tokens):
        want = self.ref.finish_scan(tokens[0])
        got = self.port.finish_scan(tokens[1])
        assert list(want) == list(got)
        for cap in want:
            np.testing.assert_array_equal(want[cap], got[cap])
        return got


def _states_equal(a, b):
    assert a._fields == b._fields
    for f, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f


# -- scenarios (each takes the reference kernel) --------------------------------


def growth(kernel):
    """Docs grow past the initial capacity with zero drops (32 -> 128)."""
    p = Pair(4, 32, high_water=0.7, kernel=kernel)
    tr = Traffic(4, seed=0)
    for _ in range(12):
        stats = p.same("apply", tr.round(4))
        assert stats["docs_with_errors"] == 0
        p.same("check_and_migrate")
    assert p.port.migrations >= 8
    assert max(p.port.pools) == 128


def promotion_keeps_pending(kernel):
    """Local (pending) rows and their acks survive promotion and compaction
    in the new tier."""
    p = Pair(2, 16, high_water=0.6, kernel=kernel)
    tr = Traffic(2, seed=3, msn_lag=6)
    for _ in range(8):
        p.same("apply", tr.round(3, local=True))
        p.call("compact")
        p.same("check_and_migrate")
    assert p.port.migrations >= 2
    base = p.port.pools[16]
    assert base.free_slot() is not None
    base.release_slot(base.free_slot())  # leave the free-list as it was
    assert any((pool.tables[6] != 0).any() for pool in p.port.pools.values())


def no_migration_trips_capacity(kernel):
    """Without the lifecycle a doc fills its table and ERR_CAPACITY trips."""
    p = Pair(1, 16, high_water=0.7, kernel=kernel)
    tr = Traffic(1, seed=1, insert_bias=1.0)
    for _ in range(6):
        stats = p.same("apply", tr.round(4))
    assert stats["docs_with_errors"] == 1
    assert int(p.port.doc_state(0).err) & ERR_CAPACITY


def compaction_per_pool(kernel):
    """A lagging collab window: every pool compacts, removes reclaim."""
    p = Pair(3, 32, high_water=0.7, kernel=kernel)
    tr = Traffic(3, seed=5, insert_bias=0.6, msn_lag=4)
    for _ in range(10):
        p.same("apply", tr.round(4))
        p.call("compact")
        p.same("check_and_migrate")
    assert len(p.port.pools) >= 2


def sparse_equals_dense(kernel):
    """apply_sparse over a random busy subset equals dense apply with the
    idle docs' rows zeroed, across promotions."""
    dense = Pair(5, 16, high_water=0.7, kernel=kernel)
    sparse = Pair(5, 16, high_water=0.7, kernel=kernel)
    tr = Traffic(5, seed=7)
    rng = np.random.default_rng(3)
    for _ in range(8):
        ops = tr.round(2)
        busy = sorted(int(d) for d in rng.choice(5, int(rng.integers(1, 6)),
                                                 replace=False))
        dense_ops = np.zeros_like(ops)
        dense_ops[busy] = ops[busy]
        dense.call("apply", dense_ops)
        sparse.call("apply_sparse", busy, ops[busy])
        for f in (dense, sparse):
            f.call("compact")
            f.same("check_and_migrate")
    for a, b in zip(dense.port.pools.values(), sparse.port.pools.values()):
        assert torch.equal(a.tables, b.tables)
        assert torch.equal(a.scalars, b.scalars)


def padding_drops(kernel):
    """B pads to a pow2 bucket; padding rows carry slot n_slots and must
    land nowhere (not in slot 0)."""
    p = Pair(3, 16, high_water=0.9, kernel=kernel)
    ops = np.zeros((1, 8, OP_WIDTH), np.int32)
    ops[0, 0] = E.insert(0, 1, 3, seq=1, ref=0, client=0)
    p.call("apply_sparse", [1], ops)
    ops2 = np.zeros((3, 8, OP_WIDTH), np.int32)
    ops2[0, 0] = E.insert(0, 2, 2, seq=2, ref=1, client=0)
    ops2[1, 0] = E.insert(0, 3, 1, seq=1, ref=0, client=0)
    ops2[2, 0] = E.insert(0, 4, 1, seq=1, ref=0, client=0)
    p.call("apply_sparse", [1, 0, 2], ops2)  # B=3 pads to 4
    assert list(p.port.doc_counts([0, 1, 2])) == [1, 2, 1]


def stale_scan(kernel):
    """A scan begun before a slot changed occupant reads 0 for that slot
    and cannot re-promote the new occupant."""
    p = Pair(1, 8, max_capacity=64, kernel=kernel)
    ops = np.zeros((1, 8, OP_WIDTH), np.int32)
    for i in range(7):
        ops[0, i] = E.insert(0, i + 1, 1, seq=i + 1, ref=i, client=0)
    p.same("apply", ops)
    tokens = p.scans()
    p.same("check_and_migrate")
    assert p.port.placement[0][0] == 16
    d1 = p.same("add_doc")
    assert p.port.placement[d1] == (8, 0)
    scans = p.finish(tokens)
    assert scans[8][0][0] == 0
    promoted = p.same("check_and_migrate",
                      {c: s[0] for c, s in scans.items()})
    assert d1 not in promoted


def demotion(kernel):
    """Docs grown to the 128 tier cool down and step back to 64, except
    one that heated back up after the scan and one with an err bit."""
    p = Pair(4, 32, high_water=0.75, kernel=kernel)
    tr = Traffic(4, seed=11, insert_bias=1.0, msn_lag=2)
    while min(p.port.doc_counts(range(4))) <= 52:
        p.same("apply", tr.round(4))
        p.same("check_and_migrate")
    assert set(c for c, _s in p.port.placement) == {128}
    p.same("apply", tr.clear(range(4)))
    p.same("apply", tr.round(2, docs=[2], bad_client=(2,)))
    p.call("compact")
    scans = p.finish(p.scans())
    counts = {c: s[0] for c, s in scans.items()}
    for _ in range(14):  # doc 1 heats back up after the scan
        p.same("apply", tr.round(4, docs=[1]))
    # The stale scan also reads the lower pools' new occupants as empty, so
    # a doc may step down twice in one pass (128 -> 64 -> 32).
    demoted = p.same("check_and_demote", counts)
    assert set(demoted) == {0, 3}
    assert p.port.placement[1][0] == 128 and p.port.placement[2][0] == 128
    assert int(p.port.doc_state(2).err) & ERR_CLIENT
    p.same("apply", tr.round(3))
    p.call("compact")
    p.same("check_and_demote")
    assert p.port.demotions >= 2


def evict_restore(kernel):
    """evict_docs / evict_doc pull docs out of promoted tiers; restore_doc
    returns each into its own tier; later traffic matches."""
    p = Pair(4, 16, high_water=0.7, kernel=kernel)
    tr = Traffic(4, seed=13)
    for _ in range(8):
        p.same("apply", tr.round(2))
        p.same("check_and_migrate")
    want, got = p.call("evict_docs", [1, 2])
    assert sorted(want) == sorted(got) == [1, 2]
    for d in (1, 2):
        _states_equal(want[d], got[d])
    assert p.port.placement[1] is None and p.port.placement[2] is None
    p.same("apply", tr.round(2, docs=[0, 3]))
    r3, p3 = p.call("evict_doc", 3)
    _states_equal(r3, p3)
    p.ref.restore_doc(2, want[2])
    p.port.restore_doc(2, got[2])
    p.check()
    p.ref.restore_doc(3, r3)
    p.port.restore_doc(3, p3)
    p.check()
    p.ref.restore_doc(1, want[1])
    p.port.restore_doc(1, got[1])
    p.check()
    with pytest.raises(ValueError, match="still placed"):
        p.port.restore_doc(1, got[1])
    assert p.port.placement[1][0] == got[1].kind.shape[-1] > 16
    p.same("apply", tr.round(2))
    p.same("check_and_migrate")


def add_doc_grows_slots(kernel):
    """add_doc past a full pool doubles its slot dimension."""
    p = Pair(4, 16, high_water=0.7, kernel=kernel)
    tr = Traffic(7, seed=17)
    p.same("apply", tr.round(2)[:4])
    for want in (4, 5, 6):
        assert p.same("add_doc") == want
    assert p.port.pools[16].n_slots == 8
    p.same("apply", tr.round(3)[:7])
    p.same("check_and_migrate")


def overflowing(kernel):
    """At max_capacity no tier is left: healthy docs above high water are
    reported, a doc with an err bit is not."""
    p = Pair(3, 16, high_water=0.7, max_capacity=32, kernel=kernel)
    tr = Traffic(3, seed=19, insert_bias=1.0)
    p.same("apply", tr.round(2, bad_client=(1,)))
    while min(p.port.doc_counts(range(3))) <= 22:
        p.same("apply", tr.round(2))
        p.same("check_and_migrate")
    assert p.same("overflowing_docs") == [0, 2]


def staged_and_aot(kernel):
    """dispatch_staged (rows already on the device, padded, re-routed
    after a promotion) and compact_aot."""
    p = Pair(4, 16, high_water=0.7, kernel=kernel)
    tr = Traffic(4, seed=23)
    for r in range(8):
        ops = tr.round(2)
        docs = [0, 2, 3] if r % 2 else [0, 1, 2, 3]
        rows = np.zeros((4, 2, OP_WIDTH), np.int32)
        rows[: len(docs)] = ops[docs]
        p.ref.dispatch_staged(docs, jnp.asarray(rows))
        p.port.dispatch_staged(docs, torch.from_numpy(rows))
        p.check()
        p.call("compact_aot")
        p.same("check_and_migrate")
    assert len(p.port.pools) >= 2


def handover(kernel):
    """A reference fleet handed over mid-stream (after promotions and an
    eviction) continues bit for bit in the port."""
    ref = RefFleet(4, 16, high_water=0.7, kernel=kernel)
    tr = Traffic(4, seed=29, msn_lag=5)
    for _ in range(6):
        ref.apply(tr.round(2))
        ref.compact()
        ref.check_and_migrate()
    state1 = ref.evict_doc(1)
    pools = {
        cap: (tuple(np.asarray(x) for x in pool.state), pool.doc_of_slot,
              pool.slot_gen, pool._free)
        for cap, pool in ref.pools.items()
    }
    port = fleet_from_reference(
        pools, ref.placement, base_capacity=ref.base_capacity,
        high_water=ref.high_water, low_water=ref.low_water,
        max_capacity=ref.max_capacity, migrations=ref.migrations,
        demotions=ref.demotions, device="cpu",
    )
    p = Pair.__new__(Pair)
    p.ref, p.port = ref, port
    p.check()
    for _ in range(4):
        p.same("apply", tr.round(2, docs=[0, 2, 3]))
        p.call("compact")
        p.same("check_and_migrate")
    ref.restore_doc(1, state1)
    port.restore_doc(1, state1)
    p.check()
    p.same("apply", tr.round(2))


def empty_pools_skip_compaction(kernel):
    """compact() and compact_aot() launch no K2 on a pool without
    documents: one emptied through promotion, then one emptied through
    evict_docs. The reference compacts every pool; both stay equal."""
    p = Pair(4, 16, high_water=0.7, kernel=kernel)
    tr = Traffic(4, seed=41, insert_bias=0.9, msn_lag=3)
    while min(c for c, _s in p.port.placement) == 16:
        p.same("apply", tr.round(3))
        p.call("compact")
        p.same("check_and_migrate")
    seen = []
    step = _Pool._compact

    def counting(pool):
        seen.append(pool.capacity)
        step(pool)

    def compacted_pools():
        for name in ("compact", "compact_aot"):
            seen.clear()
            p.call(name)
            occupied = sorted({c for c, _s in filter(None, p.port.placement)})
            assert sorted(seen) == occupied, (name, seen, occupied)
        return occupied

    _Pool._compact = counting
    try:
        assert 16 in p.port.pools
        assert 16 not in compacted_pools()
        top = max(c for c, _s in p.port.placement)
        gone = [d for d, (c, _s) in enumerate(p.port.placement) if c == top]
        p.call("evict_docs", gone)
        assert top not in compacted_pools()
        p.same("apply", tr.round(2, docs=[d for d in range(4)
                                          if d not in gone]))
        compacted_pools()
    finally:
        _Pool._compact = step


SCENARIOS = [growth, promotion_keeps_pending, no_migration_trips_capacity,
             compaction_per_pool, sparse_equals_dense, padding_drops,
             stale_scan, demotion, evict_restore, add_doc_grows_slots,
             overflowing, staged_and_aot, handover,
             empty_pools_skip_compaction]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fleet_matches_xla_reference(scenario):
    scenario("xla")


@pytest.mark.parametrize("scenario", [no_migration_trips_capacity,
                                      padding_drops],
                         ids=lambda f: f.__name__)
def test_fleet_matches_pallas_reference(scenario):
    scenario("pallas")


def test_kernel_and_mesh_arguments():
    with pytest.raises(ValueError, match="kernel"):
        DocFleet(2, 8, kernel="xla", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        DocFleet(2, 8, kernel="cuda", device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        DocFleet(2, 8, mesh=object(), device="cpu")
    plain = DocFleet(2, 8, kernel="plain", device="cpu")
    auto = DocFleet(2, 8, device="cpu")
    ops = Traffic(2, seed=31).round(3)
    assert plain.apply(ops) == auto.apply(ops)
    assert torch.equal(plain.pools[8].tables, auto.pools[8].tables)


def test_stacked_docs_telemetry_matches_reference():
    """The sharded-doc telemetry reduction (doc axis folds, shard axis
    stays), on random scalars with dead rows."""
    from fluidframework_tpu.parallel.fleet import (
        _stacked_docs_telemetry as ref_stacked,
    )
    from fluidframework_tpu_torch.parallel.fleet import (
        _stacked_docs_telemetry,
    )

    rng = np.random.default_rng(37)
    live = rng.random(8) < 0.6
    cols = [rng.integers(0, 9, (8, 4)).astype(np.int32) for _ in range(4)]
    want = np.asarray(ref_stacked(jnp.asarray(live),
                                  *[jnp.asarray(c) for c in cols]))
    got = _stacked_docs_telemetry(torch.from_numpy(live),
                                  *[torch.from_numpy(c) for c in cols])
    np.testing.assert_array_equal(want, got.numpy())
