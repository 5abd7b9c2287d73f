"""Parity: the port's plain PyTorch versions of the merge kernels (K1 apply,
K2 compact, K3 apply+compact) against the JAX reference.

Ground truth is the reference's Pallas kernels in interpret mode
(``apply_ops_packed``, ``compact_packed``, ``apply_compact_packed``) and the
XLA ``merge_kernel`` (``batched_apply_ops``, ``batched_compact``). Every
value is int32 and must match exactly: all 15 lanes, all 8 scalar columns,
every sticky err bit. The port runs on the CPU, where each wrapper takes its
plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import encode as E
from fluidframework_tpu.ops.merge_kernel import (
    batched_apply_ops,
    batched_compact,
)
from fluidframework_tpu.ops.pallas_compact import (
    apply_compact_packed as ref_apply_compact,
    compact_packed as ref_compact,
)
from fluidframework_tpu.ops.pallas_kernel import (
    apply_ops_packed as ref_apply,
    pack_state as ref_pack,
)
from fluidframework_tpu.ops.segment_state import (
    make_batched_state as ref_make_batched_state,
)
from fluidframework_tpu.protocol.constants import (
    ERR_CAPACITY,
    ERR_CLIENT,
    ERR_RANGE,
    KIND_FREE,
    KIND_TEXT,
    NO_CLIENT,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu.testing.fuzz import random_acked_stream
from fluidframework_tpu.testing.oracle import OracleDoc
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import compact_kernel as K2
from fluidframework_tpu_torch.ops.segment_state import (
    make_batched_state,
    materialize,
)


def _broadcast(rows, n_docs):
    ops = np.stack(rows)
    return np.broadcast_to(ops, (n_docs,) + ops.shape).astype(np.int32).copy()


def _random_docs(seed, n_docs, n_ops, msn_lag=None, advance=False):
    streams, payloads = [], {}
    for d in range(n_docs):
        rng = np.random.default_rng(seed * 100 + d)
        ops = random_acked_stream(
            rng, n_ops, payloads, OracleDoc(NO_CLIENT), msn_lag=msn_lag
        )
        if advance:
            # Advance the collab window so acked tombstones are reclaimable.
            ops.append(E.noop(seq=n_ops + 1, msn=n_ops))
        streams.append(np.stack(ops))
    return np.stack(streams).astype(np.int32), payloads


# case -> (batch [D, K, OP_WIDTH], capacity, self_client, err bit expected)
def _case(name, cap):
    if name == "distinct_docs":
        return _random_docs(1, 8, 32)[0], cap, NO_CLIENT, 0
    if name == "msn_lag_stream":
        return _random_docs(2, 4, 40, msn_lag=12)[0], cap, NO_CLIENT, 0
    if name == "msn_advance":
        return _random_docs(3, 4, 40, advance=True)[0], cap, NO_CLIENT, 0
    if name == "local_and_acks":
        me = 2
        rows = [
            E.insert(0, 1, 5, seq=1, ref=0, client=0),
            E.insert(2, 2, 3, client=me, lseq=1),
            E.remove(1, 4, client=me, lseq=2),
            E.annotate(0, 2, 7, client=me, lseq=3),
            E.insert(1, 3, 2, seq=2, ref=1, client=4),
            E.ack("insert", lseq=1, seq=3),
            E.ack("remove", lseq=2, seq=4),
            E.ack("annotate", lseq=3, seq=5),
        ]
        return _broadcast(rows, 2), cap, me, 0
    if name == "pending_survives_compact":
        me = 1
        rows = [
            E.insert(0, 1, 4, seq=1, ref=0, client=0),
            E.insert(2, 2, 3, client=me, lseq=1),
            E.remove(0, 1, seq=2, ref=1, client=0, msn=2),
        ]
        return _broadcast(rows, 2), cap, me, 0
    if name == "capacity_overflow":
        rows = [E.insert(0, i + 1, 1, seq=i + 1, ref=i, client=0)
                for i in range(12)]
        return _broadcast(rows, 2), cap, NO_CLIENT, ERR_CAPACITY
    if name == "out_of_range":
        rows = [
            E.insert(0, 1, 4, seq=1, ref=0, client=0),
            E.insert(99, 2, 2, seq=2, ref=1, client=1),
            E.remove(2, 50, seq=3, ref=2, client=0),
        ]
        return _broadcast(rows, 2), cap, NO_CLIENT, ERR_RANGE
    if name == "collab_window":
        rows = [
            E.insert(0, 1, 6, seq=1, ref=0, client=0),
            E.remove(1, 3, seq=2, ref=1, client=1),
            E.noop(seq=3, msn=2),
            E.insert(1, 2, 2, seq=4, ref=1, client=2, msn=3),
            E.annotate(0, 4, 9, seq=5, ref=4, client=0, msn=4),
        ]
        return _broadcast(rows, 4), cap, NO_CLIENT, 0
    if name == "writer_past_cap":
        rows = [
            E.insert(0, 1, 3, seq=1, ref=0, client=0),
            E.remove(0, 2, seq=2, ref=1, client=95),
        ]
        return _broadcast(rows, 2), cap, NO_CLIENT, ERR_CLIENT
    raise KeyError(name)


# Random streams run at every capacity (at S=8 they also overflow); the
# hand-written cases at the capacity they were written for.
CASES = [
    (name, cap)
    for name in ("distinct_docs", "msn_lag_stream", "msn_advance")
    for cap in (8, 64, 128)
] + [
    ("local_and_acks", 128), ("pending_survives_compact", 128),
    ("capacity_overflow", 8), ("out_of_range", 64), ("collab_window", 64),
    ("writer_past_cap", 64),
]


def _ref_state(n_docs, cap, self_client):
    t, s = ref_pack(ref_make_batched_state(n_docs, cap, self_client))
    return np.asarray(t), np.asarray(s)


def _port_state(n_docs, cap, self_client):
    return K1.pack_state(
        make_batched_state(n_docs, cap, self_client, device="cpu")
    )


def _assert_packed_equal(want, got):
    wt, ws = (np.asarray(x) for x in want)
    gt, gs = (x.numpy() if isinstance(x, torch.Tensor) else x for x in got)
    for i in range(wt.shape[0]):
        np.testing.assert_array_equal(wt[i], gt[i], err_msg=f"lane {i}")
    np.testing.assert_array_equal(ws, gs, err_msg="scalars")


def _xla_packed(state):
    t, s = ref_pack(state)
    return np.asarray(t), np.asarray(s)


@pytest.mark.parametrize("case,cap", CASES)
def test_k1_k2_k3_match_reference(case, cap):
    batch, cap, me, err_bit = _case(case, cap)
    n_docs = batch.shape[0]
    blk = 2 if n_docs % 2 == 0 else 1

    # K1: Pallas (interpret) and XLA agree with the port's plain version.
    import jax.numpy as jnp

    rt, rs = _ref_state(n_docs, cap, me)
    p_t, p_s = ref_apply(jnp.asarray(rt), jnp.asarray(rs), jnp.asarray(batch),
                         block_docs=blk, interpret=True)
    pallas_k1 = (np.asarray(p_t), np.asarray(p_s))
    xla_k1 = _xla_packed(
        batched_apply_ops(ref_make_batched_state(n_docs, cap, me), batch)
    )
    tt, ts = _port_state(n_docs, cap, me)
    got = K1.apply_ops_packed(tt, ts, torch.from_numpy(batch))
    assert got[0] is tt and got[1] is ts  # in place, as the TPU donation
    _assert_packed_equal(pallas_k1, (tt, ts))
    _assert_packed_equal(xla_k1, (tt, ts))
    if err_bit:
        assert (ts[:, K1.SC_ERR] & err_bit != 0).all()

    # K2 on K1's output: Pallas compact and XLA compact.
    c_t, c_s = ref_compact(jnp.asarray(pallas_k1[0]),
                           jnp.asarray(pallas_k1[1]), interpret=True)
    xla_k2 = _xla_packed(batched_compact(
        ref_make_batched_state(n_docs, cap, me)._make(
            [jnp.asarray(x) for x in _unpack_np(*pallas_k1)]
        )
    ))
    K2.compact_packed(tt, ts)
    _assert_packed_equal((np.asarray(c_t), np.asarray(c_s)), (tt, ts))
    _assert_packed_equal(xla_k2, (tt, ts))

    # K3 in one call == the fused Pallas kernel.
    f_t, f_s = ref_apply_compact(jnp.asarray(rt), jnp.asarray(rs),
                                 jnp.asarray(batch), block_docs=8,
                                 interpret=True)
    t3, s3 = _port_state(n_docs, cap, me)
    K2.apply_compact_packed(t3, s3, torch.from_numpy(batch))
    _assert_packed_equal((np.asarray(f_t), np.asarray(f_s)), (t3, s3))


def _unpack_np(tables, scalars):
    return [tables[i] for i in range(tables.shape[0])] + [
        scalars[:, i] for i in range(5)
    ]


@pytest.mark.parametrize("seed", range(2))
def test_k3_equals_k1_then_k2_with_16_docs(seed):
    """16 docs with the reference's two 8-doc blocks: the fused port call
    equals apply then compact, and both equal the fused Pallas kernel."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + 40)
    ops = np.stack(random_acked_stream(
        rng, 40, {}, OracleDoc(NO_CLIENT), msn_lag=12
    ))
    batch = np.broadcast_to(ops, (16,) + ops.shape).astype(np.int32).copy()
    rt, rs = _ref_state(16, 128, NO_CLIENT)
    f_t, f_s = ref_apply_compact(jnp.asarray(rt), jnp.asarray(rs),
                                 jnp.asarray(batch), block_docs=8,
                                 interpret=True)
    t1, s1 = _port_state(16, 128, NO_CLIENT)
    K1.apply_ops_packed(t1, s1, torch.from_numpy(batch))
    K2.compact_packed(t1, s1)
    t2, s2 = _port_state(16, 128, NO_CLIENT)
    K2.apply_compact_packed(t2, s2, torch.from_numpy(batch))
    # K2 alone keeps scalar columns 5-7 and K3 writes them as 0: here both
    # are 0, so the whole scalar block matches.
    _assert_packed_equal((t1.numpy(), s1.numpy()), (t2, s2))
    _assert_packed_equal((np.asarray(f_t), np.asarray(f_s)), (t2, s2))


def test_port_text_matches_oracle():
    """One doc of a distinct-docs batch materializes to the oracle's text."""
    batch, payloads = _random_docs(5, 4, 32)
    tt, ts = _port_state(4, 128, NO_CLIENT)
    K1.apply_ops_packed(tt, ts, torch.from_numpy(batch))
    doc = OracleDoc(NO_CLIENT)
    for row in batch[3]:
        doc.apply(row)
    one = K1.unpack_state(tt[:, 3], ts[3])
    assert materialize(one, payloads) == doc.text(payloads)


def test_out_buffers_leave_inputs_untouched():
    """With ``out=``, the wrappers write a second buffer pair and leave the
    input state as it was (the copy-on-write path of the service)."""
    batch, _ = _random_docs(6, 2, 16)
    tt, ts = _port_state(2, 64, NO_CLIENT)
    before = (tt.clone(), ts.clone())
    ot, os_ = torch.empty_like(tt), torch.empty_like(ts)
    K2.apply_compact_packed(tt, ts, torch.from_numpy(batch), out=(ot, os_))
    assert torch.equal(tt, before[0]) and torch.equal(ts, before[1])
    want = K2.apply_compact_plain(tt, ts, torch.from_numpy(batch))
    assert torch.equal(ot, want[0]) and torch.equal(os_, want[1])


# -- tiers past the Pallas compact's 256 rows and the shared-memory tier -----


def _xla_state_after(batch, cap):
    """The reference XLA state of ``batch`` applied to empty docs of
    ``cap`` rows, as packed numpy arrays."""
    n_docs = batch.shape[0]
    return _xla_packed(batched_apply_ops(
        ref_make_batched_state(n_docs, cap, NO_CLIENT), batch))


@pytest.mark.parametrize("cap", [512, 4096])
def test_plain_compact_matches_xla_compact_past_256_rows(cap):
    """Above 256 rows the reference fleet compacts with the XLA
    ``batched_compact``; the port's one K2 matches it there too."""
    batch, _ = _random_docs(8, 2, 48, msn_lag=6, advance=True)
    rt, rs = _xla_state_after(batch, cap)
    want = _xla_packed(batched_compact(
        ref_make_batched_state(2, cap, NO_CLIENT)._make(
            [jnp.asarray(x) for x in _unpack_np(rt, rs)]
        )
    ))
    got = K2.compact_plain(torch.tensor(rt), torch.tensor(rs))
    _assert_packed_equal(want, got)
    assert int(got[1][:, K1.SC_COUNT].max()) > 0


def test_plain_apply_matches_xla_at_4096_rows():
    """K1's plain version at the first global-memory tier (D=2, K=8)."""
    batch, _ = _random_docs(9, 2, 8)
    cap = 4096
    want = _xla_state_after(batch, cap)
    tt, ts = _port_state(2, cap, NO_CLIENT)
    K1.apply_ops_packed(tt, ts, torch.from_numpy(batch))
    _assert_packed_equal(want, (tt, ts))


_TIERS = {8: "smem", 2048: "smem", 2049: "cluster", 2050: "cluster",
             4096: "cluster", 8192: "cluster", 16384: "cluster",
             16385: "global", 65536: "global"}


@pytest.mark.parametrize("entry", ["merge_apply", "merge_compact",
                                   "merge_apply_compact"])
@pytest.mark.parametrize("cap", sorted(_TIERS))
def test_wrappers_route_by_tier(entry, cap):
    """S up to 2,048 takes the shared-memory tier. Above it every entry
    (K1, K2 and K3) splits the table across a thread-block cluster up to
    16,384 rows and keeps it in global memory up to 65,536. The choice
    launches nothing."""
    from fluidframework_tpu_torch.ops import _cuda

    assert _cuda.tier(cap, entry) == _TIERS[cap]


def test_wrappers_refuse_past_the_largest_tier():
    from fluidframework_tpu_torch.ops import _cuda

    for entry in _cuda.ENTRIES:
        with pytest.raises(ValueError, match="65536"):
            _cuda.tier(_cuda.MAX_CAPACITY + 1, entry)
    t = torch.zeros((15, 1, 2 * _cuda.MAX_CAPACITY), dtype=torch.int32,
                    device="meta")
    s = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K2.compact_packed(t, s)


# -- K1's one row move per op (move_rows in csrc/merge_kernels.cu) ----------


def _one_move(L, e1, q1, l1, e2, q2, l2, ei, qi, new_row):
    """The kernel's move as one pass: final row r takes old row
    y = r - d(r) (zeros below row 0), then stage 1's and stage 2's split
    edits; the insert's row lands at qi. L is [N_LANES, S]."""
    s = L.shape[1]
    r = torch.arange(s)
    x = torch.where(ei & (r > qi), r - 1, r)
    x = torch.where(e2 & (r > q2), r - 1, x)
    y = torch.where(e1 & (x > q1), x - 1, x)
    out = torch.where(y >= 0, L[:, y.clamp(min=0)], torch.zeros_like(L))
    off, ln = out[K1.L_OFF], out[K1.L_LEN]
    ln = torch.where(e1 & (x == q1), l1, ln)
    off = torch.where(e1 & (x == q1 + 1), off + l1, off)
    ln = torch.where(e1 & (x == q1 + 1), ln - l1, ln)
    ln = torch.where(e2 & (r == q2), l2, ln)
    off = torch.where(e2 & (r == q2 + 1), off + l2, off)
    ln = torch.where(e2 & (r == q2 + 1), ln - l2, ln)
    out[K1.L_OFF], out[K1.L_LEN] = off, ln
    return torch.where((ei & (r == qi))[None], new_row[:, None], out)


def _sequential_moves(L, e1, q1, l1, e2, q2, l2, ei, qi, new_row):
    """The same op as apply_plain moves rows: split A, then split B or the
    insert, each a ``torch.where(col > edge, shift_right1(x), x)``."""
    col = torch.arange(L.shape[1])

    def shift1(L, do, edge):
        return torch.where(do & (col > edge), K1.shift_right1(L), L)

    def split(L, do, q, length):
        L = shift1(L, do, q).clone()
        L[K1.L_LEN] = torch.where(do & (col == q), length, L[K1.L_LEN])
        m = do & (col == q + 1)
        L[K1.L_OFF] = torch.where(m, L[K1.L_OFF] + length, L[K1.L_OFF])
        L[K1.L_LEN] = torch.where(m, L[K1.L_LEN] - length, L[K1.L_LEN])
        return L

    L = split(L, e1, q1, l1)
    L = split(L, e2, q2, l2)
    L = shift1(L, ei, qi - 1)
    return torch.where((ei & (col == qi))[None], new_row[:, None], L)


def _random_move(rng):
    """A random table of S <= 64 rows and the (stage 1, stage 2) move one
    op asks for, as apply_plain derives it from idx1/idx2/idxp and the
    capacity checks."""
    s = int(rng.integers(2, 65))
    count = int(rng.integers(0, s))
    L = torch.from_numpy(rng.integers(-50, 50, (K1.N_LANES, s)).astype(
        np.int32))
    kind = rng.choice(["insert", "range", "none"], p=[.45, .45, .1])
    has1 = bool(rng.random() < 0.7)
    idx1 = int(rng.integers(0, s))
    idx2 = idx1 if rng.random() < 0.3 else int(rng.integers(0, s))
    has2 = bool(rng.random() < 0.7)
    l1, l2 = (int(v) for v in rng.integers(-3, 9, 2))
    f = dict(e1=False, q1=idx1, l1=l1, e2=False, q2=0, l2=l2, ei=False,
             qi=0)
    if kind == "insert":
        sh = 2 if has1 else 1
        do_ins = count + sh <= s
        idxp = count if rng.random() < 0.3 else int(rng.integers(0, count
                                                                  + 1))
        f.update(e1=do_ins and has1, ei=do_ins,
                 qi=idx1 + 1 if has1 else idxp)
    elif kind == "range":
        do_a = has1 and count + 1 <= s
        do_b = has2 and count + do_a + 1 <= s
        f.update(e1=do_a, e2=do_b, q2=idx2 + int(do_a),
                 l2=l2 - l1 if do_a and idx1 == idx2 else l2)
    new_row = torch.from_numpy(rng.integers(-9, 9, K1.N_LANES).astype(
        np.int32))
    args = {k: torch.tensor(v) for k, v in f.items()}
    return L, args, new_row


@pytest.mark.parametrize("seed", range(8))
def test_one_move_equals_the_sequential_shifts(seed):
    """K1's kernel composes an op's splits and insert into one row move
    (move_rows): rows take the row d(r) in {0, 1, 2} below, then the split
    edits. Held against apply_plain's sequential shifts on random tables
    of up to 64 rows, edges anywhere (idx1 == idx2, the insert at count,
    no split, edges at the last row)."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        L, f, new_row = _random_move(rng)
        want = _sequential_moves(L, **f, new_row=new_row)
        got = _one_move(L, **f, new_row=new_row)
        assert torch.equal(got, want), {k: int(v) for k, v in f.items()}
        r = torch.arange(L.shape[1])
        x = torch.where(f["ei"] & (r > f["qi"]), r - 1, r)
        x = torch.where(f["e2"] & (r > f["q2"]), r - 1, x)
        d = r - torch.where(f["e1"] & (x > f["q1"]), x - 1, x)
        assert int(d.min()) >= 0 and int(d.max()) <= 2
        assert bool((d[1:] >= d[:-1]).all())  # top-down in place is safe


@pytest.mark.parametrize("cap", [72, 130])
def test_plain_apply_matches_xla_on_edge_moves(cap):
    """chip_smoke's edge_case (the moves the card tests use to hit tile and
    slice edges) through K1's plain version and the reference XLA
    kernel, from the same start state."""
    from chip_smoke import edge_case

    t0, s0, ops = edge_case(cap, "cpu")
    n_docs = t0.shape[1]
    state = ref_make_batched_state(n_docs, cap, NO_CLIENT)._make(
        [jnp.asarray(x) for x in _unpack_np(t0.numpy(), s0.numpy())])
    want = _xla_packed(batched_apply_ops(state, ops.numpy()))
    _assert_packed_equal(want, K1.apply_plain(t0, s0, ops))
    assert (want[1][:, K1.SC_COUNT] != s0[:, K1.SC_COUNT].numpy()).all()


# -- K2's one gather (compact_doc in csrc/merge_kernels.cu) -------------------


def _mergeable(q, r):
    """The sibling re-merge test (reference packParent subset): row q (the
    previous kept row) takes row r in. q, r: [N_LANES, n] lane values."""
    ok_q = ((q[K1.L_KIND] == KIND_TEXT) & (q[K1.L_RSEQ] == RSEQ_NONE)
            & (q[K1.L_ALSEQ] == 0) & (q[K1.L_LSEQ] == 0))
    ok_r = ((r[K1.L_KIND] == KIND_TEXT) & (r[K1.L_RSEQ] == RSEQ_NONE)
            & (r[K1.L_ALSEQ] == 0) & (r[K1.L_LSEQ] == 0)
            & (r[K1.L_SEQ] != UNASSIGNED_SEQ))
    same = torch.ones_like(ok_q)
    for lane in (K1.L_ORIG, K1.L_SEQ, K1.L_CLIENT, K1.L_ASEQ, K1.L_AVAL):
        same &= r[lane] == q[lane]
    end = (q[K1.L_OFF] + q[K1.L_LEN]).to(torch.int32)
    return ok_q & ok_r & same & (r[K1.L_OFF] == end)


def _one_gather(L, min_seq, block):
    """K2 as the kernel computes it, on one document's rows L
    [N_LANES, S]: warps of ``block`` rows each find every kept row's
    previous kept row within the warp and count heads with the warp's first
    kept row as one; one combine step finds, per warp, the last kept row
    before it and whether the warp's first kept row merges into it; output
    row h takes the h-th head's row, with LEN = plen(next head) -
    plen(head) (total for the last head). Returns (lanes, n_heads)."""
    s = L.shape[1]
    idx = torch.arange(s)
    kind, rseq = L[K1.L_KIND], L[K1.L_RSEQ]
    pending = (L[K1.L_LSEQ] != 0) | (L[K1.L_RLSEQ] != 0) | (L[K1.L_ALSEQ] != 0)
    reclaim = (~pending & (rseq != RSEQ_NONE) & (rseq != UNASSIGNED_SEQ)
               & (rseq <= min_seq))
    keep = (kind != KIND_FREE) & ~reclaim
    head = torch.zeros(s, dtype=torch.bool)
    firsts, lasts = [], []
    for w0 in range(0, s, block):
        rows = idx[w0:w0 + block]
        kept = rows[keep[rows]]
        firsts.append(int(kept[0]) if len(kept) else -1)
        lasts.append(int(kept[-1]) if len(kept) else -1)
        if len(kept):
            head[kept[0]] = True  # tentative
            head[kept[1:]] = ~_mergeable(L[:, kept[:-1]], L[:, kept[1:]])
    before = -1  # the last kept row of the earlier warps (exclusive max)
    for f, k in zip(firsts, lasts):
        if f >= 0 and before >= 0:
            head[f] = ~_mergeable(L[:, before:before + 1], L[:, f:f + 1])[0]
        before = max(before, k)
    src = idx[head]
    plen = K1.excl_cumsum(torch.where(keep, L[K1.L_LEN], 0))
    total = torch.where(keep, L[K1.L_LEN], 0).sum().to(torch.int32)
    p = plen[src]
    out = torch.zeros_like(L)
    out[K1.L_KIND] = KIND_FREE
    out[K1.L_RSEQ] = RSEQ_NONE
    nh = len(src)
    out[:, :nh] = L[:, src]
    out[K1.L_LEN, :nh] = (torch.cat([p[1:], total[None]]) - p).to(torch.int32)
    return out, nh


def _run_table(rng, s):
    """A table of ``s`` rows built as splits of a few inserts (runs of one
    orig, seq and client with contiguous offsets), with reclaimable and
    unreclaimable tombstones (some inside runs), pending stamps, UNASSIGNED
    seqs, free rows in the middle and at the end, and other row kinds.
    min_seq is 10: acked removals at seq 1-10 are reclaimed."""
    n_live = int(rng.integers(0, s + 1))
    rows = np.zeros((K1.N_LANES, s), np.int64)
    rows[K1.L_RSEQ] = RSEQ_NONE
    prev = None
    for r in range(n_live):
        if prev is not None and rng.random() < 0.6:
            v = prev.copy()
            v[K1.L_OFF] = prev[K1.L_OFF] + prev[K1.L_LEN]
        else:
            v = np.zeros(K1.N_LANES, np.int64)
            v[K1.L_ORIG] = rng.integers(1, 4)
            v[K1.L_OFF] = rng.integers(0, 4)
            v[K1.L_SEQ] = rng.integers(1, 4)
            v[K1.L_CLIENT] = rng.integers(0, 2)
            v[K1.L_ASEQ] = rng.integers(0, 2)
            v[K1.L_AVAL] = v[K1.L_ASEQ] * rng.integers(1, 3)
        v[K1.L_KIND] = KIND_TEXT if rng.random() < 0.95 else 2
        v[K1.L_LEN] = rng.integers(0, 5)
        v[K1.L_RSEQ] = rng.choice([RSEQ_NONE, int(rng.integers(1, 21)),
                                   UNASSIGNED_SEQ], p=[.55, .35, .1])
        v[K1.L_RLSEQ] = rng.integers(1, 5) if rng.random() < 0.05 else 0
        v[K1.L_LSEQ] = rng.integers(1, 5) if rng.random() < 0.05 else 0
        v[K1.L_ALSEQ] = rng.integers(1, 5) if rng.random() < 0.05 else 0
        if rng.random() < 0.05:
            v[K1.L_SEQ] = UNASSIGNED_SEQ
        if rng.random() < 0.03:  # a free row among the live ones
            v = np.zeros(K1.N_LANES, np.int64)
            v[K1.L_RSEQ] = RSEQ_NONE
        rows[:, r] = v
        prev = v
    return torch.from_numpy(rows.astype(np.int32))


def _edge_tables():
    """Tables the formula has to get right at its seams (min_seq 10): every
    row reclaimed; none reclaimed; a run whose middle row is reclaimed
    (the run breaks there); a run broken only by a reclaimed zero-length
    row (it merges across it); the first kept row after a reclaimed run;
    an UNASSIGNED seq and pending stamps inside a run."""
    def run(n, **lanes):
        t = torch.zeros((K1.N_LANES, n), dtype=torch.int32)
        t[K1.L_KIND] = KIND_TEXT
        t[K1.L_ORIG] = 3
        t[K1.L_LEN] = 2
        t[K1.L_OFF] = 2 * torch.arange(n, dtype=torch.int32)
        t[K1.L_SEQ] = 5
        t[K1.L_RSEQ] = RSEQ_NONE
        for lane, (r, v) in lanes.items():
            t[getattr(K1, lane), r] = v
        return t

    every = run(40)
    every[K1.L_RSEQ] = 7
    none = run(40)
    zero = run(8)
    zero[K1.L_LEN, 4] = 0
    zero[K1.L_RSEQ, 4] = 9
    zero[K1.L_OFF, 5:] -= 2
    after = run(70)
    after[K1.L_RSEQ, :33] = 3
    return [every, none, run(40, L_RSEQ=(20, 8)), zero, after,
            run(40, L_SEQ=(31, UNASSIGNED_SEQ)), run(40, L_LSEQ=(32, 1)),
            run(40, L_RLSEQ=(33, 2), L_RSEQ=(33, 4)),
            run(40, L_ALSEQ=(30, 1))]


@pytest.mark.parametrize("seed", range(8))
def test_one_gather_equals_squeeze_then_merge(seed):
    """K2's kernel composes the reclaim squeeze and the merge squeeze into
    one gather on the original rows (compact_doc). Held bit for bit
    against _compact_values on random tables of 1-70 rows and on the edge
    tables, with warps of 8 and 32 rows (so a warp's first kept row merges
    into a row several warps back, or into none)."""
    rng = np.random.default_rng(seed)
    tables = [_run_table(rng, int(rng.integers(1, 71))) for _ in range(50)]
    if seed == 0:
        tables += _edge_tables()
    min_seq = torch.tensor([[10]], dtype=torch.int32)
    for L in tables:
        want, n_heads = K2._compact_values(L[:, None, :], min_seq)
        for block in (8, 32):
            got, nh = _one_gather(L, 10, block)
            assert nh == int(n_heads), block
            assert torch.equal(got, want[:, 0]), block


@pytest.mark.parametrize("cap", [72, 130])
def test_plain_compact_matches_xla_on_compaction_edges(cap):
    """chip_smoke's compact_edge_case (the compactions the card holds K2
    and K3 on at every tier) through K2's plain version, the reference XLA
    compact and the one-gather formula, from the same start state: one
    merge run over the whole table, none, and the rest in between."""
    from chip_smoke import compact_edge_case

    t0, s0, _ops = compact_edge_case(cap, "cpu")
    n_docs = t0.shape[1]
    state = ref_make_batched_state(n_docs, cap, NO_CLIENT)._make(
        [jnp.asarray(x) for x in _unpack_np(t0.numpy(), s0.numpy())])
    want = _xla_packed(batched_compact(state))
    got = K2.compact_plain(t0, s0)
    _assert_packed_equal(want, got)
    heads = got[1][:, K1.SC_COUNT].tolist()
    assert heads[0] == 1 and heads[1] == 0 and heads[4] == 1
    assert heads[6] == 1 and heads[7] >= 4
    for d in range(n_docs):
        lanes, nh = _one_gather(t0[:, d], 10, 32)
        assert nh == heads[d]
        assert torch.equal(lanes, got[0][:, d])
