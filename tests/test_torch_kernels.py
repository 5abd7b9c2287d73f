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
    OP_WIDTH,
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


# Each width's tier: one for every document count, or (below the card's
# SM count of documents, from it) where the count decides K1's and K3's
# (K2 keeps the second).
_TIERS = {8: "smem", 64: "smem", 128: "smem", 256: "smem", 512: "smem",
          2048: "smem", 2049: "cluster", 2050: "cluster",
          4096: "cluster", 8192: "cluster", 16384: "cluster",
          16385: ("split", "global"), 65536: ("split", "global"),
          65537: "split", 131072: "split", 524288: "split",
          1 << 30: "split"}
# K1's and K3's warp tier: for tables of up to each width's rows, the
# fewest documents a launch takes it from (None: never), whatever the
# card's SM count (chip_smoke.py --narrow's sweep on an H100).
_WARP_FROM = {64: 2048, 128: 2048, 256: None, 512: None}


@pytest.mark.parametrize("entry", ["merge_apply", "merge_compact",
                                   "merge_apply_compact"])
@pytest.mark.parametrize("cap", sorted(_TIERS))
def test_wrappers_route_by_tier(entry, cap):
    """S up to 2,048 takes the shared-memory tier, but a K1 or K3 launch
    of tables of up to 128 rows takes the warp tier from 2,048 documents
    (K2 never). Above 2,048 rows every entry
    (K1, K2 and K3) splits the table across a thread-block cluster up to
    16,384 rows; up to 65,536 a K1 or K3 launch of as many documents as
    the card has SMs or more (and every K2 launch) keeps each in global
    memory (the global tier), and a K1 or K3 launch of fewer, like every
    table past 65,536 rows up to 2**30, spreads each document over a
    cluster of up to 16 CTAs there (the split tier: each document gets
    ceil(SMs / D) >= 2 CTAs). Held at document counts on both sides of
    each threshold, on the H100's 132 SMs and on other SM counts. The
    choice launches nothing and asks no card."""
    from fluidframework_tpu_torch.ops import _cuda

    few, many = (_TIERS[cap] if isinstance(_TIERS[cap], tuple)
                 else (_TIERS[cap],) * 2)
    if entry == "merge_compact":
        few = many
    warp_from = None
    if entry != "merge_compact" and cap <= 512:
        warp_from = _WARP_FROM[min(w for w in _WARP_FROM if cap <= w)]
    assert _cuda.WARP_MIN_DOCS == _WARP_FROM
    for sms in (132, 114, 8):
        for n in (1, 2, sms // 2, sms - 1, sms, sms + 1, 2047, 2048, 2049,
                  100_000):
            want = few if n < sms else many
            if warp_from is not None and n >= warp_from:
                want = "warp"
            assert _cuda.tier(cap, entry, n, sms) == want, (sms, n)


def test_wrappers_refuse_past_the_largest_tier():
    from fluidframework_tpu_torch.ops import _cuda

    assert _cuda.MAX_CAPACITY == 1 << 30
    for entry in _cuda.ENTRIES:
        with pytest.raises(ValueError, match="1073741824"):
            _cuda.tier(_cuda.MAX_CAPACITY + 1, entry, 1)
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


# -- the global and split tiers walk the rows below count + 2K --------------


def _warp_blocks(live, c, nw, sl=None):
    """The rows each warp walks, as merge_kernel cuts them: ``c`` slices of
    SL = ceil(live / c) rows rounded up to 32 (or ``sl``: K2's slices on
    the cluster tier, the host's), warp w of a slice the w-th block of RW
    rows (a whole number of 32-row tiles), each clipped to [0, live);
    [lo, hi) as rows of the whole table, in (CTA, warp) order."""
    if sl is None:
        sl = (-(-live // c) + 31) // 32 * 32
    rw = ((sl + 31) // 32 + nw - 1) // nw * 32
    out = []
    for rank in range(c):
        base = rank * sl
        n = max(0, min(sl, live - base))
        for w in range(nw):
            lo = min(w * rw, n)
            out.append((base + lo, base + min(lo + rw, n)))
    return out


def _move_in_blocks(L, mv, new_row, blocks, rng):
    """move_rows over the warp ``blocks`` of L [N_LANES, S] (int32, in
    place): each warp whose bottom tile moves saves the two rows below its
    block (zeros below row 0); one barrier; then the warps walk their
    tiles top down, in a random order (any order of the warps is one the
    card may run), each tile taking row r's source y = r - d(r) from the
    tile or from the two rows below it, then the split edits."""
    e1, q1, l1, e2, q2, l2, ei, qi = mv
    low = min([q for e, q in ((e1, q1), (e2, q2), (ei, qi)) if e],
              default=None)
    if low is None:
        return

    def below(t0):
        return [L[:, r].copy() if r >= 0 else np.zeros(K1.N_LANES, np.int32)
                for r in (t0 - 1, t0 - 2)]

    walks = []
    for lo, hi in blocks:
        t_bot = lo if low <= lo else lo + (low - lo) // 32 * 32
        if t_bot < hi:
            walks.append((lo, hi, t_bot, below(lo) if t_bot == lo else None))
    for i in rng.permutation(len(walks)):
        lo, hi, t_bot, bnd = walks[i]
        for t0 in range(lo + (hi - 1 - lo) // 32 * 32, t_bot - 1, -32):
            top = min(t0 + 32, hi)
            cur = L[:, t0:top].copy()
            under = bnd if t0 == lo else below(t0)
            for r in range(max(t0, low), top):
                x = r - 1 if ei and r > qi else r
                x = r - 1 if e2 and r > q2 else x
                y = x - 1 if e1 and x > q1 else x
                v = (cur[:, y - t0] if y >= t0 else under[t0 - 1 - y]).copy()
                if ei and r == qi:
                    v = new_row.copy()
                else:
                    if e1 and x == q1:
                        v[K1.L_LEN] = l1
                    if e1 and x == q1 + 1:
                        v[K1.L_OFF] += l1
                        v[K1.L_LEN] -= l1
                    if e2 and r == q2:
                        v[K1.L_LEN] = l2
                    if e2 and r == q2 + 1:
                        v[K1.L_OFF] += l2
                        v[K1.L_LEN] -= l2
                L[:, r] = v


def _first(mask, none):
    hits = np.flatnonzero(mask)
    return int(hits[0]) if len(hits) else none


def _i32(v):
    return torch.tensor([[v]], dtype=torch.int32)


def _marks(w, cov, ty, op, local_op):
    """An op's covered-row marks and acks on rows w [N_LANES, n] (in
    place), as K1's last pass writes them."""
    (_ty, _p1, _p2, seqn, _ref, clientn, lseqn, arg, _len, _msn) = op
    rseq, rlseq = w[K1.L_RSEQ].copy(), w[K1.L_RLSEQ].copy()
    aseq, alseq = w[K1.L_ASEQ].copy(), w[K1.L_ALSEQ].copy()
    if ty == 2:
        unrem = rseq == RSEQ_NONE
        rlseq = np.where(cov & unrem & local_op, lseqn, rlseq)
        rseq = np.where(cov & (unrem | (rseq == UNASSIGNED_SEQ)), seqn, rseq)
        for lane, bit in zip((K1.L_RBITS, K1.L_RBITS2, K1.L_RBITS3),
                             K1.writer_bits(_i32(clientn))):
            w[lane] = np.where(cov, w[lane] | int(bit), w[lane])
    if ty == 3:
        m = cov & (local_op | (alseq == 0))
        w[K1.L_AVAL] = np.where(m, arg, w[K1.L_AVAL])
        aseq = np.where(m, seqn, aseq)
        alseq = np.where(m, lseqn if local_op else 0, alseq)
    liv = w[K1.L_KIND] != KIND_FREE
    if ty == 4:
        m = liv & (w[K1.L_SEQ] == UNASSIGNED_SEQ) & (w[K1.L_LSEQ] == lseqn)
        w[K1.L_SEQ] = np.where(m, seqn, w[K1.L_SEQ])
        w[K1.L_LSEQ] = np.where(m, 0, w[K1.L_LSEQ])
    if ty == 5:
        m = liv & (rlseq == lseqn)
        rseq = np.where(m & (rseq == UNASSIGNED_SEQ), seqn, rseq)
        rlseq = np.where(m, 0, rlseq)
    if ty == 6:
        m = liv & (alseq == lseqn)
        aseq = np.where(m, seqn, aseq)
        alseq = np.where(m, 0, alseq)
    w[K1.L_RSEQ], w[K1.L_RLSEQ] = rseq, rlseq
    w[K1.L_ASEQ], w[K1.L_ALSEQ] = aseq, alseq


def _op_blocks(blocks, live, count, op_cut):
    """The warp blocks one op of K1 walks: with ``op_cut`` (the shared
    tier's walk) the launch's ``blocks`` each clipped to the rows
    below min(live, count + 2), count the op's own; else the launch's."""
    rows = min(live, min(max(count, 0), live) + 2)
    if op_cut:
        return [(lo, max(lo, min(hi, rows))) for lo, hi in blocks]
    return blocks


def _model_apply(t, sc, ops, c, nw, rng, op_cut=0):
    """K1 on the global, split, cluster and shared tiers for one document
    (t [N_LANES, S], sc [N_SCALARS], ops [K, OP_WIDTH]), as the kernel walks
    it: the live rows min(S, count + 2K) (``_cuda.live_rows``) cut into
    ``c`` slices of ``nw`` warp blocks, fixed for the launch (on the shared
    tier clipped for each op with ``op_cut``, :func:`_op_blocks`); each op's
    perspective, prefix and first hits over those rows alone (S where
    none), the capacity checks against S, one row move in the blocks
    (:func:`_move_in_blocks`), the covered rows' marks over the live rows.
    Rows past them are never read or written. Returns (t, sc)."""
    from fluidframework_tpu_torch.ops import _cuda

    L = t.astype(np.int32).copy()
    s = L.shape[1]
    count, min_seq, cur_seq, me, err = (int(v) for v in sc[:5])
    live = _cuda.live_rows(s, count, len(ops))
    blocks = _warp_blocks(live, c, nw)
    for op in ops:
        op = [int(v) for v in op]
        ty, pos1, pos2, seqn, refn, clientn, lseqn, arg, ilen, msn = op
        is_ins, is_range = ty == 1, ty in (2, 3)
        local_op = seqn == UNASSIGNED_SEQ
        if clientn >= 93:
            err |= ERR_CLIENT

        def perspective():
            Lt = torch.from_numpy(L[:, None, :live].copy())
            part, vis = K1._perspective(Lt, _i32(clientn), _i32(refn),
                                        _i32(clientn) == _i32(me),
                                        _i32(min_seq))
            return Lt, part, vis, K1.excl_cumsum(vis)

        if is_ins or is_range:
            Lt, part, vis, prefix = perspective()
            total = int(vis.sum().to(torch.int32))
            rem1 = (pos1 - prefix).to(torch.int32)
            rem2 = (pos2 - prefix).to(torch.int32)
            h1 = (part & (vis > 0) & (rem1 > 0) & (rem1 < vis))[0].numpy()
            h2 = (part & (vis > 0) & (rem2 > 0) & (rem2 < vis))[0].numpy()
            hp = K1.insert_place_mask(Lt, _i32(seqn), part, vis,
                                      rem1)[0].numpy()
            idx1, idx2, mp = _first(h1, s), _first(h2, s), _first(hp, s)
            has1, has2, hasp = idx1 < s, idx2 < s, mp < s
            split1 = int(rem1[0, idx1]) if has1 else 0
            split2 = int(rem2[0, idx2]) if has2 else 0
            idxp = mp if hasp else count
            sh = 2 if has1 else 1
            do_ins = is_ins and count + sh <= s
            do_a = is_range and has1 and count + 1 <= s
            count_a = count + do_a
            do_b = is_range and has2 and count_a + 1 <= s
            if (is_ins and not do_ins) or (is_range and has1 and not do_a) \
                    or (is_range and has2 and not do_b):
                err |= ERR_CAPACITY
            if (is_ins and not hasp and pos1 > total) or (
                    is_range and pos2 > total):
                err |= ERR_RANGE
            new_row = np.zeros(K1.N_LANES, np.int32)
            new_row[[K1.L_KIND, K1.L_ORIG, K1.L_LEN, K1.L_SEQ, K1.L_CLIENT,
                     K1.L_LSEQ, K1.L_RSEQ]] = [
                KIND_TEXT, arg, ilen, seqn, clientn,
                lseqn if local_op else 0, RSEQ_NONE]
            mv = (do_a or (do_ins and has1), idx1, split1, do_b,
                  idx2 + int(do_a),
                  split2 - split1 if do_a and idx1 == idx2 else split2,
                  do_ins, idx1 + 1 if has1 else idxp)
            _move_in_blocks(L, mv, new_row,
                            _op_blocks(blocks, live, count, op_cut), rng)
            count = (count_a + do_b if is_range
                     else count + sh if do_ins else count)
        if is_range or ty in (4, 5, 6):
            _Lt, part, vis, prefix = perspective()
            cov = (part & (vis > 0) & (prefix >= pos1)
                   & (prefix + vis <= pos2))[0].numpy() & is_range
            _marks(L[:, :live], cov, ty, op, local_op)
        cur_seq, min_seq = max(cur_seq, seqn), max(min_seq, msn)
    out = np.zeros_like(sc)
    out[:5] = count, min_seq, cur_seq, me, err
    return L, out


def _live_case(s, counts, ops):
    """Documents of ``s`` rows holding ``counts[d]`` live 4-character rows
    each (row r at visible position 4r; distinct orig and seq, so nothing
    merges), free rows past count, and the op rows ``ops`` [D, K, 10]."""
    d = len(counts)
    r = np.arange(s)
    t = np.zeros((K1.N_LANES, d, s), np.int32)
    t[K1.L_RSEQ] = RSEQ_NONE
    for i, c in enumerate(counts):
        live = r < c
        t[K1.L_KIND, i] = np.where(live, KIND_TEXT, KIND_FREE)
        t[K1.L_ORIG, i] = np.where(live, 1 + r, 0)
        t[K1.L_LEN, i] = np.where(live, 4, 0)
        t[K1.L_SEQ, i] = np.where(live, 1 + r % 50, 0)
    sc = np.zeros((d, K1.N_SCALARS), np.int32)
    sc[:, K1.SC_COUNT] = counts
    sc[:, K1.SC_CUR_SEQ] = 100
    sc[:, K1.SC_SELF] = NO_CLIENT
    return t, sc, np.asarray(ops, np.int32)


def _edge_ops(s, c, k=4):
    """(counts, ops) of one document each at the live range's seams, for
    ``c`` slices: count 0 (inserts into the empty table), count = S
    (every insert and split refused, an annotate across the table), count
    on a slice edge (inserts that split the row below it), the insert at
    count (the new rows at the live range's end), and a remove across
    three slices."""
    from fluidframework_tpu_torch.ops import _cuda

    def sl(count):
        return (-(-_cuda.live_rows(s, count, k) // c) + 31) // 32 * 32

    def ins(p, j):
        return E.insert(p, 7 + j, 3, seq=101 + j, ref=100 + j, client=1)

    on_edge = next((n for n in range(s - 2 * k, 0, -1) if n % sl(n) == 0),
                   (s - 2 * k) // 32 * 32)  # one slice: a tile's edge
    n, m = s // 2, s - 2 * k
    docs = [(0, [ins(0, j) for j in range(k)]),
            (s, [ins(2, 0), E.remove(3, 9, seq=102, ref=101, client=2),
                 E.annotate(1, 4 * s - 1, 5, seq=103, ref=102, client=1),
                 ins(4 * s, 3)]),
            (on_edge, [ins(4 * on_edge - 2, j) for j in range(k)]),
            (n, [ins(4 * n + 3 * j, j) for j in range(k)]),
            (m, [E.remove(2, 4 * min(3 * sl(m), m) - 2, seq=101, ref=100,
                          client=2)] + [ins(1 + j, j) for j in range(1, k)])]
    return [d[0] for d in docs], np.stack([np.stack(o[:k]) for _c, o in docs])


def _model_all(t, sc, ops, c, nw, seed, op_cut=0):
    rng = np.random.default_rng(seed)
    got_t, got_s = t.copy(), sc.copy()
    for d in range(t.shape[1]):
        got_t[:, d], got_s[d] = _model_apply(t[:, d], sc[d], ops[d], c, nw,
                                             rng, op_cut)
    return got_t, got_s


# (slices C, warps a CTA): the split tier's (1-16 CTAs of 16 warps), the
# global tier's (1 x 16), the shared tier's launch cut (1 x 8; each op's
# clip of it: test_shared_tier_op_cut_equals_the_plain_apply) and the
# cluster tier's (3 and 16 CTAs of 8 warps), and narrower cuts.
@pytest.mark.parametrize("c,nw", [(1, 1), (1, 16), (2, 2), (3, 1), (5, 2),
                                  (16, 16), (1, 8), (3, 8), (16, 8)])
def test_live_row_loop_equals_the_plain_apply(c, nw, op_cut=0):
    """K1's tiers walk the rows below min(S, count + 2K) only, cut into C
    slices of warp blocks fixed for the launch, and each op moves them
    once across the blocks' edges (warps in any order).
    Held against apply_plain (which walks every row) and the reference
    XLA kernel at count 0, count = S, count on a slice edge, the insert at
    count and a remove across three slices, and on random states."""
    from tools.kernel_sanitize import random_case

    s = 200
    counts, ops = _edge_ops(s, c)
    t, sc, ops = _live_case(s, counts, ops)
    got = _model_all(t, sc, ops, c, nw, c * 100 + nw, op_cut)
    want = K1.apply_plain(torch.from_numpy(t), torch.from_numpy(sc),
                          torch.from_numpy(ops))
    _assert_packed_equal((want[0].numpy(), want[1].numpy()), got)
    state = ref_make_batched_state(len(counts), s, NO_CLIENT)._make(
        [jnp.asarray(x) for x in _unpack_np(t, sc)])
    _assert_packed_equal(_xla_packed(batched_apply_ops(state, ops)), got)
    errs, got_counts = got[1][:, K1.SC_ERR], got[1][:, K1.SC_COUNT]
    assert errs[1] & ERR_CAPACITY and not errs[[0, 2, 3, 4]].any()
    assert got_counts[0] == 4 and got_counts[3] == s // 2 + 4
    assert got_counts[4] >= s - 2 * 4 + 2 + 3  # 2 splits, 3 inserts
    for seed in range(3):
        rt, rs, rops = random_case(np.random.default_rng(seed), 6, 96, 5,
                                   "cpu")
        want = K1.apply_plain(rt, rs, rops)
        got = _model_all(rt.numpy(), rs.numpy(), rops.numpy(), c, nw, seed,
                         op_cut)
        _assert_packed_equal((want[0].numpy(), want[1].numpy()), got)


def test_shared_tier_op_cut_equals_the_plain_apply():
    """The shared tier's per-op clip (each warp's block of the launch's
    cut clipped to the rows below count + 2) on the cases of
    :func:`test_live_row_loop_equals_the_plain_apply`, and on a document
    whose count + 2 passes 256 rows, where a warp's block of 64 rows
    starts to walk (inserts and splits that move every row up)."""
    op_cut = 1
    test_live_row_loop_equals_the_plain_apply(1, 8, op_cut)
    s, k = 320, 12
    ops = np.stack([E.insert(2 + 5 * j, 7 + j, 3, seq=101 + j, ref=100 + j,
                             client=1) for j in range(k)])
    t, sc, ops = _live_case(s, [250], ops[None])
    got = _model_all(t, sc, ops, 1, 8, op_cut, op_cut)
    want = K1.apply_plain(torch.from_numpy(t), torch.from_numpy(sc),
                          torch.from_numpy(ops))
    _assert_packed_equal((want[0].numpy(), want[1].numpy()), got)
    assert got[1][0, K1.SC_COUNT] >= 250 + k


def _assert_rows_past_count_free(tables, scalars, what):
    """Every row at or past a table's count holds its lane's fill."""
    from fluidframework_tpu_torch.ops.segment_state import (
        LANE_FILLS,
        SEGMENT_LANES,
    )

    tables, scalars = torch.as_tensor(tables), torch.as_tensor(scalars)
    fills = torch.tensor([LANE_FILLS.get(n, 0) for n in SEGMENT_LANES],
                         dtype=tables.dtype)
    for d in range(tables.shape[1]):
        c = int(scalars[d, K1.SC_COUNT])
        assert 0 <= c <= tables.shape[2], (what, d, c)
        assert bool((tables[:, d, c:] == fills[:, None]).all()), (what, d, c)


def _fleet_ops(rng, streams, seqs, k, n_docs):
    """The next ``k`` ops of each document's fuzz stream (NOOPs past its
    end), as one [n_docs, k, OP_WIDTH] round."""
    ops = np.zeros((n_docs, k, OP_WIDTH), np.int32)
    for d in range(n_docs):
        take = streams[d][seqs[d]:seqs[d] + k]
        ops[d, :len(take)] = take
        seqs[d] += len(take)
    return ops


@pytest.mark.parametrize("seed", range(2))
def test_every_table_writer_leaves_rows_past_count_free(seed):
    """The invariant every tier rests on (each walks, loads and stores
    only the rows below count): every row at or
    past a table's count holds its lane's fill. Held after every port path
    that writes a table, on fuzz streams (``testing/fuzz.py``): K1, K2 and
    K3's plain versions (also on random states with every err branch),
    ``grow``, a DocFleet through promotion, compaction, demotion,
    ``evict_doc`` and ``restore_doc``, a ShardedDoc through its ops,
    ``compact``, ``rebalance``, ``load_single`` and ``load_state``, and the
    fleet service's commits (K1, and K3 on its compaction cadence) in
    place and into fresh buffers while a scribe sweep is open."""
    from fluidframework_tpu_torch.ops.segment_state import (
        SEGMENT_LANES,
        grow,
        to_packed,
    )
    from fluidframework_tpu_torch.parallel.fleet import DocFleet
    from fluidframework_tpu_torch.parallel.mesh import Mesh
    from fluidframework_tpu_torch.parallel.sharded_doc import ShardedDoc
    from fluidframework_tpu_torch.testing.fuzz import (
        random_acked_stream as port_stream,
    )
    from fluidframework_tpu_torch.testing.oracle import OracleDoc as PortDoc
    from tools.kernel_sanitize import random_case

    rng = np.random.default_rng(seed)
    t, s, ops = random_case(rng, 16, 64, 12, "cpu")
    _assert_rows_past_count_free(t, s, "random_case")
    for name, out in (("K1", K1.apply_plain(t, s, ops)),
                      ("K2", K2.compact_plain(t, s)),
                      ("K3", K2.apply_compact_plain(t, s, ops))):
        _assert_rows_past_count_free(*out, name)
    batch, _ = _random_docs(seed + 20, 4, 48, msn_lag=6, advance=True)
    tt, ts = _port_state(4, 96, NO_CLIENT)
    K1.apply_ops_packed(tt, ts, torch.from_numpy(batch))
    _assert_rows_past_count_free(tt, ts, "K1 on a fuzz stream")
    g = grow(K1.unpack_state(tt, ts), 192)
    _assert_rows_past_count_free(*to_packed(g)[:2], "grow")

    n_docs, k, n_ops = 4, 8, 400
    texts = [(PortDoc(NO_CLIENT), {}) for _ in range(n_docs)]
    streams = [np.stack(port_stream(np.random.default_rng(seed * 10 + d),
                                    n_ops, pay, doc, msn_lag=8,
                                    caught_up=True))
               for d, (doc, pay) in enumerate(texts)]
    seqs = [0] * n_docs
    fleet = DocFleet(n_docs, 16, high_water=0.75, max_capacity=256,
                     low_water=0.45, kernel="plain", device="cpu")

    def pools(what):
        for cap, pool in fleet.pools.items():
            live = pool.live_slots()
            if live.size:
                _assert_rows_past_count_free(pool.tables[:, live],
                                             pool.scalars[live],
                                             f"{what} ({cap})")

    for r in range(50):
        fleet.apply(_fleet_ops(rng, streams, seqs, k, n_docs))
        pools("apply")
        fleet.check_and_migrate()
        pools("check_and_migrate")
        if r % 4 == 3:
            fleet.compact()
            pools("compact")
            fleet.check_and_demote()
            pools("check_and_demote")
    # Every document's text removed and the window moved past it: the
    # compaction empties the tables and the demotion steps them down.
    fleet.apply(np.stack([np.stack([
        E.remove(0, len(doc.text(pay)), seq=n_ops + 1, ref=n_ops, client=0,
                 msn=n_ops),
        E.noop(seq=n_ops + 2, msn=n_ops + 1)]) for doc, pay in texts]))
    pools("apply")
    for _ in range(2):
        fleet.compact()
        pools("compact")
        fleet.check_and_demote()
        pools("check_and_demote")
    assert fleet.migrations > 0 and fleet.demotions > 0
    for d in (0, 2):
        st = fleet.evict_doc(d)
        _assert_rows_past_count_free(
            np.stack([np.asarray(getattr(st, n)) for n in SEGMENT_LANES])[
                :, None], [[int(st.count)]], "evict_doc")
        fleet.restore_doc(d, st)
    pools("restore_doc")

    doc = ShardedDoc(64, mesh=Mesh(["cpu"] * 4, "seg"), kernel="plain")

    def shards(what):
        for grp in doc._groups:
            _assert_rows_past_count_free(grp.tables, grp.scalars, what)

    stream = np.stack(port_stream(np.random.default_rng(seed + 5), 240, {},
                                  PortDoc(NO_CLIENT), msn_lag=8))
    for i in range(0, len(stream), 24):
        doc.apply(stream[i:i + 24])
        shards("sharded apply")
        if i % 48 == 24:
            doc.compact()
            shards("sharded compact")
    assert doc.rebalance(trigger=0.1)
    shards("rebalance")
    doc.load_single(doc.to_single())
    shards("load_single")
    doc.load_state(doc.state)
    shards("load_state")

    from chip_smoke import RoundGen
    from fluidframework_tpu_torch.service.fleet_service import (
        TpuFleetService,
    )

    svc = TpuFleetService(8, capacity=64, compact_every=2, device="cpu")
    svc.join_writer(0)
    gen = RoundGen(8, 8, seed=seed)
    for r in range(6):
        pend = svc.begin_summarize_dirty(1) if r % 3 == 1 else None
        held = svc.tables
        svc.submit_round(*gen(svc))
        assert (svc.tables is held) == (pend is None)
        _assert_rows_past_count_free(svc.tables, svc.scalars,
                                     f"fleet service commit {r}")
        if pend is not None:
            pend.finish()


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
    plen(head) (total for the last head). ``block`` may instead list the
    warps' row ranges (lo, hi), empty ones among them: rows outside every
    range are not walked (they lie at or past count, free). Returns
    (lanes, n_heads)."""
    s = L.shape[1]
    blocks = ([(w0, min(w0 + block, s)) for w0 in range(0, s, block)]
              if isinstance(block, int) else block)
    idx = torch.arange(s)
    kind, rseq = L[K1.L_KIND], L[K1.L_RSEQ]
    pending = (L[K1.L_LSEQ] != 0) | (L[K1.L_RLSEQ] != 0) | (L[K1.L_ALSEQ] != 0)
    reclaim = (~pending & (rseq != RSEQ_NONE) & (rseq != UNASSIGNED_SEQ)
               & (rseq <= min_seq))
    walked = torch.zeros(s, dtype=torch.bool)
    for lo, hi in blocks:
        walked[lo:hi] = True
    keep = (kind != KIND_FREE) & ~reclaim & walked
    head = torch.zeros(s, dtype=torch.bool)
    firsts, lasts = [], []
    for lo, hi in blocks:
        rows = idx[lo:hi]
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


def _model_store(L, count, min_seq, c, threads, rows, k=0):
    """K2 on the global and split tiers for one document (L [N_LANES, S]),
    as its store runs: the heads of the rows below live = min(S, count +
    2k) (``_cuda.live_rows``; k the ops K3 applies first), the first row
    that is not a head, then the output rows from the one below it up to
    live in rounds of ``rows`` rows a thread over ``c`` CTAs of
    ``threads`` threads: a round loads its rows' sources, one barrier,
    stores them. Asserts that a round reads no row an earlier round wrote
    and writes no row a later round reads. Returns (lanes, n_heads)."""
    from fluidframework_tpu_torch.ops import _cuda

    s = L.shape[1]
    live = _cuda.live_rows(s, count, k)
    w = L[:, :live]
    pending = (w[K1.L_LSEQ] != 0) | (w[K1.L_RLSEQ] != 0) | (
        w[K1.L_ALSEQ] != 0)
    rseq = w[K1.L_RSEQ]
    keep = (w[K1.L_KIND] != KIND_FREE) & ~(
        ~pending & (rseq != RSEQ_NONE) & (rseq != UNASSIGNED_SEQ)
        & (rseq <= min_seq))
    head = keep.clone()
    kept = torch.arange(live)[keep]
    head[kept[1:]] = ~_mergeable(w[:, kept[:-1]], w[:, kept[1:]])
    src = torch.arange(live)[head]
    nh = len(src)
    plen = K1.excl_cumsum(torch.where(keep, w[K1.L_LEN], 0))
    total = int(torch.where(keep, w[K1.L_LEN], 0).sum().to(torch.int32))
    moved = (~head).nonzero()
    first_move = int(moved[0]) if len(moved) else live
    lo = max(first_move - 1, 0)
    out = L.clone()
    n_threads = c * threads
    written = -1
    for h0 in range(lo, live, n_threads * rows):
        hs = [h for h in range(h0, min(h0 + n_threads * rows, live))]
        vals = {}
        for h in hs:
            if h < nh:
                assert int(src[h]) >= h0 > written
                v = out[:, int(src[h])].clone()
                nxt = int(plen[src[h + 1]]) if h + 1 < nh else total
                v[K1.L_LEN] = nxt - int(plen[src[h]])
            else:
                v = torch.zeros(K1.N_LANES, dtype=torch.int32)
                v[K1.L_RSEQ] = RSEQ_NONE
            vals[h] = v
        for h, v in vals.items():  # after the round's barrier
            out[:, h] = v
        written = max(hs)
    return out, nh


@pytest.mark.parametrize("seed", range(4))
def test_store_in_rounds_equals_the_plain_compact(seed):
    """K2's store on the global and split tiers: the rows below count
    alone, rows below the first row that is not a head left in place,
    and the rest stored upward in rounds of a few rows a thread with one
    barrier each (no round reads a row an earlier one wrote). Held bit for
    bit against compact_plain (every row) on random run tables of 1-200
    rows (free rows past count) and the edge tables, at 1 and 3 CTAs of
    32 threads, 1 and 4 rows a thread (STORE_ROWS in the kernel), and
    with K3's live range (count + 2K)."""
    rng = np.random.default_rng(seed)
    tables = [_run_table(rng, int(rng.integers(1, 201))) for _ in range(30)]
    if seed == 0:
        tables += _edge_tables()
    for L in tables:
        s = L.shape[1]
        count = int(rng.integers(0, s + 1))
        L = L.clone()
        L[:, count:] = 0
        L[K1.L_RSEQ, count:] = RSEQ_NONE
        sc = torch.zeros((1, K1.N_SCALARS), dtype=torch.int32)
        sc[0, K1.SC_COUNT] = count
        sc[0, K1.SC_MIN_SEQ] = 10
        want_t, want_s = K2.compact_plain(L[:, None], sc)
        for c, rows, k in ((1, 1, 0), (1, 4, 0), (3, 4, 0), (3, 1, 2)):
            got, nh = _model_store(L, count, 10, c, 32, rows, k)
            assert nh == int(want_s[0, K1.SC_COUNT])
            assert torch.equal(got, want_t[:, 0]), (c, rows, k)


SENTINEL = 0x5A5A5A5A  # an output buffer's value before a launch


def _model_cut_launch(name, t, sc, ops, c, nw, in_place, seed=0):
    """K1, K2 or K3 (``name``) on the shared tier (``c`` 1) or the cluster
    tier (``c`` CTAs) of ``nw`` warps each, for every document as
    merge_kernel runs it: the rows below the input count loaded and the
    rest of [0, live) filled (live = ``_cuda.live_rows``; K2's the count),
    K1's loop over the launch's cut (:func:`_model_apply`; on the shared
    tier each op's blocks clipped to count + 2), K2 (K3 after
    K1) one gather over [0, live) cut into ``c`` slices of ``nw`` warp
    blocks (:func:`_warp_blocks`: warps and CTAs with no rows among them;
    K2 on the cluster tier over the host's slices of ceil(S / c) rows),
    then the store of the rows below the larger of the input and output
    counts. Past them, in place, nothing is stored (the model asserts that
    its rows there equal the input's); out of place, the lanes' fills are,
    into an output that held :data:`SENTINEL`. Returns (tables,
    scalars)."""
    from fluidframework_tpu_torch.ops import _cuda
    from fluidframework_tpu_torch.ops.segment_state import (
        LANE_FILLS,
        SEGMENT_LANES,
    )

    fills = np.array([LANE_FILLS.get(n, 0) for n in SEGMENT_LANES],
                     np.int32)[:, None]
    rng = np.random.default_rng(seed)
    n_docs, s = t.shape[1], t.shape[2]
    out_t = t.copy() if in_place else np.full_like(t, SENTINEL)
    out_s = sc.copy()
    k = 0 if name == "K2" else ops.shape[1]
    for doc in range(n_docs):
        count_in = min(max(int(sc[doc, K1.SC_COUNT]), 0), s)
        live = _cuda.live_rows(s, count_in, k)
        work = np.broadcast_to(fills, (K1.N_LANES, s)).copy()
        work[:, :count_in] = t[:, doc, :count_in]
        scd = sc[doc].copy()
        if name != "K2":  # the shared tier clips each op
            work, scd = _model_apply(work, scd, ops[doc], c, nw, rng,
                                     op_cut=c == 1)
        if name != "K1":  # K2 keeps the host's slices on the cluster tier
            host_sl = (-(-s // c) + 31) // 32 * 32
            lanes, nh = _one_gather(
                torch.from_numpy(work), int(scd[K1.SC_MIN_SEQ]),
                _warp_blocks(live, c, nw,
                             host_sl if name == "K2" and c > 1 else None))
            work, scd[K1.SC_COUNT] = lanes.numpy(), nh
        stored = max(count_in, min(max(int(scd[K1.SC_COUNT]), 0), s))
        if in_place:
            np.testing.assert_array_equal(work[:, stored:],
                                          t[:, doc, stored:])
        else:
            out_t[:, doc, stored:] = fills
        out_t[:, doc, :stored] = work[:, :stored]
        out_s[doc] = scd
    return out_t, out_s


def _compact_counts_case(s, counts, rng):
    """Run tables (:func:`_run_table`, min_seq 10) of ``s`` rows holding
    ``counts[d]`` rows each, free rows past count, and two ops a document
    (an insert, then a remove that moves the window past it)."""
    t = np.zeros((K1.N_LANES, len(counts), s), np.int32)
    for d, n in enumerate(counts):
        L = _run_table(rng, s)
        L[:, n:] = 0
        L[K1.L_RSEQ, n:] = RSEQ_NONE
        t[:, d] = L.numpy()
    sc = np.zeros((len(counts), K1.N_SCALARS), np.int32)
    sc[:, K1.SC_COUNT] = counts
    sc[:, K1.SC_MIN_SEQ] = 10
    sc[:, K1.SC_CUR_SEQ] = 20
    sc[:, K1.SC_SELF] = NO_CLIENT
    one = np.stack([E.insert(1, 5, 2, seq=21, ref=20, client=1),
                    E.remove(0, 3, seq=22, ref=21, client=1, msn=22)])
    return t, sc, np.broadcast_to(one, (len(counts),) + one.shape).copy()


@pytest.mark.parametrize("in_place", [True, False],
                         ids=["in_place", "out_of_place"])
@pytest.mark.parametrize("c,nw", [(1, 8), (3, 8), (16, 8)])
@pytest.mark.parametrize("name", ["K1", "K2", "K3"])
def test_shared_and_cluster_launch_equals_the_plain_versions(name, c, nw,
                                                             in_place):
    """K1, K2 and K3 on the shared tier (one CTA of 8 warps) and the
    cluster tier (3 and 16 CTAs) load only the rows below the input count,
    walk [0, live) cut into the launch's slices and warp blocks, and store
    the rows below the larger count: nothing past it in place, fills out of
    place (:func:`_model_cut_launch`). Held bit for bit against the plain
    versions at K2's seams (count 0, 1, 31-33, on the slice edges of 3 and
    16 CTAs, S - 1 and S: warps and CTAs with no rows, a count on a
    slice's edge), K1's (:func:`_edge_ops`), random states with every err
    branch and chip_smoke's compaction edges."""
    from chip_smoke import compact_edge_case
    from tools.kernel_sanitize import random_case

    s = 200
    rng = np.random.default_rng(c * 10 + nw)
    cases = [_compact_counts_case(s, [0, 1, 31, 32, 33, 96, 160, 192,
                                      s - 1, s], rng),
             _live_case(s, *_edge_ops(s, c))]
    cases += [tuple(x.numpy() for x in random_case(rng, 6, s, 5, "cpu")),
              tuple(x.numpy() for x in compact_edge_case(
                  s, "cpu", sl=(-(-(s - 3) // c) + 31) // 32 * 32))]
    plain = {"K1": K1.apply_plain, "K3": K2.apply_compact_plain,
             "K2": lambda t, s_, _ops: K2.compact_plain(t, s_)}[name]
    for i, (t, sc, ops) in enumerate(cases):
        want = plain(torch.from_numpy(t), torch.from_numpy(sc),
                     torch.from_numpy(ops))
        got = _model_cut_launch(name, t, sc, ops, c, nw, in_place)
        _assert_packed_equal((want[0].numpy(), want[1].numpy()), got)
        if i < 2:  # the seams also against the reference's XLA kernels
            state = ref_make_batched_state(t.shape[1], s, NO_CLIENT)._make(
                [jnp.asarray(x) for x in _unpack_np(t, sc)])
            if name != "K2":
                state = batched_apply_ops(state, ops)
            ref = _xla_packed(batched_compact(state) if name != "K1"
                              else state)
            if name == "K3":  # the XLA compact keeps scalar columns 5-7
                ref = (ref[0], np.concatenate([ref[1][:, :5],
                                               got[1][:, 5:]], 1))
            _assert_packed_equal(ref, got)


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


def test_grow_past_65536_rows_matches_the_reference():
    """A full one-document table of 65,536 distinct rows grown to 131,072
    (past the old one-CTA ceiling), then 64 fuzz ops that move every row
    and add rows past 65,536: the port's ``grow`` + ``jit_apply_ops``
    equals the reference's lane for lane."""
    from fluidframework_tpu.ops.merge_kernel import jit_apply_ops as ref_jit
    from fluidframework_tpu.ops.segment_state import (
        SegmentState as RefState,
        grow as ref_grow,
    )
    from fluidframework_tpu_torch.interop import (
        segment_state_from_numpy,
        segment_state_to_numpy,
    )
    from fluidframework_tpu_torch.ops.merge_kernel import jit_apply_ops
    from fluidframework_tpu_torch.ops.segment_state import (
        LANE_FILLS,
        SEGMENT_LANES,
        grow,
    )

    n = 65536
    lanes = {k: np.full(n, LANE_FILLS.get(k, 0), np.int32)
             for k in SEGMENT_LANES}
    lanes["kind"][:] = KIND_TEXT
    lanes["orig"][:] = np.arange(1, n + 1)
    lanes["length"][:] = 1
    lanes["seq"][:] = np.arange(1, n + 1)
    arrays = [lanes[k] for k in SEGMENT_LANES] + [
        np.int32(n), np.int32(0), np.int32(n), np.int32(NO_CLIENT),
        np.int32(0)]
    ops = np.stack(random_acked_stream(
        np.random.default_rng(65), 64, {}, OracleDoc(NO_CLIENT),
        caught_up=True, seq0=n + 1)).astype(np.int32)
    ref = ref_jit(ref_grow(RefState(*[jnp.asarray(a) for a in arrays]),
                           2 * n), jnp.asarray(ops))
    port = grow(segment_state_from_numpy(arrays, device="cpu"), 2 * n)
    assert port.kind.shape == (2 * n,)
    port = jit_apply_ops(port, torch.from_numpy(ops))
    got = segment_state_to_numpy(port)
    for f, a, b in zip(RefState._fields, ref, got):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
    assert int(got[15]) > n  # count: rows past the old ceiling


# -- the warp tier: one warp a document, scratch in registers ---------------


def _warp_regs(L, whi, o):
    """The perspective pass over the tiles below ``whi`` as the warp
    holds it: lane i of tile j keeps row 32 j + i's visible length A,
    part flag F and in-warp exclusive prefix C (a warp scan with a carry
    across tiles). ``o`` = (clientn, refn, self_client, min_seq). Returns
    (A, C, F [tiles, 32], the total)."""
    nt = -(-whi // 32)
    A = np.zeros((nt, 32), np.int64)
    C = np.zeros((nt, 32), np.int64)
    F = np.zeros((nt, 32), bool)
    carry = 0
    for j in range(nt):
        rows = 32 * j + np.arange(32)
        valid = rows < whi
        Lt = torch.from_numpy(L[:, None, rows[valid]].copy())
        clientn, refn, me, min_seq = (_i32(v) for v in o)
        part, vis = K1._perspective(Lt, clientn, refn, clientn == me,
                                    min_seq)
        A[j, valid] = vis[0].numpy()
        F[j, valid] = part[0].numpy()
        inc = np.cumsum(A[j])
        C[j] = carry + inc - A[j]
        carry += int(inc[31])
    return A, C, F, carry


def _model_warp_doc(t, sc, ops, fuse):
    """K1 (K3 with ``fuse``) on the warp tier for one document (t
    [N_LANES, S], sc [N_SCALARS], ops [K, OP_WIDTH]), as its warp runs
    it: each op over the tiles below whi = min(S, count + 2) alone, count
    the op's own (rows at or past whi are never read or written); its
    prefix, first hits (a ballot a tile, the first set lane) and the
    prefix at a hit (a shuffle from the lane that holds it) from the
    lanes' registers; the row move top down over the tiles, each row
    taking its source from its own tile or the two rows below it
    (:func:`_move_in_blocks` over the one block [0, whi)); the covered
    rows' marks from the second pass's registers. K3 then compacts the
    rows below count in place (:func:`_model_warp_compact`). The warp
    loads the rows below the input's count alone and fills the rest;
    in place it stores back only the rows below the larger of the two
    counts (every other row is free before and after). Returns (t, sc)
    as the in-place launch leaves them."""
    s = t.shape[1]
    count, min_seq, cur_seq, me, err = (int(v) for v in sc[:5])
    count_in = min(max(count, 0), s)
    L = np.zeros_like(t, dtype=np.int32)
    L[K1.L_RSEQ] = RSEQ_NONE
    L[:, :count_in] = t[:, :count_in]
    for op in ops:
        op = [int(v) for v in op]
        ty, pos1, pos2, seqn, refn, clientn, lseqn, arg, ilen, msn = op
        whi = min(s, min(max(count, 0), s) + 2)
        is_ins, is_range = ty == 1, ty in (2, 3)
        local_op = seqn == UNASSIGNED_SEQ
        o = (clientn, refn, me, min_seq)
        if clientn >= 93:
            err |= ERR_CLIENT
        if is_ins or is_range:
            A, C, F, total = _warp_regs(L, whi, o)
            total = int(np.int32(total))
            norm = NORM_NEW_LOCAL_ if local_op else seqn
            m1 = m2 = mp = s
            for j in range(A.shape[0]):
                rows = 32 * j + np.arange(32)
                valid = rows < whi
                v, part, run = A[j], F[j], C[j]
                rem1, rem2 = pos1 - run, pos2 - run
                h1 = valid & part & (v > 0) & (rem1 > 0) & (rem1 < v)
                h2 = valid & part & (v > 0) & (rem2 > 0) & (rem2 < v)
                seq = np.where(valid, L[K1.L_SEQ, np.minimum(rows, s - 1)],
                               0)
                seq_n = np.where(seq == UNASSIGNED_SEQ, NORM_EXISTING_LOCAL_,
                                 seq)
                hp = valid & part & (((v > 0) & (rem1 >= 0) & (rem1 < v))
                                     | ((v == 0) & (rem1 == 0)
                                        & (norm > seq_n)))
                for m, hit in ((0, h1), (1, h2), (2, hp)):
                    first = 32 * j + _first(hit, 32)
                    if hit.any() and [m1, m2, mp][m] == s:
                        if m == 0:
                            m1 = first
                        elif m == 1:
                            m2 = first
                        else:
                            mp = first
            has1, has2, hasp = m1 < s, m2 < s, mp < s
            split1 = pos1 - int(C[m1 >> 5, m1 & 31]) if has1 else 0
            split2 = pos2 - int(C[m2 >> 5, m2 & 31]) if has2 else 0
            idxp = mp if hasp else count
            sh = 2 if has1 else 1
            do_ins = is_ins and count + sh <= s
            do_a = is_range and has1 and count + 1 <= s
            count_a = count + do_a
            do_b = is_range and has2 and count_a + 1 <= s
            if (is_ins and not do_ins) or (is_range and has1 and not do_a) \
                    or (is_range and has2 and not do_b):
                err |= ERR_CAPACITY
            if (is_ins and not hasp and pos1 > total) or (
                    is_range and pos2 > total):
                err |= ERR_RANGE
            new_row = np.zeros(K1.N_LANES, np.int32)
            new_row[[K1.L_KIND, K1.L_ORIG, K1.L_LEN, K1.L_SEQ, K1.L_CLIENT,
                     K1.L_LSEQ, K1.L_RSEQ]] = [
                KIND_TEXT, arg, ilen, seqn, clientn,
                lseqn if local_op else 0, RSEQ_NONE]
            mv = (do_a or (do_ins and has1), m1, split1, do_b,
                  m2 + int(do_a),
                  split2 - split1 if do_a and m1 == m2 else split2,
                  do_ins, m1 + 1 if has1 else idxp)
            _move_in_blocks(L, mv, new_row, [(0, whi)],
                            np.random.default_rng(0))
            count = (count_a + do_b if is_range
                     else count + sh if do_ins else count)
        if is_range or ty in (4, 5, 6):
            A, C, F, _total = _warp_regs(L, whi, o)
            cov = (F & (A > 0) & (C >= pos1) & (C + A <= pos2)).reshape(-1)
            cov = cov[:whi] & is_range
            _marks(L[:, :whi], cov, ty, op, local_op)
        cur_seq, min_seq = max(cur_seq, seqn), max(min_seq, msn)
    out = np.zeros_like(sc)
    out[:5] = count, min_seq, cur_seq, me, err
    if fuse:
        out[0] = _model_warp_compact(L, min(max(count, 0), s), min_seq)
    stored = max(min(max(int(out[0]), 0), s), count_in)
    # Out of place the warp stores every row: the rows it skips in place
    # hold the same in its shared memory as in the input.
    np.testing.assert_array_equal(L[:, stored:], t[:, stored:])
    g = t.astype(np.int32).copy()
    g[:, :stored] = L[:, :stored]
    return g, out


NORM_NEW_LOCAL_ = (1 << 30) + 2
NORM_EXISTING_LOCAL_ = (1 << 30) + 1


def _model_warp_compact(L, whi, min_seq):
    """compact_doc on the warp tier over rows [0, whi) of L [N_LANES, S],
    in place as the warp runs it in shared memory: one pass over the
    tiles bottom up finds each tile's heads (a kept row that does not
    merge into the previous kept row: in its tile, else the last kept row
    of the tiles below, carried) and writes each head's row, read before
    any write of its tile, to its output row h (at most its own, so no row
    a later tile reads is overwritten), LEN holding its kept-LEN prefix;
    then each output row's LEN becomes the next head's prefix (the total
    for the last) less its own, and rows [n_heads, whi) are filled.
    Returns n_heads."""
    Lt = torch.from_numpy(L.copy())  # the rows as the pass reads them
    run, lsum, cq = 0, 0, None
    for t0 in range(0, whi, 32):
        heads, prefix = [], []
        for r in range(t0, min(t0 + 32, whi)):
            rseq = int(L[K1.L_RSEQ, r])
            pending = (Lt[K1.L_LSEQ, r] != 0 or Lt[K1.L_RLSEQ, r] != 0
                       or Lt[K1.L_ALSEQ, r] != 0)
            reclaim = (not pending and rseq not in (RSEQ_NONE,
                                                    UNASSIGNED_SEQ)
                       and rseq <= min_seq)
            if Lt[K1.L_KIND, r] == KIND_FREE or reclaim:
                continue
            if cq is None or not bool(_mergeable(Lt[:, cq:cq + 1],
                                                 Lt[:, r:r + 1])[0]):
                heads.append(r)
                prefix.append(lsum)
            lsum += int(Lt[K1.L_LEN, r])
            cq = r
        rows = L[:, heads].copy()  # read, then one __syncwarp
        for n, (r, p) in enumerate(zip(heads, prefix)):
            assert run + n <= r
            L[:, run + n] = rows[:, n]
            L[K1.L_LEN, run + n] = p
        run += len(heads)
    nh = run
    plen = L[K1.L_LEN, :nh].astype(np.int64)
    L[K1.L_LEN, :nh] = (np.append(plen[1:], lsum) - plen).astype(np.int32)
    L[:, nh:whi] = 0
    L[K1.L_RSEQ, nh:whi] = RSEQ_NONE
    return nh


def _model_warp(t, sc, ops, fuse):
    """The warp tier's launch: one CTA of one warp a document. Returns
    (t, sc)."""
    got_t, got_s = t.copy(), sc.copy()
    for doc in range(t.shape[1]):
        got_t[:, doc], got_s[doc] = _model_warp_doc(
            t[:, doc], sc[doc], ops[doc], fuse)
    return got_t, got_s


def _warp_edge_docs(s, k=4):
    """(counts, ops) of one document each where the warp tier's walk meets
    its seams: an empty table; counts on and beside the 32-row tile edge
    with inserts and splits that move rows across it; count S - 2, S - 1
    and S (each insert or split past S refused: ERR_CAPACITY); an insert
    past the end and a remove past it (ERR_RANGE); an unknown writer
    (ERR_CLIENT); local ops of the document's own writer and their acks;
    a remove across every tile."""
    me = 2

    def ins(p, j, **kw):
        kw = {"seq": 101 + j, "ref": 100 + j, "client": 1, **kw}
        return E.insert(p, 7 + j, 3, **kw)

    e = 32 if s >= 64 else s // 2  # the tile edge, or a row mid-tile
    docs = [(0, [ins(0, j) for j in range(k)]),
            (e - 1, [ins(4 * (e - 1) - 2, j) for j in range(k)]),
            (e, [ins(4 * e - 1, 0), ins(2, 1), ins(4 * e + 5, 2),
                 E.remove(4 * e - 6, 4 * e + 2, seq=104, ref=103, client=3)]),
            (s - 2, [ins(4 * s - 10, 0), ins(3, 1), ins(1, 2), ins(0, 3)]),
            (s - 1, [ins(6, 0), E.annotate(1, 4 * s - 5, 9, seq=102,
                                           ref=101, client=1),
                     ins(2, 2), ins(4 * s, 3)]),
            (s, [ins(2, 0), E.remove(3, 9, seq=102, ref=101, client=2),
                 E.annotate(1, 4 * s - 1, 5, seq=103, ref=102, client=1),
                 ins(4 * s, 3)]),
            (s // 2, [ins(4 * s, 0), E.remove(1, 4 * s, seq=102, ref=101,
                                              client=1),
                      ins(5, 2, client=120), ins(1, 3)]),
            (s // 2, [E.insert(3, 9, 2, client=me, lseq=1),
                      E.remove(1, 6, client=me, lseq=2),
                      E.ack("insert", lseq=1, seq=101),
                      E.ack("remove", lseq=2, seq=102)]),
            (s - 3, [E.remove(1, 4 * (s - 3) - 1, seq=101, ref=100,
                              client=2, msn=101)] + [ins(2 + j, j)
                                                     for j in range(1, k)])]
    counts = [c for c, _o in docs]
    return counts, np.stack([np.stack(o[:k]) for _c, o in docs]), me


@pytest.mark.parametrize("s", [32, 64, 128, 256])
def test_warp_tier_loop_equals_the_plain_versions(s):
    """K1 and K3 on the warp tier (one warp a document, a CTA of one
    warp) walk each op over the tiles below min(S, count + 2) alone, keep the
    scratch in the lanes' registers and move the rows across the 32-row
    tile edges from the two rows below each tile; K3 then compacts in
    place as its one pass goes, and each stores back only the rows below
    the larger count. The model of that loop is held bit for
    bit against apply_plain and apply_compact_plain (which walk every
    row) and the reference XLA kernels on the seams of
    :func:`_warp_edge_docs` (9 documents), and against the plain versions on
    random states with every err branch and on chip_smoke's edge moves
    and compactions."""
    from chip_smoke import compact_edge_case, edge_case
    from tools.kernel_sanitize import random_case

    counts, ops, me = _warp_edge_docs(s)
    t, sc, ops = _live_case(s, counts, ops)
    sc[:, K1.SC_SELF] = me
    state = ref_make_batched_state(len(counts), s, me)._make(
        [jnp.asarray(x) for x in _unpack_np(t, sc)])
    ref1 = batched_apply_ops(state, ops)
    for fuse, plain, ref in (
            (False, K1.apply_plain, _xla_packed(ref1)),
            (True, K2.apply_compact_plain,
             _xla_packed(batched_compact(ref1)))):
        got = _model_warp(t, sc, ops, fuse)
        want = plain(torch.from_numpy(t), torch.from_numpy(sc),
                     torch.from_numpy(ops))
        _assert_packed_equal((want[0].numpy(), want[1].numpy()), got)
        if fuse:  # the XLA compact keeps scalar columns 5-7; K3 zeroes them
            ref = (ref[0], np.concatenate([ref[1][:, :5], got[1][:, 5:]], 1))
        _assert_packed_equal(ref, got)
    errs = got[1][:, K1.SC_ERR]
    assert errs[3] & ERR_CAPACITY and errs[5] & ERR_CAPACITY
    assert errs[6] & ERR_RANGE and errs[6] & ERR_CLIENT
    assert not errs[[0, 1, 2, 7]].any()
    rng = np.random.default_rng(s)
    cases = [random_case(rng, 6, s, 5, "cpu") for _ in range(2)]
    cases += [edge_case(s, "cpu"), compact_edge_case(s, "cpu")]
    for rt, rs, rops in cases:
        if rt.shape[1] == 0:
            continue
        for fuse, plain in ((False, K1.apply_plain),
                            (True, K2.apply_compact_plain)):
            want = plain(rt, rs, rops)
            got = _model_warp(rt.numpy(), rs.numpy(), rops.numpy(), fuse)
            _assert_packed_equal((want[0].numpy(), want[1].numpy()), got)


@pytest.mark.parametrize("name", ["K1_merge_apply", "K2_zamboni_compact",
                                  "K3_fused_apply_compact"])
def test_live_floor_counts_the_rows_this_run_needs(name):
    """chip_smoke's byte floor with the launch's output scalars counts,
    for each document, its 15 lanes of the rows below its input count
    read and of the rows below the larger of its input and output counts
    written (none of an all-NOOP document for K1), plus the scalars and
    ops, and lies at or under the all-rows floor."""
    from chip_smoke import (F_TYPE, KERNELS, OP_NOOP, OP_WIDTH, bound_bytes,
                            live_bound_bytes)
    from tools.kernel_sanitize import random_case

    s, k = 64, 5
    t0, s0, ops = random_case(np.random.default_rng(7), 6, s, k, "cpu")
    ops[2, :, F_TYPE] = OP_NOOP  # one document of NOOPs
    spec = KERNELS[name]
    args = (ops,) if spec["takes_ops"] else ()
    s_out = spec["plain"](t0, s0, *args)[1]
    got = live_bound_bytes(name, s0, s, ops, s_out)
    kk = k if spec["takes_ops"] else 0
    rows = 0
    for doc in range(6):
        if name == "K1_merge_apply" and doc == 2:
            continue
        c = min(max(int(s0[doc, K1.SC_COUNT]), 0), s)
        c2 = min(max(int(s_out[doc, K1.SC_COUNT]), 0), s)
        rows += c + max(c, c2)
    assert got == (K1.N_LANES * rows * 4 + 2 * 6 * K1.N_SCALARS * 4
                   + 6 * kk * OP_WIDTH * 4)
    assert got <= bound_bytes(name, 6, s, kk)
