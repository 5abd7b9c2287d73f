"""The port's dense changeset algebra against the reference, bit for bit.

The same numpy-seeded inputs go through the reference's jitted
``batched_apply/rebase/invert/compose`` (XLA on the CPU) and the port's
(``device="cpu"``); every int32 lane, every length and every overflow flag
must be equal. Inputs: host changesets lowered with ``from_marks`` (plain
and move-bearing), raw random lanes (several writers to a slot, tags with
many matches, boundaries past the pool), and documents that overflow the
dense capacity (survivor positions past ``Lc``).
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import tree_kernel as RK
from fluidframework_tpu.tree import marks as RM
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops import tree_kernel as TK
from fluidframework_tpu_torch.tree import marks as M
from test_tree_marks import (
    random_change,
    random_change_with_moves,
    random_state,
)

LC, PC, N = 32, 32, 8
CPU = "cpu"


def same(ref, got, what=""):
    """Every lane of ``ref`` (reference arrays) equals ``got`` (port
    tensors), dtype included."""
    if isinstance(ref, tuple):
        assert len(ref) == len(got), what
        for i, (r, g) in enumerate(zip(ref, got)):
            same(r, g, f"{what}[{i}]")
        return
    r = np.asarray(ref)
    g = got.numpy()
    assert g.dtype == np.int32 and r.dtype == np.int32, what
    np.testing.assert_array_equal(g, r, err_msg=what)


def stack(changes, Lc=LC, Pc=PC):
    dcs = [RK.from_marks(c, Lc, Pc)[0] for c in changes]
    return tuple(np.stack([np.asarray(d[i]) for d in dcs]) for i in range(7))


def docs_batch(states, Lc=LC):
    ids = np.stack([RK.doc_to_dense(s, Lc)[0] for s in states])
    return np.asarray(ids, np.int32), np.asarray([len(s) for s in states],
                                                  np.int32)


def raw_lanes(rng, n, Lc, Pc, dense=0.3):
    """Random lanes outside the well-formed set: duplicate tags, counts
    that overrun the pool, ids up to 2^20."""

    def sparse(shape, hi):
        return (rng.integers(0, hi, shape)
                * (rng.random(shape) < dense)).astype(np.int32)

    return (sparse((n, Lc), 2), sparse((n, Lc + 1), 3),
            rng.integers(1, 1 << 20, (n, Pc)).astype(np.int32),
            sparse((n, Lc), 4), sparse((n, Lc), 4), sparse((n, Pc), 4),
            sparse((n, Pc), 4))


def case(seed, kind):
    """(ids, L, a, b over a's input, b2 over a's output) for one batch."""
    rng = np.random.default_rng(seed)
    if kind == "raw":
        ids = rng.integers(1, 1 << 20, (N, LC)).astype(np.int32)
        L = rng.integers(0, LC + 1, N).astype(np.int32)
        return (ids, L, raw_lanes(rng, N, LC, PC), raw_lanes(rng, N, LC, PC),
                raw_lanes(rng, N, LC, PC))
    gen = random_change_with_moves if kind == "moves" else random_change
    states = [random_state(rng) for _ in range(N)]
    a = [gen(rng, s) for s in states]
    b = [gen(rng, s) for s in states]
    mids = [RM.apply(s, c) for s, c in zip(states, a)]
    b2 = [gen(rng, m) for m in mids]
    ids, L = docs_batch(states)
    return ids, L, stack(a), stack(b), stack(b2)


@pytest.mark.parametrize("kind", ["plain", "moves", "raw"])
@pytest.mark.parametrize("seed", range(4))
def test_batched_algebra_matches_reference(seed, kind):
    ids, L, a, b, b2 = case(seed * 31 + 7, kind)
    ra, rb, rb2 = (RK.DenseChange(*x) for x in (a, b, b2))
    same(RK.batched_apply(ids, L, ra),
         TK.batched_apply(ids, L, a, device=CPU), "apply")
    for c_after in (False, True):
        same(RK.batched_rebase(rb, ra, L, c_after),
             TK.batched_rebase(b, a, L, c_after, device=CPU),
             f"rebase c_after={c_after}")
    same(RK.batched_invert(ids, L, ra),
         TK.batched_invert(ids, L, a, device=CPU), "invert")
    same(RK.batched_compose(ra, rb2, L),
         TK.batched_compose(a, b2, L, device=CPU), "compose")
    same(np.asarray([RK.out_len(RK.DenseChange(*[x[i] for x in a]), L[i])
                     for i in range(N)], np.int32),
         TK.out_len(interop.dense_change_from_numpy(a, CPU),
                    torch.from_numpy(L)), "out_len")


@pytest.mark.parametrize("kind", ["plain", "moves"])
def test_capacity_overflow_drops_like_reference(kind):
    """Documents near Lc with attaches: survivors land at positions >= Lc
    (dropped, new_L still counts them); the rebase and compose of such
    changes, and a compose whose live pool passes Pc, match too."""
    Lc, Pc = 16, 32
    rng = np.random.default_rng(99)
    gen = random_change_with_moves if kind == "moves" else random_change
    states = [random_state(rng, int(rng.integers(12, 17))) for _ in range(N)]
    a = [[RM.insert(random_state(rng, 4))] + gen(rng, s) for s in states]
    b = [[RM.insert(random_state(rng, 5))] + gen(rng, s) for s in states]
    ids, L = docs_batch(states, Lc)
    da, db = stack(a, Lc, Pc), stack(b, Lc, Pc)
    ra, rb = RK.DenseChange(*da), RK.DenseChange(*db)
    ref_out = RK.batched_apply(ids, L, ra)
    got_out = TK.batched_apply(ids, L, da, device=CPU)
    same(ref_out, got_out, "apply")
    assert (got_out[1].numpy() > Lc).any()
    for c_after in (False, True):
        same(RK.batched_rebase(rb, ra, L, c_after),
             TK.batched_rebase(db, da, L, c_after, device=CPU), "rebase")
    same(RK.batched_invert(ids, L, ra),
         TK.batched_invert(ids, L, da, device=CPU), "invert")
    ref_c = RK.batched_compose(ra, rb, L)
    got_c = TK.batched_compose(da, db, L, device=CPU)
    same(ref_c, got_c, "compose")
    small = stack([[RM.insert([1, 2, 3])]] * 2, Lc, 4)
    more = stack([[RM.insert([4, 5])]] * 2, Lc, 4)
    zero = np.zeros(2, np.int32)
    ovf = TK.batched_compose(small, more, zero, device=CPU)
    same(RK.batched_compose(RK.DenseChange(*small), RK.DenseChange(*more),
                            zero), ovf, "compose overflow")
    assert ovf[1].tolist() == [1, 1]


@pytest.mark.parametrize("seed", range(3))
def test_from_marks_and_docs_match_reference(seed):
    rng = np.random.default_rng(seed + 400)
    for _ in range(10):
        s = random_state(rng)
        c = random_change_with_moves(rng, s)
        ref, ref_i = RK.from_marks(c, LC, PC)
        got, got_i = TK.from_marks(c, LC, PC)
        assert ref_i == got_i
        for r, g in zip(ref, got):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(np.asarray(r), g)
        r_ids, r_L = RK.doc_to_dense(s, LC)
        g_ids, g_L = TK.doc_to_dense(s, LC)
        np.testing.assert_array_equal(np.asarray(r_ids), g_ids)
        assert r_L == g_L
        out, out_L = TK.batched_apply(g_ids[None], [g_L], TK.DenseChange(
            *[x[None] for x in got]), device=CPU)
        assert TK.dense_to_doc(out[0], out_L[0]) == M.apply(s, c)
        assert RK.dense_to_doc(np.asarray(r_ids), r_L) == \
            TK.dense_to_doc(g_ids, g_L)
    with pytest.raises(ValueError):
        RK.from_marks([("bogus", 1)], LC, PC)
    with pytest.raises(ValueError):
        TK.from_marks([("bogus", 1)], LC, PC)


def test_empty_change_and_interop_round_trip():
    e = TK.empty_change(LC, PC, n=3, device=CPU)
    ref = RK.empty_change(LC, PC)
    for r, g in zip(ref, e):
        assert g.shape == (3,) + np.asarray(r).shape
        assert not g.any() and g.dtype == torch.int32
    _ids, _L, a, *_ = case(5, "moves")
    port = interop.dense_change_from_numpy(a, CPU)
    back = interop.tree_lanes_to_numpy(port)
    for x, y in zip(a, back):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        interop.dense_change_from_numpy(a[:6], CPU)


def test_batched_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ids, L, a, b, *_ = case(1, "plain")
    for call in (lambda: TK.batched_apply(ids, L, a),
                 lambda: TK.batched_rebase(b, a, L),
                 lambda: TK.batched_invert(ids, L, a),
                 lambda: TK.batched_compose(a, b, L),
                 lambda: TK.empty_change(LC, PC)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
