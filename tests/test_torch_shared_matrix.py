"""The port's SharedMatrix and SparseMatrix against the reference.

Both packages run the same scripts through their ``ContainerRuntime``s
(``tests/test_torch_shared_string.py``'s :class:`Side`): concurrent row and
column inserts and removes, cell writes, a runtime going offline with
pending axis ops. After every step each replica's grid, both permutation
vectors' lanes and the summary bytes equal the reference's, and the
replicas converge. Compaction and growth of the permutation vectors fall
at the same ops. Config 4's op stream (``testing/merge_streams.py``) runs
through the batched API against XLA.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import bench
from fluidframework_tpu.ops import merge_kernel as RM
from fluidframework_tpu.ops import segment_state as RS
from fluidframework_tpu_torch.interop import segment_state_from_numpy
from fluidframework_tpu_torch.ops import merge_kernel as M
from fluidframework_tpu_torch.protocol.constants import NO_CLIENT
from fluidframework_tpu_torch.testing.merge_streams import (
    build_op_stream,
    matrix_axis_stream,
)
from tests.test_torch_merge_kernel import ref_arrays, same
from tests.test_torch_shared_string import Counted, both, lanes, summary_bytes


def same_matrices(ref, port, cid="m", what=""):
    for i, (a, b) in enumerate(zip(ref.rts, port.rts)):
        ra, pb = a.get_channel(cid), b.get_channel(cid)
        assert pb.to_list() == ra.to_list(), f"{what}: rt {i}"
        vecs = (("_rows", "_cols") if hasattr(ra, "_cols") else ("_rows",))
        for v in vecs:
            for x, y in zip(lanes(getattr(pb, v).state, True),
                            lanes(getattr(ra, v).state, False)):
                assert np.array_equal(x, y), f"{what}: rt {i} {v}"


def matrix_script(sides, rng, steps, offline_at=()):
    ref = sides[0]
    for step in range(steps):
        i = int(rng.integers(0, len(ref.rts)))
        m = ref.ch(i, "m")
        act = int(rng.integers(0, 7))
        nr, nc = m.row_count, m.col_count
        if act == 0 and nr < 40:
            op = ("insert_rows", int(rng.integers(0, nr + 1)),
                  int(rng.integers(1, 4)))
        elif act == 1 and nc < 40:
            op = ("insert_cols", int(rng.integers(0, nc + 1)),
                  int(rng.integers(1, 3)))
        elif act == 2 and nr > 1:
            op = ("remove_rows", int(rng.integers(0, nr - 1)), 1)
        elif act == 3 and nc > 1:
            op = ("remove_cols", int(rng.integers(0, nc - 1)), 1)
        elif nr and nc:
            op = ("set_cell", int(rng.integers(0, nr)),
                  int(rng.integers(0, nc)), int(rng.integers(0, 100)))
        else:
            op = ("insert_rows", 0, 1)
        for side in sides:
            getattr(side.ch(i, "m"), op[0])(*op[1:])
        if step in offline_at:
            for side in sides:
                side.rts[0].disconnect()
        if step - 3 in offline_at:
            for side in sides:
                side.rts[0].reconnect()
        if rng.random() < 0.3:
            for side in sides:
                side.rts[i].flush()
        if rng.random() < 0.3:
            k = int(rng.integers(0, len(ref.rts)))
            n = int(rng.integers(1, 5))
            for side in sides:
                if side.rts[k].connected:
                    side.rts[k].process_incoming(n)
        same_matrices(*sides, what=f"step {step}")
    for side in sides:
        side.drain()
    same_matrices(*sides, what="drained")
    for i in range(len(ref.rts)):
        assert summary_bytes(sides[1].ch(i, "m")) == \
            summary_bytes(ref.ch(i, "m"))
    grids = {repr(s.ch(i, "m").to_list()) for s in sides
             for i in range(len(s.rts))}
    assert len(grids) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_matrix_in_lockstep(seed, monkeypatch):
    """Small permutation vectors (capacity 16) compact and grow at the
    same ops in both packages."""
    clocks, counts = {}, {}
    sides = both(3, lambda ns: (ns.SharedMatrix("m", capacity=16),))
    for side in sides:
        clocks[side.ns.port] = [0]
        counts[side.ns.port] = Counted(monkeypatch, side.ns.matrix_mod,
                                       clocks[side.ns.port])
    matrix_script(sides, np.random.default_rng(seed + 500), 80,
                  offline_at=(40,))
    assert counts[True].compacts == counts[False].compacts
    assert counts[True].grows == counts[False].grows
    assert counts[True].grows


def test_shared_matrix_summary_loads_on_both():
    sides = both(2, lambda ns: (ns.SharedMatrix("m"),))
    matrix_script(sides, np.random.default_rng(7), 30)
    for side in sides:
        rt = side.new_rt()
        side.rts.append(rt)
        rt.get_channel("m").load_core(side.ch(0, "m").summarize_core())
    same_matrices(*sides, what="loaded")


def sparse_script(sides, rng, steps):
    ref = sides[0]
    for step in range(steps):
        i = int(rng.integers(0, len(ref.rts)))
        m = ref.ch(i, "s")
        act = int(rng.integers(0, 4))
        n = m.row_count
        if act == 0 or n == 0:
            op = ("insert_rows", int(rng.integers(0, n + 1)),
                  int(rng.integers(1, 4)))
        elif act == 1 and n > 1:
            op = ("remove_rows", int(rng.integers(0, n - 1)), 1)
        else:
            op = ("set_cell", int(rng.integers(0, n)),
                  int(rng.integers(0, 1 << 14)), int(rng.integers(0, 99)))
        for side in sides:
            getattr(side.ch(i, "s"), op[0])(*op[1:])
        if rng.random() < 0.4:
            for side in sides:
                side.rts[i].flush()
        if rng.random() < 0.3:
            k = int(rng.integers(0, len(ref.rts)))
            for side in sides:
                side.rts[k].process_incoming(2)
        for a, b in zip(ref.rts, sides[1].rts):
            ra, pb = a.get_channel("s"), b.get_channel("s")
            assert pb.row_count == ra.row_count
            for x, y in zip(lanes(pb._rows.state, True),
                            lanes(ra._rows.state, False)):
                assert np.array_equal(x, y), f"step {step}"
    for side in sides:
        side.drain()


def test_sparse_matrix_in_lockstep_and_summary():
    """SparseMatrix rows and cells; at quiescence the summaries are equal
    byte for byte, and a replica loaded from the reference's summary
    (replayed as baseline inserts) reads the same cells."""
    sides = both(3, lambda ns: (ns.SparseMatrix("s", capacity=16),))
    sparse_script(sides, np.random.default_rng(3), 60)
    ref, port = sides
    for i in range(3):
        ra, pb = ref.ch(i, "s"), port.ch(i, "s")
        assert summary_bytes(pb) == summary_bytes(ra)
        assert [pb.row_values(r) for r in range(pb.row_count)] == \
            [ra.row_values(r) for r in range(ra.row_count)]
    summary = ref.ch(0, "s").summarize_core()
    loaded = []
    for side in sides:
        rt = side.new_rt()
        rt.get_channel("s").load_core(summary)
        loaded.append(rt.get_channel("s"))
    assert summary_bytes(loaded[1]) == summary_bytes(loaded[0])
    for x, y in zip(lanes(loaded[1]._rows.state, True),
                    lanes(loaded[0]._rows.state, False)):
        assert np.array_equal(x, y)


def test_config2b_and_config4_streams_match_the_bench():
    """The port's copies of the bench's op streams give the same rows, and
    config 4's stream through ``jit_batched_apply_ops`` then
    ``batched_compact`` (three rounds, as the bench runs it) equals XLA."""
    for n_docs, k in ((20, 16), (3, 8)):
        assert np.array_equal(
            build_op_stream(n_docs, k, np.random.default_rng(0)),
            bench.build_op_stream(n_docs, k, np.random.default_rng(0)))
    ops = matrix_axis_stream(40, 16, np.random.default_rng(0))
    assert ops[17].tolist() == ops[1].tolist() and ops[:, :, 0].any()
    ref = RS.make_batched_state(40, 64, NO_CLIENT)
    port = segment_state_from_numpy(ref_arrays(ref), "cpu")
    for _ in range(3):
        ref = RM.jit_batched_apply_ops(ref, jnp.asarray(ops))
        port = M.jit_batched_apply_ops(port, ops)
        same(port, ref, "config 4 apply")
        ref = RM.batched_compact(ref)
        port = M.batched_compact(port)
        same(port, ref, "config 4 compact")
    assert int(np.asarray(port.err).sum()) == 0
